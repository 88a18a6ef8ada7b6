"""Host-side helpers (the port's ``utils``): FLOPs accounting and MFU
(``utils/flops.py``), the kernel build cache (:func:`enable_compile_cache`),
the debug toggles (:func:`nan_checks`, :func:`check_finite`), and the
metric sink and timing harness that ``telemetry`` holds
(:class:`MetricsLogger`, :class:`StepTimer`, :func:`profile_trace`,
:func:`time_fn`)."""

from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger
from bpe_transformer_tpu_torch.telemetry.timing import StepTimer, profile_trace, time_fn
from bpe_transformer_tpu_torch.utils.compile_cache import enable_compile_cache
from bpe_transformer_tpu_torch.utils.debug import check_finite, nan_checks

__all__ = ["MetricsLogger", "StepTimer", "check_finite", "enable_compile_cache", "nan_checks",
           "profile_trace", "time_fn"]
