"""Host-side helpers (the port's ``utils``): FLOPs accounting
(``utils/flops.py``), the kernel build cache (:func:`enable_compile_cache`)
and the debug toggles (:func:`nan_checks`, :func:`check_finite`)."""

from bpe_transformer_tpu_torch.utils.compile_cache import enable_compile_cache
from bpe_transformer_tpu_torch.utils.debug import check_finite, nan_checks

__all__ = ["check_finite", "enable_compile_cache", "nan_checks"]
