"""Re-export shim (as ``bpe_transformer_tpu/utils/profiling.py``): the timing
harness lives in ``telemetry/timing.py``."""

from bpe_transformer_tpu_torch.telemetry.timing import StepTimer, profile_trace, time_fn

__all__ = ["StepTimer", "profile_trace", "time_fn"]
