"""Re-export shim (as ``bpe_transformer_tpu/utils/metrics.py``): the metric
sinks live in ``telemetry/sinks.py``."""

from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger

__all__ = ["MetricsLogger"]
