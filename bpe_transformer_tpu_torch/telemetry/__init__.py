"""Serving telemetry (the port's counterparts of
``bpe_transformer_tpu/telemetry``): the record schema, spans and sinks, the
alert watchdog, the flight recorder, run manifests, resource sampling and the
decode roofline.  The record kinds and their required fields are the JAX
package's, so its ``report`` and ``monitor`` read the port's streams."""

from bpe_transformer_tpu_torch.telemetry.alerts import AlertEngine, default_serving_rules
from bpe_transformer_tpu_torch.telemetry.flightrecorder import FlightRecorder
from bpe_transformer_tpu_torch.telemetry.manifest import git_sha, run_manifest
from bpe_transformer_tpu_torch.telemetry.resources import sample_resources
from bpe_transformer_tpu_torch.telemetry.schema import RECORD_SCHEMAS, validate_record
from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger
from bpe_transformer_tpu_torch.telemetry.spans import Telemetry

__all__ = [
    "AlertEngine",
    "FlightRecorder",
    "MetricsLogger",
    "RECORD_SCHEMAS",
    "Telemetry",
    "default_serving_rules",
    "git_sha",
    "run_manifest",
    "sample_resources",
    "validate_record",
]
