"""Serving telemetry (the port's counterparts of
``bpe_transformer_tpu/telemetry``): the record schema, spans and sinks, the
alert watchdog, the flight recorder, run manifests, resource sampling and the
decode roofline.  The record kinds and their required fields are the JAX
package's, so its ``report`` and ``monitor`` read the port's streams."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

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

# Lazy: ``resources`` imports torch, and the fleet tools (``fleet``,
# ``slo``, ``monitor``, ``incident``) run on hosts without it.
__getattr__ = lazy_attrs(__name__, {
    "AlertEngine": "alerts",
    "FlightRecorder": "flightrecorder",
    "MetricsLogger": "sinks",
    "RECORD_SCHEMAS": "schema",
    "Telemetry": "spans",
    "default_serving_rules": "alerts",
    "git_sha": "manifest",
    "run_manifest": "manifest",
    "sample_resources": "resources",
    "validate_record": "schema",
})
