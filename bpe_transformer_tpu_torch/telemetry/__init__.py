"""Telemetry (the port's counterparts of ``bpe_transformer_tpu/telemetry``):
the record schema, spans and sinks, the alert watchdog, the flight recorder,
run manifests, resource sampling and the decode roofline; the training
taps (``health``, ``dynamics``), the hang and non-finite ``watchdog``,
``timing`` (``StepTimer``, ``profile_trace``, ``time_fn``), and the
torch-free ``report`` and ``trace`` tools.  The record kinds and their
required fields are the JAX package's, so either package's ``report`` and
``monitor`` read the other's streams."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

__all__ = [
    "AlertEngine",
    "FlightRecorder",
    "MetricsLogger",
    "NonFiniteError",
    "RECORD_SCHEMAS",
    "StepTimer",
    "Telemetry",
    "Watchdog",
    "default_serving_rules",
    "dynamics_metrics",
    "dynamics_record",
    "flatten_dynamics",
    "flatten_health",
    "git_sha",
    "health_metrics",
    "nonfinite_fields",
    "profile_trace",
    "run_manifest",
    "sample_resources",
    "time_fn",
    "tree_bytes_per_device",
    "validate_record",
]

# Lazy: ``resources``, ``health``, ``dynamics`` and ``timing`` import torch,
# and the fleet and report tools (``fleet``, ``slo``, ``monitor``,
# ``incident``, ``report``, ``trace``) run on hosts without it.
__getattr__ = lazy_attrs(__name__, {
    "AlertEngine": "alerts",
    "FlightRecorder": "flightrecorder",
    "MetricsLogger": "sinks",
    "NonFiniteError": "watchdog",
    "RECORD_SCHEMAS": "schema",
    "StepTimer": "timing",
    "Telemetry": "spans",
    "Watchdog": "watchdog",
    "default_serving_rules": "alerts",
    "dynamics_metrics": "dynamics",
    "dynamics_record": "dynamics",
    "flatten_dynamics": "dynamics",
    "flatten_health": "health",
    "git_sha": "manifest",
    "health_metrics": "health",
    "nonfinite_fields": "report",
    "profile_trace": "timing",
    "run_manifest": "manifest",
    "sample_resources": "resources",
    "time_fn": "timing",
    "tree_bytes_per_device": "resources",
    "validate_record": "schema",
})
