"""Continuous-batching serving on the port: the slot-pool engine
(``engine``), the paged engine with its block pool, radix prefix cache and
KV wire codec (``kvpool``), speculative decoding (``spec``), the FIFO
admission queue and prefill budget (``scheduler``), the in-process
``ServingEngine`` and its HTTP endpoint (``server``), the metrics
(``metrics``), the fleet router (``router``) and the self-healing control
loop (``controller``)."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

__all__ = [
    "DraftModel",
    "DraftSpec",
    "FifoScheduler",
    "LatencyHistogram",
    "NoFreeBlocksError",
    "PagedEngine",
    "SpecEngine",
    "PrefillBudget",
    "QueueFullError",
    "Request",
    "RequestHandle",
    "Result",
    "Router",
    "ServingEngine",
    "ServingMetrics",
    "SlotPoolEngine",
    "TickEvent",
    "default_prefill_buckets",
    "make_http_server",
    "make_router_http_server",
    "render_prometheus",
]

# Lazy: the router, the controller and the KV wire codec import without
# torch; the engines and the server import it.
__getattr__ = lazy_attrs(__name__, {
    "DraftModel": "spec",
    "DraftSpec": "spec",
    "FifoScheduler": "scheduler",
    "LatencyHistogram": "metrics",
    "NoFreeBlocksError": "kvpool",
    "PagedEngine": "kvpool",
    "SpecEngine": "spec",
    "PrefillBudget": "scheduler",
    "QueueFullError": "scheduler",
    "Request": "server",
    "RequestHandle": "server",
    "Result": "server",
    "Router": "router",
    "ServingEngine": "server",
    "ServingMetrics": "metrics",
    "SlotPoolEngine": "engine",
    "TickEvent": "engine",
    "default_prefill_buckets": "engine",
    "make_http_server": "server",
    "make_router_http_server": "router",
    "render_prometheus": "metrics",
})
