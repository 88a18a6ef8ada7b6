"""The documented telemetry record schema — one source of truth.

The port's copy of ``bpe_transformer_tpu/telemetry/schema.py``, kept
identical so that the JAX package's ``report`` and ``monitor`` read the
port's streams; the tools named below check the JAX package's copy.

Every record any module in this package emits into the unified JSONL stream
must be one of the kinds below, carrying at least the required fields.  The
table is duplicated (deliberately, as prose) in ``ARCHITECTURE.md`` and
``README.md`` § Observability; ``tools/check_telemetry_schema.py`` — wired
into tier-1 — greps the package for every emitted ``kind`` and fails when
one is missing from this registry, so a new record kind cannot ship
undocumented.

The Chrome trace exporter (``telemetry/trace.py``) additionally assumes
``span`` records carry ``t``/``dur_s`` on the run-relative seconds axis,
``engine`` records share that ``t`` axis, and ``resources`` records carry
absolute ``time_unix`` — declared as ``TRACE_ASSUMPTIONS`` there and
cross-checked against this registry by the same tool.

Jax-free: the report/monitor tools import this on hosts with no
accelerator runtime.
"""

from __future__ import annotations

#: kind -> set of REQUIRED fields.  Step/val metric records carry no
#: ``kind`` key (the pre-telemetry JSONL schema, preserved); they are
#: registered under the pseudo-kind ``"metric"``.
RECORD_SCHEMAS: dict[str, set[str]] = {
    # Run header: config, mesh, versions, git SHA, host (telemetry/manifest.py).
    "manifest": {"kind", "run_kind", "time_utc", "host"},
    # Closed wall-clock span; ``path`` is the /-joined nesting (spans.py).
    "span": {"kind", "name", "path", "t", "dur_s"},
    # Point-in-time marker: NaN dumps, watchdog trips, worker errors.
    "event": {"kind", "name", "t"},
    # Periodic serving-engine snapshot (serving/server.py).
    "engine": {
        "kind", "t", "active_slots", "queue_depth", "tokens_per_sec",
        "tokens_total", "ticks", "requests_finished", "compiled_programs",
    },
    # Resource accounting sample (telemetry/resources.py): HBM fields are
    # None on backends without memory_stats (CPU), never absent.  Training
    # records additionally carry optional ``params_bytes`` /
    # ``opt_state_bytes`` (PER-CHIP state bytes from shard-shape metadata —
    # the ZeRO-1 optimizer-sharding memory win reads directly off them) and
    # ``compile_time_s``; all three are optional — older streams predate
    # them.
    "resources": {
        "kind", "time_unix", "host_rss_bytes", "live_buffer_bytes",
        "compile_events", "hbm_bytes_in_use", "hbm_peak_bytes_in_use",
        "hbm_bytes_limit",
    },
    # Training-dynamics introspection sample (telemetry/dynamics.py),
    # emitted every --dynamics-every steps at the log-cadence fetch.  The
    # payload is flat per-layer keys — grad_norm/param_norm/update_ratio
    # per layer label (``layers.N``, ``token_embeddings``, ...), activation
    # act_rms/act_absmax/attn_entropy per block, nonzero non-finite counts
    # per tensor path (``nonfinite_params/layers.3.ffn.w1``) and a
    # ``first_nonfinite`` localization path — all optional (a grad-accum
    # step has no activation taps; a clean step has no non-finite keys).
    "dynamics": {"kind", "step"},
    # Graceful-preemption marker (resilience/signals + training/loop.py):
    # SIGTERM/SIGINT was caught, the loop stopped at a step boundary, and
    # (when a checkpoint dir is configured) an emergency snapshot was
    # written — ``checkpoint`` carries its path, null when none could be.
    "preemption": {"kind", "t", "step", "signal"},
    # NaN-rollback recovery record (training/loop.py under
    # on_nonfinite="rollback"): the run reloaded ``restored_step``'s
    # checkpoint after a non-finite state at ``step`` and is retrying with
    # the offending data window skipped.  ``rollbacks`` is the running
    # count; optional ``lost_steps`` and the ``nonfinite_path``
    # localization ride along.
    "recovery": {"kind", "t", "step", "restored_step", "rollbacks"},
    # Performance-attribution sample (telemetry/attribution.py), emitted
    # every --attribution-every steps (and by ``bpe-tpu profile``): the
    # measured compute / collective / host-gap split of wall step time
    # (fractions sum to ~1.0; ``collective_frac`` is null where the
    # collective is not separable — GSPMD strategies), plus, on the first
    # record of a run, the static XLA cost-model roofline rows under an
    # optional ``programs`` list (name, flops, bytes_accessed,
    # arithmetic_intensity, ridge_flops_per_byte, bound verdict).
    # Records additionally carry the compiled step's peak-HBM envelope and
    # the execution-knob labels that produced it (all optional — older
    # streams predate them): ``train_peak_hbm_bytes`` /
    # ``train_temp_hbm_bytes`` (XLA memory_analysis: temp + args + outputs
    # − aliased of the non-donating probe program; null on backends
    # without the counters) and ``remat_policy`` / ``grads_dtype`` /
    # ``scan_layers`` — so a peak or MFU move is attributable to the knob
    # that caused it.  ``train_peak_hbm_bytes`` feeds the report compare
    # gate (lower), as does the derived ``mfu_compute_ceiling``.  The
    # port's records may add ``phases`` (optional): the probe trace's
    # ``{phase: {host_ms, device_ms, launches}}`` by the step's ``bpt.*``
    # ranges (``telemetry/attribution.py`` ``phase_table``).
    "attribution": {
        "kind", "t", "step", "wall_step_s", "device_step_s",
        "compute_frac", "collective_frac", "host_gap_frac",
    },
    # Paged-KV pool snapshot (serving/server.py, paged engines only),
    # emitted on the engine-record cadence: block occupancy
    # (``blocks_{total,free,shared}``), radix prefix-cache effectiveness
    # (cumulative token ``prefix_{hits,misses}`` and the derived
    # ``prefix_hit_rate``, null before any lookup), the chunked-prefill
    # backlog (optional ``prefill_pending_tokens``), and the KV-memory
    # economics (optional ``kv_pool_bytes`` — resident pool bytes, scale
    # pools included — and ``kv_bytes_per_token`` — the per-position KV
    # footprint at pool width, the attention read stream's unit, which
    # int8 quantization halves/quarters; both feed the
    # report --baseline regression gate; older streams predate them).
    "kvpool": {
        "kind", "t", "blocks_total", "blocks_free", "blocks_shared",
        "prefix_hits", "prefix_misses",
    },
    # Speculative-decoding snapshot (serving/server.py, SpecEngine only),
    # emitted on the engine-record cadence: the fixed window ``k``, the
    # cumulative draft tokens judged (``proposed``) and kept
    # (``accepted``), decode tokens emitted by spec ticks (``emitted``)
    # over ``target_steps`` verify passes, plus the derived
    # ``accept_rate`` (accepted/proposed, null before any tick),
    # ``tokens_per_target_step`` (the "ticks saved" number — 1.0 is
    # non-speculative decode, k+1 the ceiling), ``rewound`` stale KV
    # positions rolled back, and the draft's share of tick wall time
    # (optional ``draft_frac``).  ``accept_rate`` and
    # ``tokens_per_target_step`` feed the report compare gate.
    "spec": {
        "kind", "t", "k", "proposed", "accepted", "emitted", "target_steps",
    },
    # Decode-tick roofline sample (serving/server.py, every engine kind),
    # emitted on the engine-record cadence: the analytic HBM byte split of
    # ONE decode tick at current occupancy — ``weight_bytes`` (the matmul
    # weight sweep int8 weight quantization halves vs bf16), ``kv_bytes``
    # (the live attention stream int8 KV blocks halve), optional
    # ``act_bytes`` (transient estimate; fused sampling shrinks the
    # vocab-sized tail to one gumbel round trip) — plus the tick ``flops``
    # (utils/flops.decode_tick_flops) and the derived
    # ``arithmetic_intensity`` / ``ridge_flops_per_byte`` / ``bound``
    # verdict / ``projected_tick_s`` memory-bound floor (null off-TPU),
    # ``weight_frac``, occupancy (``active_slots``) and the
    # ``weight_dtype`` / ``fused_sampling`` knobs that produced it.
    # ``weight_bytes`` feeds the report compare gate (serve_weight_bytes).
    "roofline": {
        "kind", "t", "weight_bytes", "kv_bytes", "flops",
    },
    # KV-slot migration (serving/server.py): one record per KV
    # move in the disaggregated fleet.  ``direction`` is ``export`` (a
    # prefill-role replica streamed a finished prefix out), ``import`` (a
    # decode replica grafted a payload), or ``evacuate`` (a draining
    # replica exported an in-flight session to a peer).  ``bytes`` is the
    # serialized payload size, ``blocks`` the KV blocks moved.  Import
    # records additionally carry the phase split — optional ``export_s``
    # (from the source's meta), ``transfer_s`` (export -> graft wall,
    # wall-clock-derived), ``import_s`` (the graft itself), and their
    # ``total_s`` (the compare gate's migration_p99_s evidence) — plus
    # ``request_id`` so migration hops join the cross-stream request
    # timeline next to the serve/migration_* spans.
    "migration": {"kind", "t", "direction", "bytes", "blocks"},
    # Fleet sweep (telemetry/fleet.py, `bpe-tpu fleet`): one concurrent
    # poll of every replica's /statusz+/metrics (plus the router's
    # counters) merged into fleet-level gauges — online/draining counts,
    # summed queue depth / active slots / token rate, worst-replica
    # ``kv_headroom_frac``, fleet spec ``accept_rate``, cumulative
    # availability counters (``requests_ok``/``requests_failed``, router
    # present only), merged cumulative latency histograms
    # (``hist_total``/``hist_ttfb`` as ``[le, count]`` pairs, le null =
    # +Inf) with the derived ``request_p99_s``/``ttfb_p99_s``, and a
    # ``per_replica`` snapshot table.  All but the required fields are
    # optional/nullable — a dense fleet has no kv gauges, a routerless
    # sweep no availability.
    "fleet": {"kind", "t", "replicas_total", "replicas_online"},
    # SLO evaluation (telemetry/slo.py) over a rolling window of the
    # fleet stream: the objective's ``target`` good-fraction, the
    # window's ``good``/``total`` event deltas and derived ``sli``, and
    # the error-budget ``burn_rate`` = (1-sli)/(1-target) — null when the
    # window saw no traffic.  Latency objectives carry ``threshold_s``.
    # ``burn_rate`` feeds the report compare gate (slo_max_burn_rate).
    "slo": {"kind", "t", "objective", "window_s", "burn_rate"},
    # Serving anomaly watchdog transition (telemetry/alerts.py):
    # edge-triggered — one ``state="firing"`` record when a rule starts
    # firing (with its evidence fields and human ``message``), one
    # ``state="cleared"`` (with ``active_s``) when it stops; persisting
    # conditions emit nothing.  Rules: queue_growth, block_exhaustion
    # (with ``projected_dry_s``), accept_rate_collapse, compile_storm,
    # replica_flap.  ``severity`` is ``page`` | ``warn``.
    "alert": {"kind", "t", "rule", "state"},
    # Fleet control-plane decision (serving/controller.py, `bpe-tpu
    # control`): one record per controller action or hold.
    # ``action`` is ``rebalance`` (victim sessions moved via
    # /kv/export -> /kv/import), ``retune`` (router --prefill-threshold
    # adjusted to the live prompt mix), ``scale_up``/``scale_down``
    # (replica spawned/retired through the supervisor machinery), or
    # ``hold`` (the loop degraded to observe-only).  ``outcome`` is
    # ``ok`` | ``failed`` (after bounded retries) | ``observe_only``
    # (decided but not executed: --observe-only, or the named hold
    # reason) | ``held``.  ``breaker`` is the action-budget crash-loop
    # breaker state (``closed`` | ``tripped`` — a tripped controller
    # stops acting until restarted).  ``reason`` says why the decision
    # fired or why the loop is holding (``stale_evidence``,
    # ``partial_sweep``, ``fleet_unreachable``, ``breaker_tripped``);
    # ``target``/``params``/``attempts``/``dur_s`` ride along per action.
    "control": {"kind", "t", "action", "outcome", "breaker"},
    # Flight-recorder black-box dump (telemetry/flightrecorder.py): the
    # always-on decision ring of one ``component`` ("serve" | "route" |
    # "train" | "control"), flushed on a ``trigger`` — ``alert:<rule>``, ``watchdog_hang``,
    # ``nonfinite``, ``preemption``, ``manual`` (POST /debug/dump), or
    # ``sweep`` (the incident tool snapshotting a live ring).  ``events`` is
    # the ring contents oldest-first (each entry: ``event`` name, run-relative
    # ``t``, absolute ``time_unix``, plus the decision's own fields);
    # ``recorded``/``dropped`` are lifetime counters (dropped > 0 means the
    # ring wrapped).  Host-side context rides along per component: queue
    # depth, slot states, kvpool gauges, active alerts + history tail for
    # serving; step/rollback state for training.
    "blackbox": {
        "kind", "t", "time_unix", "component", "trigger", "events",
    },
    # Incident postmortem bundle summary (telemetry/incident.py, `bpe-tpu
    # incident`): one record per assembled bundle.  ``hosts`` is the per-host
    # sweep outcome table (url, online, dumps collected); ``timeline`` is the
    # merged cross-host event list, wall-clock-ordered by absolute
    # ``time_unix`` (each entry stamped with its source ``host``), optionally
    # filtered to one request id and capped (``timeline_truncated`` rides
    # along when capped).
    "incident": {"kind", "time_unix", "hosts", "timeline"},
    # Run trailer: record counts + clean verdict (spans.py Telemetry.footer).
    "footer": {"kind", "t", "record_counts"},
    # Step/val metrics (NO kind key): at least a step number plus one
    # metric value (loss or val_loss in practice).
    "metric": {"step"},
}


def layer_sort_key(label: str):
    """Natural ordering for the per-layer labels of ``dynamics`` records:
    ``layers.2`` before ``layers.10``, block layers before the top-level
    tensors (``lm_head``, ``ln_final``, ``token_embeddings``).  Shared by
    the report and monitor renderers so their tables always agree."""
    parts = label.split(".")
    if parts[0] == "layers" and len(parts) > 1 and parts[1].isdigit():
        return (0, int(parts[1]), label)
    return (1, 0, label)


def record_kind(record: dict) -> str:
    """The schema kind of a record: its ``kind`` field, or ``"metric"``
    for the kind-less step/val records."""
    return record.get("kind", "metric")


def validate_record(record: dict) -> list[str]:
    """Problems with one record against the documented schema (empty list =
    valid): unknown kind, or a required field missing.  Fields may be null
    (e.g. HBM stats on CPU) — required means *present*, not non-null."""
    kind = record_kind(record)
    schema = RECORD_SCHEMAS.get(kind)
    if schema is None:
        return [f"undocumented record kind {kind!r}"]
    missing = sorted(schema - record.keys())
    if missing:
        return [f"kind {kind!r} missing required fields: {', '.join(missing)}"]
    return []
