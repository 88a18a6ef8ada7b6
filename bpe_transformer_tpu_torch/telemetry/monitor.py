"""``monitor`` (the port's torch-free copy of
``bpe_transformer_tpu/telemetry/monitor.py``): a live operational view of a
running (or finished) run — loss/throughput, queue/slot state, HBM headroom, compile counts.

Two sources, one panel:

- **a telemetry stream** (``monitor run/metrics.jsonl``): tail the
  unified JSONL the training loop / serving engine writes, folding every
  record kind (metric | span | event | engine | resources | dynamics |
  attribution | manifest | footer) into the latest operational state — a
  dynamics-enabled training run gets a live per-layer grad-norm/
  update-ratio table, an attribution-enabled one a live compute/
  collective/host-gap split;
- **a live server** (``monitor --url host:port``): poll
  ``GET /metrics`` on a ``serve`` process and parse the Prometheus
  exposition back into the same state;
- **a fleet aggregator** (``monitor --fleet host:port``): poll a
  ``fleet`` process's ``/statusz`` and render the fleet line —
  replicas online/draining, fleet tok/s, worst-replica KV headroom,
  firing alerts, worst SLO burn (the ``fleet``/``slo``/``alert`` record
  kinds fold from a JSONL stream too).

Pure host-side and torch-free (like `report`): it runs on a laptop watching a
stream rsynced off a pod, or next to the serving process itself.  Renders
with curses on a tty (q quits), plain refreshing frames otherwise;
``--once`` prints a single frame and exits (scripts, smoke tests).
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

#: Event names worth flagging on the panel (matches report's anomaly list).
_ANOMALY_EVENTS = (
    "nonfinite", "watchdog_hang", "serve_worker_error", "recovery_abort",
)


# ----------------------------------------------------------- state folding


def fold_records(records: list[dict], state: dict | None = None) -> dict:
    """Fold telemetry records (oldest-first) into the latest operational
    state; pass the previous ``state`` back in to fold incrementally while
    tailing."""
    state = dict(state) if state else {"anomalies": 0, "n_records": 0}
    for record in records:
        if not isinstance(record, dict):
            continue
        state["n_records"] += 1
        kind = record.get("kind", "metric")
        if kind == "manifest":
            devices = record.get("devices") or {}
            state["run_kind"] = record.get("run_kind")
            state["devices"] = (
                f"{devices.get('count', '?')}x{devices.get('kind', '?')}"
                if devices
                else None
            )
        elif kind == "metric":
            for key in ("step", "loss", "val_loss", "tokens_per_sec",
                        "mfu", "grad_norm", "step_wall_s"):
                if key in record:
                    state[key] = record[key]
            loss = record.get("loss")
            if isinstance(loss, float) and not math.isfinite(loss):
                state["anomalies"] += 1
        elif kind == "engine":
            for key in ("active_slots", "queue_depth", "tokens_total",
                        "requests_finished", "compiled_programs"):
                if key in record:
                    state[key] = record[key]
            state["serve_tokens_per_sec"] = record.get("tokens_per_sec")
        elif kind == "kvpool":
            # Paged-KV pool snapshot (serving/kvpool/): block occupancy +
            # prefix-cache effectiveness, the serve panel's memory view.
            for key in ("blocks_total", "blocks_free", "blocks_shared",
                        "prefix_hits", "prefix_misses", "prefix_hit_rate",
                        "prefill_pending_tokens"):
                if key in record:
                    state[f"kv_{key}"] = record[key]
            for key in ("kv_pool_bytes", "kv_bytes_per_token"):
                if record.get(key) is not None:
                    state[key] = record[key]
        elif kind == "migration":
            # KV-slot migration: count moves/bytes per
            # direction — the kv panel's disaggregated-transport view.
            direction = record.get("direction")
            key = "kv_migrations_in" if direction == "import" else (
                "kv_migrations_out"
            )
            state[key] = state.get(key, 0) + 1
            state["kv_migration_bytes"] = (
                state.get("kv_migration_bytes", 0)
                + (record.get("bytes") or 0)
            )
            if record.get("total_s") is not None:
                state["kv_migration_last_s"] = record["total_s"]
        elif kind == "spec":
            # Speculative-decoding snapshot (serving/spec/): acceptance
            # rate + emitted-per-verify-pass, the serve panel's spec view.
            for key in ("k", "accept_rate", "tokens_per_target_step",
                        "rewound", "draft_frac", "proposed", "accepted"):
                if key in record:
                    state[f"spec_{key}"] = record[key]
        elif kind == "fleet":
            # Fleet sweep (telemetry/fleet.py): the whole fleet's state in
            # one line — online counts, summed rates, worst-replica KV
            # headroom, merged p99s, availability.
            for key in ("replicas_total", "replicas_online",
                        "replicas_draining", "queue_depth", "active_slots",
                        "slots", "tokens_per_sec", "kv_headroom_frac",
                        "request_p99_s", "ttfb_p99_s", "availability",
                        "accept_rate"):
                if key in record:
                    state[f"fleet_{key}"] = record[key]
        elif kind == "slo":
            # SLO burn rates (telemetry/slo.py), latest per (objective,
            # window); the panel shows the worst.
            burns = dict(state.get("slo_burns") or {})
            label = (
                f"{record.get('objective')}/{record.get('window_s'):g}s"
                if isinstance(record.get("window_s"), (int, float))
                else str(record.get("objective"))
            )
            if record.get("burn_rate") is not None:
                burns[label] = record["burn_rate"]
            state["slo_burns"] = burns
            finite = [v for v in burns.values() if isinstance(v, (int, float))]
            if finite:
                state["slo_max_burn"] = max(finite)
        elif kind == "control":
            # Controller decisions (serving/controller.py):
            # count actions by outcome, keep the breaker state and the
            # last action on the panel.  A failed action or a tripped
            # breaker is an anomaly — the self-healing loop faltered.
            outcome = record.get("outcome")
            state["control_actions"] = int(
                state.get("control_actions") or 0) + 1
            if outcome == "failed":
                state["control_failed"] = int(
                    state.get("control_failed") or 0) + 1
                state["anomalies"] += 1
                state["last_anomaly"] = (
                    f"control {record.get('action')} failed"
                )
            state["control_breaker"] = record.get("breaker")
            if record.get("breaker") == "tripped":
                state["last_anomaly"] = "control breaker tripped"
            state["control_last"] = (
                f"{record.get('action')}/{outcome}"
                + (
                    f" ({str(record.get('reason')).split(':')[0]})"
                    if record.get("action") == "hold" and record.get("reason")
                    else ""
                )
            )
        elif kind == "alert":
            # Watchdog transitions (telemetry/alerts.py): track the
            # currently-firing set; every new firing is an anomaly.  The
            # bounded history mirrors AlertEngine.history(): the panel
            # shows the last few firing->cleared transitions, not just
            # what is firing right now.
            firing = list(state.get("alerts_firing") or [])
            rule = record.get("rule")
            if record.get("state") == "firing":
                if rule not in firing:
                    firing.append(rule)
                state["anomalies"] += 1
                state["last_anomaly"] = f"alert {rule}"
            elif record.get("state") == "cleared" and rule in firing:
                firing.remove(rule)
            state["alerts_firing"] = firing
            history = list(state.get("alert_history") or [])
            history.append(
                {
                    "t": record.get("t"),
                    "rule": rule,
                    "state": record.get("state"),
                    "active_s": record.get("active_s"),
                }
            )
            state["alert_history"] = history[-8:]
        elif kind == "blackbox":
            # Flight-recorder dump (telemetry/flightrecorder.py): count
            # it and show who flushed and why — a dump in the stream is
            # the panel's cue that forensic evidence exists.
            state["blackbox_dumps"] = state.get("blackbox_dumps", 0) + 1
            trigger = record.get("trigger")
            state["last_blackbox"] = (
                f"{record.get('component', '?')}:{trigger}"
            )
            if trigger != "sweep" and trigger != "manual":
                state["anomalies"] += 1
                state["last_anomaly"] = f"blackbox {trigger}"
        elif kind == "resources":
            for key in ("host_rss_bytes", "live_buffer_bytes",
                        "hbm_bytes_in_use", "hbm_peak_bytes_in_use",
                        "hbm_bytes_limit", "compile_events",
                        "compile_time_s", "params_bytes", "opt_state_bytes"):
                if record.get(key) is not None:
                    state[key] = record[key]
        elif kind == "attribution":
            # Latest performance-attribution split (telemetry/attribution):
            # fractions + the top compiled program's roofline verdict, so a
            # live operator sees WHERE step time goes, not just how much.
            for key in ("compute_frac", "collective_frac", "host_gap_frac",
                        "train_peak_hbm_bytes", "remat_policy",
                        "grads_dtype", "scan_layers"):
                if record.get(key) is not None:
                    state[key] = record[key]
            state["attribution_step"] = record.get("step")
            programs = record.get("programs")
            if isinstance(programs, list) and programs:
                top = programs[0]
                if isinstance(top, dict) and top.get("bound"):
                    state["bound_verdict"] = (
                        f"{top.get('name', '?')} {top['bound']}"
                    )
        elif kind == "dynamics":
            # Latest per-layer introspection sample (telemetry/dynamics.py):
            # keep the whole flat record, merged so a partial sample (e.g.
            # grad-accum paths carry no activation stats) never erases the
            # keys a previous full sample established.
            dyn = dict(state.get("dynamics") or {})
            dyn.update(
                {
                    k: v
                    for k, v in record.items()
                    if k.startswith(("grad_norm/", "param_norm/",
                                     "update_ratio/", "act_rms/",
                                     "act_absmax/", "attn_entropy/"))
                }
            )
            state["dynamics"] = dyn
            state["dynamics_step"] = record.get("step")
            if record.get("first_nonfinite"):
                state["anomalies"] += 1
                state["last_anomaly"] = (
                    f"nonfinite {record['first_nonfinite']}"
                )
        elif kind == "recovery":
            # NaN-rollback recovery (training/loop.py): count it and show
            # the restore so an operator watching live sees the run heal.
            state["rollbacks"] = state.get("rollbacks", 0) + 1
            state["anomalies"] += 1
            state["last_anomaly"] = (
                f"rollback -> step {record.get('restored_step')}"
                + (
                    f" ({record['nonfinite_path']})"
                    if record.get("nonfinite_path")
                    else ""
                )
            )
        elif kind == "preemption":
            state["preempted"] = record.get("signal")
            state["last_anomaly"] = (
                f"preempted ({record.get('signal')})"
                + (
                    ""
                    if record.get("checkpoint")
                    else " WITHOUT checkpoint"
                )
            )
        elif kind == "event":
            if record.get("name") in _ANOMALY_EVENTS:
                state["anomalies"] += 1
                state["last_anomaly"] = record.get("name")
        elif kind == "footer":
            state["footer_clean"] = record.get("clean")
    return state


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition -> ``{name: value}`` /
    ``{name{labels}: value}`` for every sample line."""
    samples: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name, value = line.rsplit(None, 1)
            samples[name] = float(value)
        except ValueError:
            continue
    return samples


def fold_prometheus(samples: dict, prefix: str = "bpe_tpu") -> dict:
    """Map a ``/metrics`` scrape onto the same state dict the JSONL fold
    produces, so one renderer serves both sources."""
    def get(name):
        return samples.get(f"{prefix}_{name}")

    finished = sum(
        value
        for name, value in samples.items()
        if name.startswith(f"{prefix}_requests_finished_total")
    )
    # Per-bucket prefill throughput gauges: parse the bucket label back
    # out of e.g. `bpe_tpu_prefill_tokens_per_sec{bucket="16"}`.
    prefill_tps = {}
    for name, value in samples.items():
        head = f'{prefix}_prefill_tokens_per_sec{{bucket="'
        if name.startswith(head) and name.endswith('"}'):
            prefill_tps[name[len(head):-2]] = value
    state = {
        "run_kind": "serve",
        "n_records": len(samples),
        "anomalies": int(
            samples.get(f'{prefix}_requests_finished_total{{reason="error"}}', 0)
        ),
        "uptime_s": get("uptime_seconds"),
        "queue_depth": get("queue_depth"),
        "active_slots": get("active_slots"),
        "slots": get("slots"),
        "requests_finished": finished,
        "requests_rejected": get("requests_rejected_total"),
        "tokens_total": get("tokens_generated_total"),
        "compiled_programs": get("engine_compiled_programs"),
        "compile_events": get("compile_events_total"),
        "compile_time_s": get("compile_time_seconds_total"),
        "decode_tokens_per_sec": get("decode_tokens_per_sec"),
        "prefill_tps_by_bucket": prefill_tps or None,
        # Paged-KV pool gauges (absent on dense replicas).
        "kv_blocks_total": get("kv_blocks_total"),
        "kv_blocks_free": get("kv_blocks_free"),
        "kv_pool_bytes": get("kv_pool_bytes"),
        "kv_bytes_per_token": get("kv_bytes_per_token"),
        "kv_blocks_shared": get("kv_blocks_shared"),
        "kv_prefix_hits": get("prefix_cache_hits_total"),
        "kv_prefix_misses": get("prefix_cache_misses_total"),
        "kv_prefill_pending_tokens": get("prefill_pending_tokens"),
        # KV-migration counters (absent on pre-role replicas).
        "kv_migrations_out": get("migrations_out_total"),
        "kv_migrations_in": get("migrations_in_total"),
        # Speculative-decoding gauges (absent on non-spec replicas).
        "spec_k": get("spec_k"),
        "spec_accept_rate": get("spec_accept_rate"),
        "spec_tokens_per_target_step": get("spec_tokens_per_target_step"),
        "spec_rewound": get("spec_rewound_tokens_total"),
        "spec_draft_frac": get("spec_draft_frac"),
        "host_rss_bytes": get("host_rss_bytes"),
        "live_buffer_bytes": get("live_buffer_bytes"),
        "hbm_bytes_in_use": get("hbm_bytes_in_use"),
        "hbm_peak_bytes_in_use": get("hbm_peak_bytes_in_use"),
        "hbm_bytes_limit": get("hbm_bytes_limit"),
    }
    return {k: v for k, v in state.items() if v is not None}


# ---------------------------------------------------------------- rendering


def _dyn_labels(dyn: dict) -> list[str]:
    """Per-layer labels present in a folded dynamics sample, in the same
    natural order as the report's Dynamics table (schema.layer_sort_key)."""
    from bpe_transformer_tpu_torch.telemetry.schema import layer_sort_key

    labels = {key.split("/", 1)[1] for key in dyn if "/" in key}
    return sorted(labels, key=layer_sort_key)


def _mib(n) -> str:
    if not isinstance(n, (int, float)):
        return "-"
    return f"{n / 2**20:,.1f} MiB"


def _num(n, digits=4) -> str:
    if n is None:
        return "-"
    if isinstance(n, float):
        return f"{n:,.{digits}g}"
    return str(n)


def render_frame(state: dict, source: str) -> str:
    """One monitor frame: a few dense lines, every one optional on absence
    of its data (a training stream has no queue; a CPU run has no HBM)."""
    lines = [
        f"bpe-tpu monitor — {state.get('run_kind', '?')}"
        + (f" on {state['devices']}" if state.get("devices") else "")
        + f"  [{source}]"
    ]
    if state.get("uptime_s") is not None:
        lines[0] += f"  uptime {state['uptime_s']:,.0f}s"

    if "step" in state or "loss" in state:
        parts = [f"step {_num(state.get('step'))}",
                 f"loss {_num(state.get('loss'))}"]
        if state.get("val_loss") is not None:
            parts.append(f"val {_num(state['val_loss'])}")
        if state.get("grad_norm") is not None:
            parts.append(f"gnorm {_num(state['grad_norm'])}")
        if state.get("tokens_per_sec") is not None:
            parts.append(f"tok/s {_num(state['tokens_per_sec'], 6)}")
        if state.get("mfu") is not None:
            parts.append(f"mfu {_num(state['mfu'], 3)}")
        lines.append("  train  " + "  ".join(parts))

    if state.get("queue_depth") is not None or state.get("active_slots") is not None:
        parts = []
        if state.get("active_slots") is not None:
            slots = state.get("slots")
            parts.append(
                f"slots {_num(state['active_slots'])}"
                + (f"/{_num(slots)}" if slots is not None else "")
            )
        if state.get("queue_depth") is not None:
            parts.append(f"queue {_num(state['queue_depth'])}")
        if state.get("requests_finished") is not None:
            parts.append(f"requests {_num(state['requests_finished'])}")
        if state.get("requests_rejected"):
            parts.append(f"rejected {_num(state['requests_rejected'])}")
        if state.get("serve_tokens_per_sec") is not None:
            parts.append(f"tok/s {_num(state['serve_tokens_per_sec'], 6)}")
        if state.get("decode_tokens_per_sec") is not None:
            parts.append(
                f"decode tok/s {_num(state['decode_tokens_per_sec'], 6)}"
            )
        if state.get("tokens_total") is not None:
            parts.append(f"tokens {_num(state['tokens_total'])}")
        lines.append("  serve  " + "  ".join(parts))
        if state.get("prefill_tps_by_bucket"):
            lines.append(
                "  bkt    prefill tok/s  "
                + "  ".join(
                    f"{bucket}={_num(tps, 5)}"
                    for bucket, tps in sorted(
                        state["prefill_tps_by_bucket"].items(),
                        key=lambda kv: int(kv[0]) if str(kv[0]).isdigit()
                        else 0,
                    )
                )
            )

    if state.get("kv_blocks_total") is not None or state.get(
        "kv_migrations_out"
    ) or state.get("kv_migrations_in"):
        parts = []
        if state.get("kv_blocks_total") is not None:
            free = state.get("kv_blocks_free")
            total = state["kv_blocks_total"]
            parts.append(f"blocks {_num(free)}/{_num(total)} free")
        if state.get("kv_blocks_shared"):
            parts.append(f"shared {_num(state['kv_blocks_shared'])}")
        hits, misses = (
            state.get("kv_prefix_hits"), state.get("kv_prefix_misses")
        )
        rate = state.get("kv_prefix_hit_rate")
        if rate is None and hits is not None and misses is not None \
                and hits + misses > 0:
            rate = hits / (hits + misses)
        if rate is not None:
            parts.append(f"prefix hit {rate:.0%}")
        if state.get("kv_prefill_pending_tokens"):
            parts.append(
                f"prefill backlog {_num(state['kv_prefill_pending_tokens'])}"
            )
        if state.get("kv_pool_bytes"):
            parts.append(f"pool {state['kv_pool_bytes'] / 2**20:.1f}M")
        if state.get("kv_bytes_per_token"):
            parts.append(f"{_num(state['kv_bytes_per_token'])}B/tok")
        if state.get("kv_migrations_out") or state.get("kv_migrations_in"):
            parts.append(
                f"mig {_num(state.get('kv_migrations_out', 0))}out/"
                f"{_num(state.get('kv_migrations_in', 0))}in"
                + (
                    f" {state['kv_migration_bytes'] / 2**20:.1f}M"
                    if state.get("kv_migration_bytes")
                    else ""
                )
            )
        lines.append("  kv     " + "  ".join(parts))

    if state.get("spec_k") is not None:
        parts = [f"k {_num(state['spec_k'])}"]
        if state.get("spec_accept_rate") is not None:
            parts.append(f"accept {state['spec_accept_rate']:.0%}")
        if state.get("spec_tokens_per_target_step") is not None:
            parts.append(
                f"tok/target step "
                f"{_num(state['spec_tokens_per_target_step'], 3)}"
            )
        if state.get("spec_draft_frac") is not None:
            parts.append(f"draft {state['spec_draft_frac']:.0%}")
        if state.get("spec_rewound"):
            parts.append(f"rewound {_num(state['spec_rewound'])}")
        lines.append("  spec   " + "  ".join(parts))

    if state.get("fleet_replicas_total") is not None:
        parts = [
            f"replicas {_num(state.get('fleet_replicas_online'))}"
            f"/{_num(state['fleet_replicas_total'])}"
        ]
        if state.get("fleet_replicas_draining"):
            parts.append(f"{_num(state['fleet_replicas_draining'])} draining")
        if state.get("fleet_tokens_per_sec") is not None:
            parts.append(f"tok/s {_num(state['fleet_tokens_per_sec'], 6)}")
        if state.get("fleet_queue_depth") is not None:
            parts.append(f"queue {_num(state['fleet_queue_depth'])}")
        if state.get("fleet_kv_headroom_frac") is not None:
            parts.append(
                f"kv headroom {state['fleet_kv_headroom_frac']:.0%}"
            )
        if state.get("fleet_request_p99_s") is not None:
            parts.append(f"p99 {_num(state['fleet_request_p99_s'])}s")
        if state.get("fleet_availability") is not None:
            parts.append(f"avail {state['fleet_availability']:.3%}")
        if state.get("slo_max_burn") is not None:
            parts.append(f"burn {_num(state['slo_max_burn'], 3)}")
        lines.append("  fleet  " + "  ".join(parts))

    if state.get("control_actions"):
        parts = [
            f"{_num(state['control_actions'])} action(s)",
            f"{_num(state.get('control_failed') or 0)} failed",
        ]
        if state.get("control_last"):
            parts.append(f"last {state['control_last']}")
        if state.get("control_breaker"):
            parts.append(f"breaker {state['control_breaker']}")
        lines.append("  ctrl   " + "  ".join(parts))

    if state.get("alerts_firing"):
        lines.append(
            "  alert  FIRING: " + ", ".join(state["alerts_firing"])
        )
    if state.get("alert_history"):
        # Last few firing->cleared transitions (AlertEngine.history): the
        # flap that cleared before the operator looked is still visible.
        lines.append(
            "  alert  history: "
            + "  ".join(
                f"t={_num(row.get('t'), 5)} {row.get('rule')} "
                f"{row.get('state')}"
                + (
                    f" ({_num(row.get('active_s'), 3)}s)"
                    if row.get("active_s") is not None
                    else ""
                )
                for row in state["alert_history"][-4:]
            )
        )
    if state.get("blackbox_dumps"):
        lines.append(
            f"  fdr    blackbox dumps {_num(state['blackbox_dumps'])}"
            + (
                f"  last {state['last_blackbox']}"
                if state.get("last_blackbox")
                else ""
            )
        )

    mem_parts = []
    if state.get("hbm_bytes_in_use") is not None:
        hbm = f"hbm {_mib(state['hbm_bytes_in_use'])}"
        limit = state.get("hbm_bytes_limit")
        if limit:
            hbm += f" / {_mib(limit)} ({100 * state['hbm_bytes_in_use'] / limit:.0f}%)"
        if state.get("hbm_peak_bytes_in_use") is not None:
            hbm += f"  peak {_mib(state['hbm_peak_bytes_in_use'])}"
        mem_parts.append(hbm)
    if state.get("live_buffer_bytes") is not None:
        mem_parts.append(f"live buffers {_mib(state['live_buffer_bytes'])}")
    if state.get("opt_state_bytes") is not None:
        # Per-chip state bytes: the live view of the optimizer-sharding win.
        mem_parts.append(f"opt state/chip {_mib(state['opt_state_bytes'])}")
    if state.get("params_bytes") is not None:
        mem_parts.append(f"params/chip {_mib(state['params_bytes'])}")
    if state.get("host_rss_bytes") is not None:
        mem_parts.append(f"rss {_mib(state['host_rss_bytes'])}")
    if mem_parts:
        lines.append("  mem    " + "  ".join(mem_parts))

    if state.get("compute_frac") is not None:
        parts = [f"compute {state['compute_frac']:.0%}"]
        if state.get("collective_frac") is not None:
            parts.append(f"collective {state['collective_frac']:.0%}")
        if state.get("host_gap_frac") is not None:
            parts.append(f"host gap {state['host_gap_frac']:.0%}")
        if state.get("attribution_step") is not None:
            parts.append(f"(step {_num(state['attribution_step'])})")
        if state.get("bound_verdict"):
            parts.append(f"[{state['bound_verdict']}]")
        lines.append("  attr   " + "  ".join(parts))
        # Training-step memory + execution knobs: the compiled
        # update's peak-HBM envelope and the remat/precision/scan labels
        # that produced it, when the stream carries them.
        if state.get("train_peak_hbm_bytes") is not None:
            knob_parts = [f"peak {_mib(state['train_peak_hbm_bytes'])}"]
            if state.get("remat_policy"):
                knob_parts.append(f"remat {state['remat_policy']}")
            if state.get("grads_dtype"):
                knob_parts.append(f"grads {state['grads_dtype']}")
            if state.get("scan_layers"):
                knob_parts.append("scan_layers")
            lines.append("  step   " + "  ".join(knob_parts))

    dyn = state.get("dynamics")
    if dyn:
        step = state.get("dynamics_step")
        lines.append(
            "  dyn    per-layer introspection"
            + (f" (step {_num(step)})" if step is not None else "")
        )
        lines.append(
            f"         {'layer':<18s}{'gnorm':>10s}{'upd/param':>11s}"
            f"{'act rms':>9s}{'entropy':>9s}"
        )
        for label in _dyn_labels(dyn):
            lines.append(
                f"         {label:<18s}"
                f"{_num(dyn.get(f'grad_norm/{label}'), 3):>10s}"
                f"{_num(dyn.get(f'update_ratio/{label}'), 2):>11s}"
                f"{_num(dyn.get(f'act_rms/{label}'), 3):>9s}"
                f"{_num(dyn.get(f'attn_entropy/{label}'), 3):>9s}"
            )

    compile_parts = []
    if state.get("compile_events") is not None:
        compile_parts.append(f"compile events {_num(state['compile_events'])}")
    if state.get("compile_time_s") is not None:
        compile_parts.append(
            f"compile time {_num(state['compile_time_s'], 4)}s"
        )
    if state.get("compiled_programs") is not None:
        compile_parts.append(
            f"engine programs {_num(state['compiled_programs'])}"
        )
    if compile_parts:
        lines.append("  xla    " + "  ".join(compile_parts))

    status = f"  state  records {state.get('n_records', 0)}"
    status += f"  anomalies {state.get('anomalies', 0)}"
    if state.get("rollbacks"):
        status += f"  rollbacks {state['rollbacks']}"
    if state.get("preempted"):
        status += f"  [preempted {state['preempted']}]"
    if state.get("last_anomaly"):
        status += f" (last: {state['last_anomaly']})"
    if state.get("footer_clean") is not None:
        status += (
            "  [run ended cleanly]"
            if state["footer_clean"]
            else "  [run ended UNCLEAN]"
        )
    lines.append(status)
    return "\n".join(lines)


# ------------------------------------------------------------------ sources


class FileSource:
    """Tail a metrics.jsonl incrementally (a truncated/rotated file is
    re-read whole).  Reads BYTES and splits/decodes manually: the writer may
    be mid-way through a multibyte character (or a corrupt line) exactly
    when we poll, and a torn tail must wait for the next poll, not kill the
    monitor or drift the offset."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.label = str(path)
        self._offset = 0
        self.state: dict = fold_records([])

    def refresh(self) -> dict:
        try:
            size = self.path.stat().st_size
        except OSError:
            return self.state
        if size < self._offset:  # truncated/rotated: start over
            self._offset = 0
            self.state = fold_records([])
        if size == self._offset:
            return self.state
        records = []
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break  # torn tail mid-write: pick it up next poll
                    self._offset += len(raw)
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            return self.state
        self.state = fold_records(records, self.state)
        return self.state


class FleetSource:
    """Poll a fleet aggregator's ``GET /statusz`` (``monitor
    --fleet HOST:PORT``) and map its fleet/alerts/SLO payload onto the
    same state keys the JSONL fold produces — one renderer, three
    sources."""

    def __init__(self, url: str, timeout: float = 5.0):
        import urllib.request  # noqa: F401 — fail fast if unavailable

        if "://" not in url:
            url = f"http://{url}"
        self.url = url.rstrip("/") + "/statusz"
        self.label = self.url
        self.timeout = timeout
        self.state: dict = {}

    def refresh(self) -> dict:
        import urllib.request

        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
                page = json.loads(resp.read())
        except (OSError, ValueError) as exc:
            self.state = dict(self.state)
            self.state["last_anomaly"] = f"scrape failed: {exc}"
            return self.state
        fl = page.get("fleet") or {}
        state: dict = {
            "run_kind": "fleet",
            "n_records": page.get("polls", 0),
            "uptime_s": page.get("uptime_s"),
            "anomalies": len(page.get("alerts") or []),
        }
        for key in ("replicas_total", "replicas_online", "replicas_draining",
                    "queue_depth", "active_slots", "slots", "tokens_per_sec",
                    "kv_headroom_frac", "request_p99_s", "ttfb_p99_s",
                    "availability", "accept_rate"):
            if fl.get(key) is not None:
                state[f"fleet_{key}"] = fl[key]
        firing = [
            a.get("rule") for a in page.get("alerts") or [] if a.get("rule")
        ]
        if firing:
            state["alerts_firing"] = firing
            state["last_anomaly"] = f"alert {firing[-1]}"
        history = [
            {
                "t": row.get("t"),
                "rule": row.get("rule"),
                "state": row.get("state"),
                "active_s": row.get("active_s"),
            }
            for row in page.get("alert_history") or []
            if isinstance(row, dict)
        ]
        if history:
            state["alert_history"] = history[-8:]
        burns = {}
        for row in page.get("slo") or []:
            if row.get("burn_rate") is not None:
                burns[
                    f"{row.get('objective')}/{row.get('window_s'):g}s"
                ] = row["burn_rate"]
        if burns:
            state["slo_burns"] = burns
            state["slo_max_burn"] = max(burns.values())
        self.state = state
        return state


class UrlSource:
    """Poll a running server's ``GET /metrics``."""

    def __init__(self, url: str, timeout: float = 5.0):
        if "://" not in url:
            url = f"http://{url}"
        self.url = url.rstrip("/") + "/metrics"
        self.label = self.url
        self.timeout = timeout
        self.state: dict = {}

    def refresh(self) -> dict:
        import urllib.request

        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
                text = resp.read().decode("utf-8", "replace")
        except OSError as exc:
            self.state = dict(self.state)
            self.state["last_anomaly"] = f"scrape failed: {exc}"
            return self.state
        self.state = fold_prometheus(parse_prometheus(text))
        return self.state


# --------------------------------------------------------------------- loops


def _plain_loop(source, interval: float, once: bool, out=None) -> int:
    out = out or sys.stdout
    while True:
        frame = render_frame(source.refresh(), source.label)
        print(frame, file=out, flush=True)
        if once:
            return 0
        print("-" * 72, file=out, flush=True)
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


def _curses_loop(source, interval: float) -> int:
    import curses

    def run(screen):
        curses.curs_set(0)
        screen.nodelay(True)
        while True:
            frame = render_frame(source.refresh(), source.label)
            screen.erase()
            max_y, max_x = screen.getmaxyx()
            for y, line in enumerate(frame.splitlines()[: max_y - 1]):
                screen.addnstr(y, 0, line, max_x - 1)
            screen.addnstr(
                min(max_y - 1, frame.count("\n") + 2), 0,
                "q to quit", max_x - 1,
            )
            screen.refresh()
            deadline = time.monotonic() + interval
            while time.monotonic() < deadline:
                if screen.getch() in (ord("q"), ord("Q")):
                    return 0
                time.sleep(0.05)

    try:
        return curses.wrapper(run) or 0
    except KeyboardInterrupt:
        return 0


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli monitor",
        description="Live view of a telemetry stream or a serving "
        "/metrics endpoint (torch-free).",
    )
    parser.add_argument("metrics", nargs="?", default=None,
                        help="telemetry metrics.jsonl to tail")
    parser.add_argument("--url", default=None, metavar="HOST:PORT",
                        help="poll http://HOST:PORT/metrics instead")
    parser.add_argument("--fleet", default=None, metavar="HOST:PORT",
                        help="poll a fleet aggregator's /statusz instead "
                        "(fleet): replicas online/draining, fleet "
                        "tok/s, worst kv headroom, alerts, SLO burn")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--once", action="store_true",
                        help="render one frame and exit")
    parser.add_argument("--plain", action="store_true",
                        help="plain frames even on a tty (no curses)")
    try:
        args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    except SystemExit as exc:
        return int(exc.code or 0)

    sources = sum(bool(s) for s in (args.metrics, args.url, args.fleet))
    if sources != 1:
        print("monitor: give a metrics.jsonl path OR --url host:port OR "
              "--fleet host:port",
              file=sys.stderr)
        return 2
    if args.metrics:
        if not Path(args.metrics).exists():
            print(f"monitor: no such file {args.metrics}", file=sys.stderr)
            return 1
        source = FileSource(args.metrics)
        # Nudge (one-shot mode): a stream with zero readable records still
        # renders, all fields dashed — matching report's graceful-empty
        # contract.  The refresh here is not wasted work: its folded state
        # persists and the render loop's own refresh picks up from the
        # advanced byte offset.
        if args.once and not source.refresh().get("n_records"):
            print(f"monitor: {args.metrics} holds no readable records yet",
                  file=sys.stderr)
    elif args.fleet:
        source = FleetSource(args.fleet)
    else:
        source = UrlSource(args.url)

    use_curses = (
        not args.once
        and not args.plain
        and sys.stdout.isatty()
    )
    if use_curses:
        try:
            return _curses_loop(source, args.interval)
        except Exception:
            pass  # no terminfo/odd TERM: fall back to plain frames
    return _plain_loop(source, args.interval, args.once)


if __name__ == "__main__":
    sys.exit(main())
