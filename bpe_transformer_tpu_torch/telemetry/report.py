"""``report``: turn a metrics.jsonl into a human-readable summary (the port's
torch-free copy of ``bpe_transformer_tpu/telemetry/report.py``, whose output
it reproduces byte for byte).

Pure host-side file parsing — no torch import — so it runs anywhere (a laptop
reading a capture pulled off a cluster, CI summarizing a smoke run).  The
input is the unified telemetry stream one run writes: an optional manifest
header, step-metric records, span/event records, and a footer.

    bpe-tpu report run/metrics.jsonl
    python -m bpe_transformer_tpu_torch.telemetry.report run/metrics.jsonl

Sections: run manifest, loss-curve stats, throughput/MFU trajectory, a
serving summary (engine records + per-request queue_wait/prefill/decode
span percentiles, total-request p50/p95/p99 with the slow tail attributed
to its dominant phase, for ``bpe-tpu serve`` streams), an attribution
summary (``kind="attribution"`` records: the compute/collective/host-gap
step split, the MFU ceiling if only compute remained, and the XLA
cost-model roofline verdict per compiled program), a dynamics summary
(per-layer norm trajectories, update-ratio outliers, first-non-finite
localization — ``kind="dynamics"`` records, `telemetry.dynamics`), span
breakdown, health summary, and an anomaly list (non-finite records, loss
spikes, watchdog/NaN/serving events, a missing or unclean footer).
``--trace out.json`` additionally exports the span stream as Chrome
trace-event JSON (`telemetry.trace`).
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

from bpe_transformer_tpu_torch.telemetry.schema import layer_sort_key


def nonfinite_fields(record: dict) -> list[str]:
    """The flat-record health fields indicating a non-finite state (empty
    list = healthy).  Norm/loss fields are also value-checked: a NaN norm
    means the non-finite value appeared in a record that predates the count
    fields (or between reductions).  Lives here, not in `telemetry.health`,
    so the report tool stays importable without torch."""
    bad = [
        key
        for key in ("nonfinite_loss", "nonfinite_grads", "nonfinite_params")
        if record.get(key)
    ]
    bad += [
        key
        for key, value in record.items()
        if (
            key.startswith(("grad_norm/", "param_norm/"))
            or key in ("loss", "grad_norm")
        )
        and isinstance(value, float)
        and not math.isfinite(value)
    ]
    return bad


def load_records(path: str | Path) -> list[dict]:
    """Parse a JSONL file, skipping blank/corrupt lines (a crash mid-write
    must not make the evidence unreadable)."""
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(record, dict):
                    records.append(record)
    except OSError:
        return []
    return records


def _last_value(records: list[dict], key: str):
    """The key's value in the LAST record that carries it (None if none)."""
    for record in reversed(records):
        if key in record:
            return record[key]
    return None


def _stats(values: list[float]) -> dict:
    finite = [v for v in values if isinstance(v, (int, float)) and math.isfinite(v)]
    if not finite:
        return {}
    return {
        "first": finite[0],
        "last": finite[-1],
        "min": min(finite),
        "max": max(finite),
        "mean": sum(finite) / len(finite),
    }


def _last_number(records: list[dict], key: str):
    """The newest finite value of ``key`` across ``records`` (None when no
    record carries one — older streams predate the field)."""
    for record in reversed(records):
        value = record.get(key)
        if isinstance(value, (int, float)) and math.isfinite(value):
            return value
    return None


def _pctl(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 1]) of the finite values."""
    finite = sorted(
        v for v in values if isinstance(v, (int, float)) and math.isfinite(v)
    )
    if not finite:
        return None
    rank = min(len(finite) - 1, max(0, math.ceil(q * len(finite)) - 1))
    return finite[rank]


def _loss_spikes(steps: list[dict], ratio: float = 1.5) -> list[dict]:
    """Step pairs where the logged loss jumped by more than ``ratio``x —
    the classic instability signature between two log boundaries."""
    spikes = []
    prev = None
    for record in steps:
        loss = record.get("loss")
        if not isinstance(loss, (int, float)):
            continue
        if not math.isfinite(loss):
            prev = None
            continue
        if prev is not None and prev["loss"] > 0 and loss > prev["loss"] * ratio:
            spikes.append(
                {"step": record.get("step"), "loss": loss, "prev_loss": prev["loss"]}
            )
        prev = {"step": record.get("step"), "loss": loss}
    return spikes


def summarize(records: list[dict]) -> dict:
    """Machine-readable summary of a telemetry stream (the report's data)."""
    manifests = [r for r in records if r.get("kind") == "manifest"]
    # LAST manifest wins (matching benchmarks/summarize_captures.py): a
    # resumed run appends a fresh header to the same file, and the newest
    # one describes the code/devices that produced the trailing records.
    manifest = manifests[-1] if manifests else None
    footer = next((r for r in reversed(records) if r.get("kind") == "footer"), None)
    spans = [r for r in records if r.get("kind") == "span"]
    events = [r for r in records if r.get("kind") == "event"]
    engines = [r for r in records if r.get("kind") == "engine"]
    steps = [r for r in records if "kind" not in r and "step" in r and "loss" in r]
    vals = [r for r in records if "kind" not in r and "val_loss" in r]

    span_breakdown: dict = {}
    for span in spans:
        entry = span_breakdown.setdefault(
            span.get("path", span.get("name", "?")), {"n": 0, "total_s": 0.0, "max_s": 0.0}
        )
        dur = span.get("dur_s") or 0.0
        entry["n"] += 1
        entry["total_s"] += dur
        entry["max_s"] = max(entry["max_s"], dur)

    anomalies: list[str] = []
    for record in steps:
        bad = nonfinite_fields(record)
        if bad or record.get("nonfinite_path"):
            anomalies.append(
                f"non-finite state at step {record.get('step')}"
                + (f": {', '.join(bad)}" if bad else "")
                + (
                    f" (localized to {record['nonfinite_path']})"
                    if record.get("nonfinite_path")
                    else ""
                )
            )
    for record in vals:
        v = record.get("val_loss")
        if isinstance(v, (int, float)) and not math.isfinite(v):
            anomalies.append(
                f"non-finite val_loss at step {record.get('step')}"
            )
    for spike in _loss_spikes(steps):
        anomalies.append(
            f"loss spike at step {spike['step']}: "
            f"{spike['prev_loss']:.4g} -> {spike['loss']:.4g}"
        )
    for event in events:
        if event.get("name") in ("nonfinite", "watchdog_hang", "serve_worker_error"):
            anomalies.append(
                f"{event['name']} event"
                + (f" at step {event['step']}" if event.get("step") is not None else "")
                + (f" (silent {event['silent_s']}s)" if "silent_s" in event else "")
                + (f" localized to {event['path']}" if event.get("path") else "")
                + (f": {event['error']}" if "error" in event else "")
            )
    if (steps or engines) and footer is None:
        anomalies.append("no footer record — the run did not shut down cleanly")
    elif footer is not None and footer.get("clean") is False:
        anomalies.append("footer reports an unclean run")

    # Serving-engine summary: periodic {"kind": "engine"} records plus the
    # per-request serve/queue_wait|prefill|decode spans the serving layer
    # emits (serving/server.py).
    serving = None
    serve_spans = [
        s for s in spans if str(s.get("path", "")).startswith("serve/")
    ]
    if engines or serve_spans:
        phase_durs = {
            phase: [
                s.get("dur_s")
                for s in serve_spans
                if s.get("path") == f"serve/{phase}"
            ]
            for phase in ("queue_wait", "prefill", "decode")
        }
        requests = (
            footer.get("requests")
            if footer is not None and isinstance(footer.get("requests"), int)
            else len(phase_durs["decode"]) or len(phase_durs["queue_wait"])
        )
        # Per-request assembly (request_id propagated through every serve/*
        # span): total request latency percentiles, and WHICH phase the
        # slow tail spends its time in — "p99 is decode-bound" is the
        # attribution a latency SLO needs, not just three marginal
        # histograms.
        by_request: dict[str, dict[str, float]] = {}
        for s in serve_spans:
            rid = s.get("request_id")
            dur = s.get("dur_s")
            phase = str(s.get("path", "")).split("/", 1)[-1]
            if rid and isinstance(dur, (int, float)):
                req = by_request.setdefault(str(rid), {})
                req[phase] = req.get(phase, 0.0) + dur
        totals = {rid: sum(ph.values()) for rid, ph in by_request.items()}
        slow_dominant = None
        if totals:
            p95_total = _pctl(list(totals.values()), 0.95)
            tail = [
                by_request[rid]
                for rid, total in totals.items()
                if p95_total is not None and total >= p95_total
            ]
            if tail:
                phase_mass: dict[str, float] = {}
                for phases_of_req in tail:
                    for phase, dur in phases_of_req.items():
                        phase_mass[phase] = phase_mass.get(phase, 0.0) + dur
                slow_dominant = max(phase_mass, key=phase_mass.get)
        serving = {
            "n_engine_records": len(engines),
            "requests": requests,
            "requests_traced": len(by_request),
            "tokens_per_sec": _stats(
                [r.get("tokens_per_sec") for r in engines]
            ),
            "active_slots": _stats([r.get("active_slots") for r in engines]),
            "queue_depth": _stats([r.get("queue_depth") for r in engines]),
            "compiled_programs": max(
                (
                    r["compiled_programs"]
                    for r in engines
                    if isinstance(r.get("compiled_programs"), int)
                ),
                default=None,
            ),
            "phases": {
                phase: {
                    "n": len([d for d in durs if isinstance(d, (int, float))]),
                    "p50_s": _pctl(durs, 0.50),
                    "p95_s": _pctl(durs, 0.95),
                    "p99_s": _pctl(durs, 0.99),
                    "max_s": _pctl(durs, 1.0),
                }
                for phase, durs in phase_durs.items()
            },
            "total": {
                "n": len(totals),
                "p50_s": _pctl(list(totals.values()), 0.50),
                "p95_s": _pctl(list(totals.values()), 0.95),
                "p99_s": _pctl(list(totals.values()), 0.99),
            },
            "slow_dominant_phase": slow_dominant,
        }

    # Paged-KV pool trajectory (kind="kvpool", serving/kvpool/): block
    # occupancy, radix prefix-cache effectiveness, chunked-prefill
    # backlog.  The hit rate is cumulative, so its LAST sample is the
    # run's verdict.
    kvpool_records = [r for r in records if r.get("kind") == "kvpool"]
    kvpool_summary = None
    if kvpool_records:
        last = kvpool_records[-1]
        kvpool_summary = {
            "n": len(kvpool_records),
            "blocks_total": last.get("blocks_total"),
            "blocks_free": _stats(
                [r.get("blocks_free") for r in kvpool_records]
            ),
            "blocks_shared": _stats(
                [r.get("blocks_shared") for r in kvpool_records]
            ),
            "prefix_hits": last.get("prefix_hits"),
            "prefix_misses": last.get("prefix_misses"),
            "prefix_hit_rate": last.get("prefix_hit_rate"),
            "prefill_pending_tokens": _stats(
                [r.get("prefill_pending_tokens") for r in kvpool_records]
            ),
            # KV-memory economics (static per run — last sample wins):
            # the int8-KV win reads directly off these two.
            "kv_pool_bytes": last.get("kv_pool_bytes"),
            "kv_bytes_per_token": last.get("kv_bytes_per_token"),
        }

    # KV migration records (kind="migration"): the
    # disaggregated fleet's transport — counts/bytes per direction, the
    # export/transfer/import split, and the total-duration tail the
    # migration_p99_s compare row gates.  When migrations are present the
    # serving decode-phase p99 doubles as decode_p99_disagg: the decode
    # latency of a run whose decode tier never paid a prompt-sized stall,
    # gateable against a monolithic baseline.
    migration_records = [r for r in records if r.get("kind") == "migration"]
    migration_summary = None
    if migration_records:
        by_dir: dict[str, int] = {}
        for r in migration_records:
            d = str(r.get("direction"))
            by_dir[d] = by_dir.get(d, 0) + 1
        totals = [
            r.get("total_s")
            for r in migration_records
            if isinstance(r.get("total_s"), (int, float))
        ]
        migration_summary = {
            "n": len(migration_records),
            "by_direction": by_dir,
            "bytes_total": sum(
                r.get("bytes") or 0 for r in migration_records
            ),
            "blocks_total": sum(
                r.get("blocks") or 0 for r in migration_records
            ),
            "export_s": _stats(
                [r.get("export_s") for r in migration_records]
            ),
            "transfer_s": _stats(
                [r.get("transfer_s") for r in migration_records]
            ),
            "import_s": _stats(
                [r.get("import_s") for r in migration_records]
            ),
            "p50_s": _pctl(totals, 0.50),
            "p99_s": _pctl(totals, 0.99),
            "decode_p99_s": (
                ((serving or {}).get("phases") or {})
                .get("decode", {})
                .get("p99_s")
            ),
        }

    # Decode-tick roofline trajectory (kind="roofline"): the
    # weight sweep is static per run (last sample wins — the compare
    # gate's serve_weight_bytes), the KV/activation terms track occupancy.
    roofline_records = [r for r in records if r.get("kind") == "roofline"]
    roofline_summary = None
    if roofline_records:
        last = roofline_records[-1]
        roofline_summary = {
            "n": len(roofline_records),
            "weight_bytes": last.get("weight_bytes"),
            "weight_dtype": last.get("weight_dtype"),
            "fused_sampling": last.get("fused_sampling"),
            "kv_bytes": _stats(
                [r.get("kv_bytes") for r in roofline_records]
            ),
            "act_bytes": _stats(
                [r.get("act_bytes") for r in roofline_records]
            ),
            "arithmetic_intensity": _stats(
                [r.get("arithmetic_intensity") for r in roofline_records]
            ),
            "ridge_flops_per_byte": last.get("ridge_flops_per_byte"),
            "bound": last.get("bound"),
            "weight_frac": last.get("weight_frac"),
            "projected_tick_s": last.get("projected_tick_s"),
        }

    # Fleet sweeps (kind="fleet", telemetry/fleet.py): online/draining
    # trajectory, fleet-summed rates, worst-replica KV headroom, merged
    # p99s and cumulative availability (last sample wins on cumulative
    # fields, stats on gauges).
    fleet_records = [r for r in records if r.get("kind") == "fleet"]
    fleet_summary = None
    if fleet_records:
        last = fleet_records[-1]
        fleet_summary = {
            "n": len(fleet_records),
            "replicas_total": last.get("replicas_total"),
            "replicas_online": _stats(
                [r.get("replicas_online") for r in fleet_records]
            ),
            "replicas_draining": _stats(
                [r.get("replicas_draining") for r in fleet_records]
            ),
            "queue_depth": _stats(
                [r.get("queue_depth") for r in fleet_records]
            ),
            "tokens_per_sec": _stats(
                [r.get("tokens_per_sec") for r in fleet_records]
            ),
            "kv_headroom_frac": _stats(
                [r.get("kv_headroom_frac") for r in fleet_records]
            ),
            "request_p99_s": last.get("request_p99_s"),
            "ttfb_p99_s": last.get("ttfb_p99_s"),
            "availability": last.get("availability"),
            "accept_rate": last.get("accept_rate"),
        }

    # SLO burn rates (kind="slo", telemetry/slo.py): the per-objective
    # digest plus the stream-wide worst burn — the compare gate's
    # slo_max_burn_rate row reads straight off it.
    slo_records = [r for r in records if r.get("kind") == "slo"]
    slo_summary = None
    if slo_records:
        from bpe_transformer_tpu_torch.telemetry.slo import burn_summary

        slo_summary = burn_summary(slo_records)
        slo_summary["n"] = len(slo_records)
        worst = slo_summary.get("max_burn_rate")
        if isinstance(worst, (int, float)) and worst > 1.0:
            anomalies.append(
                f"error budget burning at {worst:.1f}x sustainable rate "
                "(slo records; see == slo ==)"
            )

    # Control-plane decisions (kind="control", serving/controller.py,
    #): actions by kind/outcome, the crash-loop breaker's state,
    # the staleness-hold census, and the rebalance action-duration tail
    # the rebalance_p99_s compare row gates.  A tripped breaker or any
    # failed action is an anomaly — the self-healing loop itself needed
    # healing.
    control_records = [r for r in records if r.get("kind") == "control"]
    control_summary = None
    if control_records:
        by_action: dict[str, int] = {}
        by_outcome: dict[str, int] = {}
        hold_reasons: dict[str, int] = {}
        rebalance_durs: list[float] = []
        for r in control_records:
            action = str(r.get("action"))
            outcome = str(r.get("outcome"))
            by_action[action] = by_action.get(action, 0) + 1
            key = f"{action}/{outcome}"
            by_outcome[key] = by_outcome.get(key, 0) + 1
            if action == "hold":
                reason = str(r.get("reason") or "?").split(":")[0]
                hold_reasons[reason] = hold_reasons.get(reason, 0) + 1
            if (
                action == "rebalance"
                and outcome == "ok"
                and isinstance(r.get("dur_s"), (int, float))
            ):
                rebalance_durs.append(float(r["dur_s"]))
        actions_failed = sum(
            1 for r in control_records if r.get("outcome") == "failed"
        )
        breaker_tripped = any(
            r.get("breaker") == "tripped" for r in control_records
        )
        control_summary = {
            "n": len(control_records),
            "by_action": by_action,
            "by_outcome": by_outcome,
            "actions_ok": sum(
                1 for r in control_records if r.get("outcome") == "ok"
            ),
            "actions_failed": actions_failed,
            "observe_only": sum(
                1 for r in control_records
                if r.get("outcome") == "observe_only"
            ),
            "holds": by_action.get("hold", 0),
            "hold_reasons": hold_reasons,
            "breaker_last": control_records[-1].get("breaker"),
            "breaker_tripped": breaker_tripped,
            "rebalance_p50_s": _pctl(rebalance_durs, 0.50),
            "rebalance_p99_s": _pctl(rebalance_durs, 0.99),
        }
        if breaker_tripped:
            anomalies.append(
                "control breaker tripped (consecutive action failures) — "
                "the controller halted itself; see == control =="
            )
        if actions_failed:
            anomalies.append(
                f"{actions_failed} control action(s) failed after retries"
            )

    # Watchdog transitions (kind="alert", telemetry/alerts.py): every
    # firing is an anomaly; the summary keeps the fire/clear timeline and
    # whatever was still firing when the stream ended.
    alert_records = [r for r in records if r.get("kind") == "alert"]
    alerts_summary = None
    if alert_records:
        still_firing: dict[str, dict] = {}
        fired = 0
        for r in alert_records:
            if r.get("state") == "firing":
                fired += 1
                still_firing[str(r.get("rule"))] = r
                anomalies.append(
                    f"alert {r.get('rule')} fired"
                    + (f": {r['message']}" if r.get("message") else "")
                )
            elif r.get("state") == "cleared":
                still_firing.pop(str(r.get("rule")), None)
        alerts_summary = {
            "n": len(alert_records),
            "fired": fired,
            "firing_at_end": sorted(still_firing),
            "timeline": [
                {
                    "t": r.get("t"),
                    "rule": r.get("rule"),
                    "state": r.get("state"),
                    "severity": r.get("severity"),
                    "message": r.get("message"),
                    "active_s": r.get("active_s"),
                }
                for r in alert_records
            ],
        }
        if still_firing:
            anomalies.append(
                "alerts still firing at stream end: "
                + ", ".join(sorted(still_firing))
            )

    # Flight-recorder forensics (kind="blackbox" dumps from
    # telemetry/flightrecorder.py triggers, kind="incident" bundles from
    # bpe-tpu incident): how many black-box dumps the stream carries, who
    # flushed them and why, and the incident sweep's cross-host shape.
    blackbox_records = [r for r in records if r.get("kind") == "blackbox"]
    incident_records = [r for r in records if r.get("kind") == "incident"]
    incident_summary = None
    if blackbox_records or incident_records:
        by_component: dict[str, int] = {}
        by_trigger: dict[str, int] = {}
        for r in blackbox_records:
            comp = str(r.get("component") or "?")
            by_component[comp] = by_component.get(comp, 0) + 1
            trig = str(r.get("trigger") or "?")
            by_trigger[trig] = by_trigger.get(trig, 0) + 1
        incident_summary = {
            "dumps": len(blackbox_records),
            "by_component": by_component,
            "by_trigger": by_trigger,
            "ring_events": sum(
                len(r.get("events") or []) for r in blackbox_records
            ),
            "sweeps": len(incident_records),
        }
        # The LAST sweep describes the bundle being read (one incident
        # bundle carries exactly one kind="incident" summary record).
        if incident_records:
            last = incident_records[-1]
            hosts = last.get("hosts") or []
            incident_summary["hosts"] = len(hosts)
            incident_summary["hosts_online"] = sum(
                1 for h in hosts if isinstance(h, dict) and h.get("online")
            )
            incident_summary["hosts_offline"] = [
                str(h.get("url"))
                for h in hosts
                if isinstance(h, dict) and not h.get("online")
            ]
            timeline = last.get("timeline") or []
            incident_summary["timeline_entries"] = len(timeline)
            incident_summary["timeline_truncated"] = last.get(
                "timeline_truncated"
            )
            incident_summary["request_id"] = last.get("request_id")
            incident_summary["timeline_tail"] = timeline[-12:]
            for h in incident_summary["hosts_offline"]:
                anomalies.append(f"incident sweep: host {h} unreachable")
        # A forced dump marks a terminal path (worker error, nonfinite
        # raise, preemption) — surface those triggers as anomalies.
        for trig, n in sorted(by_trigger.items()):
            if trig.startswith("alert:") or trig in (
                "watchdog_hang", "nonfinite", "worker_error", "preemption"
            ):
                anomalies.append(f"blackbox dump x{n}: trigger {trig}")

    # Speculative-decoding trajectory (kind="spec", serving/spec/): every
    # counter is cumulative, so the LAST sample is the run's verdict —
    # accept_rate tells whether the draft earns its keep,
    # tokens_per_target_step how many HBM sweeps each emitted token cost.
    spec_records = [r for r in records if r.get("kind") == "spec"]
    spec_summary = None
    if spec_records:
        last = spec_records[-1]
        spec_summary = {
            "n": len(spec_records),
            "k": last.get("k"),
            "proposed": last.get("proposed"),
            "accepted": last.get("accepted"),
            "accept_rate": last.get("accept_rate"),
            "emitted": last.get("emitted"),
            "target_steps": last.get("target_steps"),
            "tokens_per_target_step": last.get("tokens_per_target_step"),
            "rewound": last.get("rewound"),
            "draft_frac": last.get("draft_frac"),
        }

    health_last = {}
    for record in steps:
        for key, value in record.items():
            if key.startswith(("grad_norm/", "param_norm/")) or key in (
                "moe_aux",
                "nonfinite_loss",
                "nonfinite_grads",
                "nonfinite_params",
            ):
                health_last[key] = value

    # Resource-accounting trajectory (kind="resources", telemetry/resources.py):
    # HBM/RSS/live-buffer trends plus the process compile counter.  Null
    # fields (HBM on CPU backends) drop out of _stats naturally.
    resources = [r for r in records if r.get("kind") == "resources"]
    resource_summary = None
    if resources:
        resource_summary = {
            "n": len(resources),
            "host_rss_bytes": _stats([r.get("host_rss_bytes") for r in resources]),
            "live_buffer_bytes": _stats(
                [r.get("live_buffer_bytes") for r in resources]
            ),
            "hbm_bytes_in_use": _stats(
                [r.get("hbm_bytes_in_use") for r in resources]
            ),
            "hbm_peak_bytes_in_use": _stats(
                [r.get("hbm_peak_bytes_in_use") for r in resources]
            ),
            "hbm_bytes_limit": _stats(
                [r.get("hbm_bytes_limit") for r in resources]
            ),
            "compile_events": _stats(
                [r.get("compile_events") for r in resources]
            ),
            # Per-chip state bytes (optional fields — older streams predate
            # them): the ZeRO-1 optimizer-sharding memory win shows up as
            # opt_state_bytes dropping to ~1/N of the unsharded run's.
            "params_bytes": _stats(
                [r.get("params_bytes") for r in resources]
            ),
            "opt_state_bytes": _stats(
                [r.get("opt_state_bytes") for r in resources]
            ),
        }

    # Resilience records (resilience/ + training/loop.py): NaN-rollback
    # recoveries (kind="recovery") and graceful-preemption markers
    # (kind="preemption") — the report's Recovery section tells an operator
    # how much work the run lost and where the non-finite states localized.
    recoveries = [r for r in records if r.get("kind") == "recovery"]
    preemptions = [r for r in records if r.get("kind") == "preemption"]
    recovery_summary = None
    if recoveries or preemptions:
        lost = [
            r["lost_steps"]
            for r in recoveries
            if isinstance(r.get("lost_steps"), (int, float))
        ]
        recovery_summary = {
            "rollbacks": len(recoveries),
            "lost_steps_total": sum(lost) if lost else 0,
            "nonfinite_paths": sorted(
                {
                    r["nonfinite_path"]
                    for r in recoveries
                    if r.get("nonfinite_path")
                }
            ),
            "rollback_timeline": [
                {
                    "step": r.get("step"),
                    "restored_step": r.get("restored_step"),
                    "rollbacks": r.get("rollbacks"),
                }
                for r in recoveries
            ],
            "preemptions": [
                {
                    "step": r.get("step"),
                    "signal": r.get("signal"),
                    "checkpoint": r.get("checkpoint"),
                    "t": r.get("t"),
                }
                for r in preemptions
            ],
        }
        for r in recoveries:
            anomalies.append(
                f"rollback at step {r.get('step')} -> restored step "
                f"{r.get('restored_step')}"
                + (
                    f" (localized to {r['nonfinite_path']})"
                    if r.get("nonfinite_path")
                    else ""
                )
            )
        for r in preemptions:
            anomalies.append(
                f"preempted at step {r.get('step')} ({r.get('signal')})"
                + (
                    " with emergency checkpoint"
                    if r.get("checkpoint")
                    else " WITHOUT a checkpoint"
                )
            )
    for event in events:
        if event.get("name") == "recovery_abort":
            anomalies.append(
                f"recovery ABORTED at step {event.get('step')}: "
                f"{event.get('error', 'rollback budget exhausted')}"
            )

    # Training-dynamics records (kind="dynamics", telemetry/dynamics.py):
    # per-layer norm trajectories, update-ratio outliers, and the
    # first-non-finite localization callout.
    dynamics = [r for r in records if r.get("kind") == "dynamics"]
    dynamics_summary = None
    if dynamics:
        labels = sorted(
            {
                key.split("/", 1)[1]
                for r in dynamics
                for key in r
                if key.startswith("grad_norm/")
            },
            key=layer_sort_key,
        )
        per_layer = {}
        for label in labels:
            per_layer[label] = {
                "grad_norm": _stats(
                    [r[f"grad_norm/{label}"] for r in dynamics
                     if f"grad_norm/{label}" in r]
                ),
                "update_ratio_last": _last_value(dynamics, f"update_ratio/{label}"),
                "act_rms_last": _last_value(dynamics, f"act_rms/{label}"),
                "attn_entropy_last": _last_value(dynamics, f"attn_entropy/{label}"),
            }
        localization = next(
            (
                {"step": r.get("step"), "path": r["first_nonfinite"]}
                for r in dynamics
                if r.get("first_nonfinite")
            ),
            None,
        )
        ratios = {
            label: stats["update_ratio_last"]
            for label, stats in per_layer.items()
            if isinstance(stats["update_ratio_last"], (int, float))
            and math.isfinite(stats["update_ratio_last"])
            and stats["update_ratio_last"] > 0
        }
        outliers = []
        if len(ratios) >= 3:
            median = _pctl(list(ratios.values()), 0.5)
            if median and median > 0:
                outliers = [
                    {"layer": label, "ratio": ratio,
                     "x_median": ratio / median}
                    for label, ratio in ratios.items()
                    if ratio > 10 * median or ratio < median / 10
                ]
        dynamics_summary = {
            "n": len(dynamics),
            "step_range": [dynamics[0].get("step"), dynamics[-1].get("step")],
            "per_layer": per_layer,
            "first_nonfinite": localization,
            "update_ratio_outliers": outliers,
        }
        if localization:
            anomalies.append(
                f"non-finite localized to {localization['path']} "
                f"(first dynamics record at step {localization['step']})"
            )

    # Performance-attribution records (kind="attribution",
    # telemetry/attribution.py): the measured compute/collective/host-gap
    # split of step time plus the one-off XLA cost-model roofline rows —
    # the report's MFU-gap decomposition.
    attributions = [r for r in records if r.get("kind") == "attribution"]
    attribution_summary = None
    if attributions:
        programs = next(
            (
                r["programs"]
                for r in attributions
                if isinstance(r.get("programs"), list)
            ),
            [],
        )
        mfu_vals = [r.get("mfu") for r in steps if "mfu" in r]
        mfu_last = mfu_vals[-1] if mfu_vals else None
        compute_last = attributions[-1].get("compute_frac")
        mfu_compute_bound = None
        if (
            isinstance(mfu_last, (int, float))
            and isinstance(compute_last, (int, float))
            and compute_last > 0
        ):
            # What MFU the pure-compute portion of the step achieves: the
            # ceiling this run reaches if collectives + host gaps vanish —
            # anything beyond it needs kernel/layout work, not overlap.
            mfu_compute_bound = mfu_last / compute_last
        attribution_summary = {
            "n": len(attributions),
            "step_range": [
                attributions[0].get("step"), attributions[-1].get("step")
            ],
            "compute_frac": _stats(
                [r.get("compute_frac") for r in attributions]
            ),
            "collective_frac": _stats(
                [r.get("collective_frac") for r in attributions]
            ),
            "host_gap_frac": _stats(
                [r.get("host_gap_frac") for r in attributions]
            ),
            "wall_step_s": _stats([r.get("wall_step_s") for r in attributions]),
            "device_step_s": _stats(
                [r.get("device_step_s") for r in attributions]
            ),
            "mfu_last": mfu_last,
            "mfu_if_compute_only": mfu_compute_bound,
            # Peak-HBM + execution-knob labels: the LAST record's
            # compiled-step memory envelope and the remat/precision/scan
            # knobs that produced it — the compare gate's
            # train_peak_hbm_bytes row and the report's attribution line.
            "train_peak_hbm_bytes": _last_number(
                attributions, "train_peak_hbm_bytes"
            ),
            "remat_policy": attributions[-1].get("remat_policy"),
            "grads_dtype": attributions[-1].get("grads_dtype"),
            "scan_layers": attributions[-1].get("scan_layers"),
            "programs": programs,
        }

    return {
        "manifest": manifest,
        "n_manifests": len(manifests),
        "n_records": len(records),
        "steps": {
            "n": len(steps),
            "step_range": [steps[0].get("step"), steps[-1].get("step")] if steps else None,
            "loss": _stats([r.get("loss") for r in steps]),
            "grad_norm": _stats([r["grad_norm"] for r in steps if "grad_norm" in r]),
            "lr": _stats([r["lr"] for r in steps if "lr" in r]),
        },
        "val_loss": _stats([r["val_loss"] for r in vals]),
        "throughput": {
            "tokens_per_sec": _stats(
                [r["tokens_per_sec"] for r in steps if "tokens_per_sec" in r]
            ),
            "tokens_per_sec_per_chip": _stats(
                [
                    r["tokens_per_sec_per_chip"]
                    for r in steps
                    if "tokens_per_sec_per_chip" in r
                ]
            ),
            "step_wall_s": _stats([r["step_wall_s"] for r in steps if "step_wall_s" in r]),
            "mfu": _stats([r["mfu"] for r in steps if "mfu" in r]),
        },
        "serving": serving,
        "kvpool": kvpool_summary,
        "migration": migration_summary,
        "spec": spec_summary,
        "fleet": fleet_summary,
        "slo": slo_summary,
        "control": control_summary,
        "alerts": alerts_summary,
        "incident": incident_summary,
        "roofline": roofline_summary,
        "resources": resource_summary,
        "attribution": attribution_summary,
        "dynamics": dynamics_summary,
        "recovery": recovery_summary,
        "spans": span_breakdown,
        "health_last": health_last,
        "events": [e.get("name") for e in events],
        "footer": footer,
        "anomalies": anomalies,
    }


def _fmt(value, digits=4) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:,.{digits}g}"
    return str(value)


def _slo_section_lines(slo_summary: dict) -> list[str]:
    """The ``== slo ==`` section body — shared by the stream render and
    the ``--slo`` on-demand evaluation path so both always agree."""
    lines = [f"== slo ({slo_summary.get('n', 0)} evaluations) =="]
    objectives = slo_summary.get("objectives") or {}
    for name in sorted(objectives):
        entry = objectives[name]
        burn = entry.get("last_burn")
        lines.append(
            f"  {name:<18s} target {_fmt(entry.get('target'))}"
            f"  sli {_fmt(entry.get('last_sli'))}"
            f"  burn last {_fmt(burn, 3)}  max {_fmt(entry.get('max_burn'), 3)}"
            + ("  !! over budget" if isinstance(burn, (int, float))
               and burn > 1.0 else "")
        )
    worst = slo_summary.get("max_burn_rate")
    if worst is None:
        lines.append("  (no traffic inside any evaluation window)")
    else:
        lines.append(
            f"  worst burn rate {_fmt(worst, 3)} — "
            + (
                "inside error budget"
                if worst <= 1.0
                else "BURNING ERROR BUDGET"
            )
        )
    return lines


def render_report(records: list[dict]) -> str:
    """The human-readable report text for a parsed telemetry stream."""
    s = summarize(records)
    lines: list[str] = []

    manifest = s["manifest"]
    lines.append("== run manifest ==")
    if manifest:
        devices = manifest.get("devices") or {}
        mesh = manifest.get("mesh")
        lines.append(
            f"  kind={manifest.get('run_kind')}  time={manifest.get('time_utc')}"
            f"  host={manifest.get('host')}  git={str(manifest.get('git_sha'))[:12]}"
        )
        lines.append(
            f"  jax={manifest.get('jax_version', '?')}  "
            f"devices={devices.get('count', '?')}x{devices.get('kind', '?')}"
            f" ({devices.get('platform', '?')})"
            + (f"  mesh={mesh}" if mesh else "")
            + (f"  parallel={manifest.get('parallel')}" if manifest.get("parallel") else "")
        )
        if s["n_manifests"] > 1:
            lines.append(
                f"  (latest of {s['n_manifests']} manifests — "
                "resumed/appended stream; step stats span all segments)"
            )
    else:
        lines.append("  (no manifest record)")

    st = s["steps"]
    lines.append(f"== steps ({st['n']} records) ==")
    if st["n"]:
        loss = st["loss"]
        lines.append(
            f"  steps {st['step_range'][0]}..{st['step_range'][1]}  "
            f"loss {_fmt(loss.get('first'))} -> {_fmt(loss.get('last'))}"
            f"  (min {_fmt(loss.get('min'))})"
        )
        if st["grad_norm"]:
            lines.append(
                f"  grad_norm last {_fmt(st['grad_norm'].get('last'))}"
                f"  max {_fmt(st['grad_norm'].get('max'))}"
            )
    if s["val_loss"]:
        v = s["val_loss"]
        lines.append(
            f"  val_loss {_fmt(v.get('first'))} -> {_fmt(v.get('last'))}"
            f"  (best {_fmt(v.get('min'))})"
        )

    tp = s["throughput"]
    if tp["tokens_per_sec"]:
        t = tp["tokens_per_sec"]
        lines.append("== throughput ==")
        lines.append(
            f"  tokens/sec {_fmt(t.get('first'), 6)} -> {_fmt(t.get('last'), 6)}"
            f"  (peak {_fmt(t.get('max'), 6)}, mean {_fmt(t.get('mean'), 6)})"
        )
        if tp["step_wall_s"]:
            lines.append(f"  step wall time mean {_fmt(tp['step_wall_s'].get('mean'))}s")
        if tp["mfu"]:
            lines.append(
                f"  mfu {_fmt(tp['mfu'].get('last'))} (peak {_fmt(tp['mfu'].get('max'))})"
            )

    sv = s["serving"]
    if sv:
        lines.append("== serving ==")
        lines.append(
            f"  requests {sv['requests']}"
            + (
                f"  compiled_programs {sv['compiled_programs']}"
                if sv["compiled_programs"] is not None
                else ""
            )
            + f"  engine records {sv['n_engine_records']}"
        )
        if sv["tokens_per_sec"]:
            t = sv["tokens_per_sec"]
            lines.append(
                f"  tokens/sec mean {_fmt(t.get('mean'), 6)}"
                f"  (peak {_fmt(t.get('max'), 6)})"
            )
        if sv["active_slots"]:
            lines.append(
                f"  active slots mean {_fmt(sv['active_slots'].get('mean'))}"
                f"  max {_fmt(sv['active_slots'].get('max'))}"
                + (
                    f"  queue depth max {_fmt(sv['queue_depth'].get('max'))}"
                    if sv["queue_depth"]
                    else ""
                )
            )
        for phase in ("queue_wait", "prefill", "decode"):
            ph = sv["phases"][phase]
            if ph["n"]:
                lines.append(
                    f"  {phase:<11s} n={ph['n']:<4d} p50 {_fmt(ph['p50_s'])}s"
                    f"  p95 {_fmt(ph['p95_s'])}s"
                    f"  p99 {_fmt(ph.get('p99_s'))}s"
                    f"  max {_fmt(ph['max_s'])}s"
                )
        total = sv.get("total") or {}
        if total.get("n"):
            lines.append(
                f"  {'request':<11s} n={total['n']:<4d} "
                f"p50 {_fmt(total['p50_s'])}s"
                f"  p95 {_fmt(total['p95_s'])}s"
                f"  p99 {_fmt(total['p99_s'])}s"
                + (
                    f"  (slow tail dominated by {sv['slow_dominant_phase']})"
                    if sv.get("slow_dominant_phase")
                    else ""
                )
            )

    kv = s.get("kvpool")
    if kv:
        lines.append(f"== kv pool ({kv['n']} samples) ==")
        bf = kv["blocks_free"] or {}
        bsh = kv["blocks_shared"] or {}
        lines.append(
            f"  blocks {_fmt(kv['blocks_total'])}"
            f"  free last {_fmt(bf.get('last'))} (min {_fmt(bf.get('min'))})"
            f"  shared max {_fmt(bsh.get('max'))}"
        )
        rate = kv.get("prefix_hit_rate")
        lines.append(
            f"  prefix cache hits {_fmt(kv['prefix_hits'])}"
            f"  misses {_fmt(kv['prefix_misses'])}"
            + (f"  hit rate {rate:.1%}" if isinstance(rate, float) else "")
        )
        pending = kv.get("prefill_pending_tokens") or {}
        if pending.get("max"):
            lines.append(
                f"  chunked-prefill backlog max {_fmt(pending.get('max'))} "
                f"tokens (mean {_fmt(pending.get('mean'))})"
            )
        if kv.get("kv_pool_bytes") is not None:
            per_tok = kv.get("kv_bytes_per_token")
            lines.append(
                f"  pool {kv['kv_pool_bytes'] / 2**20:.1f} MiB"
                + (
                    f"  kv/token {_fmt(per_tok)} B"
                    if per_tok is not None
                    else ""
                )
            )

    mg = s.get("migration")
    if mg:
        lines.append(f"== kv migration ({mg['n']} moves) ==")
        dirs = mg.get("by_direction") or {}
        lines.append(
            "  "
            + "  ".join(
                f"{d} {dirs[d]}" for d in ("export", "import", "evacuate")
                if d in dirs
            )
            + f"  bytes {_fmt(mg['bytes_total'])}"
            + f"  blocks {_fmt(mg['blocks_total'])}"
        )
        exp = mg.get("export_s") or {}
        imp = mg.get("import_s") or {}
        tra = mg.get("transfer_s") or {}
        lines.append(
            f"  export mean {_fmt(exp.get('mean'))}s"
            f"  transfer mean {_fmt(tra.get('mean'))}s"
            f"  import mean {_fmt(imp.get('mean'))}s"
            f"  total p99 {_fmt(mg.get('p99_s'))}s"
        )
        if mg.get("decode_p99_s") is not None:
            lines.append(
                f"  disaggregated decode p99 {_fmt(mg['decode_p99_s'])}s"
                "  (decode tier never pays a prompt-sized stall)"
            )

    rf = s.get("roofline")
    if rf:
        lines.append(f"== decode roofline ({rf['n']} samples) ==")
        kvb = rf.get("kv_bytes") or {}
        lines.append(
            f"  tick weights {_fmt(rf['weight_bytes'])} B"
            + (
                f" ({rf['weight_dtype']})"
                if rf.get("weight_dtype")
                else ""
            )
            + f"  kv last {_fmt(kvb.get('last'))} B (max {_fmt(kvb.get('max'))})"
            + (
                f"  weight frac {rf['weight_frac']:.0%}"
                if isinstance(rf.get("weight_frac"), float)
                else ""
            )
        )
        ai = rf.get("arithmetic_intensity") or {}
        ridge = rf.get("ridge_flops_per_byte")
        lines.append(
            f"  intensity last {_fmt(ai.get('last'))} flops/B"
            + (f"  ridge {_fmt(ridge)}" if ridge is not None else "")
            + f"  verdict {rf.get('bound')}"
            + (
                f"  floor {rf['projected_tick_s'] * 1e3:.3f} ms/tick"
                if isinstance(rf.get("projected_tick_s"), (int, float))
                else ""
            )
            + ("  (fused sampling)" if rf.get("fused_sampling") else "")
        )

    sp = s.get("spec")
    if sp:
        lines.append(f"== speculative decoding ({sp['n']} samples) ==")
        rate = sp.get("accept_rate")
        lines.append(
            f"  k {_fmt(sp['k'])}"
            f"  proposed {_fmt(sp['proposed'])}"
            f"  accepted {_fmt(sp['accepted'])}"
            + (f"  accept rate {rate:.1%}" if isinstance(rate, float) else "")
        )
        tpts = sp.get("tokens_per_target_step")
        lines.append(
            f"  emitted {_fmt(sp['emitted'])} tokens over "
            f"{_fmt(sp['target_steps'])} target verify passes"
            + (
                f"  ({tpts:.2f} tokens/target step)"
                if isinstance(tpts, float)
                else ""
            )
        )
        frac = sp.get("draft_frac")
        lines.append(
            f"  rewound {_fmt(sp['rewound'])} stale KV positions"
            + (
                f"  draft overhead {frac:.1%} of tick wall"
                if isinstance(frac, float)
                else ""
            )
        )

    fl = s.get("fleet")
    if fl:
        lines.append(f"== fleet ({fl['n']} sweeps) ==")
        online = fl.get("replicas_online") or {}
        draining = fl.get("replicas_draining") or {}
        lines.append(
            f"  replicas {_fmt(online.get('last'))}"
            f"/{_fmt(fl.get('replicas_total'))} online"
            f" (min {_fmt(online.get('min'))}"
            + (
                f", draining max {_fmt(draining.get('max'))}"
                if draining.get("max")
                else ""
            )
            + ")"
        )
        tps = fl.get("tokens_per_sec") or {}
        queue = fl.get("queue_depth") or {}
        if tps or queue:
            lines.append(
                f"  tokens/sec mean {_fmt(tps.get('mean'), 6)}"
                f"  (peak {_fmt(tps.get('max'), 6)})"
                f"  queue max {_fmt(queue.get('max'))}"
            )
        head = fl.get("kv_headroom_frac") or {}
        if head:
            lines.append(
                f"  worst-replica kv headroom last "
                f"{_fmt(head.get('last'), 3)} (min {_fmt(head.get('min'), 3)})"
            )
        avail = fl.get("availability")
        lines.append(
            f"  request p99 {_fmt(fl.get('request_p99_s'))}s"
            f"  ttfb p99 {_fmt(fl.get('ttfb_p99_s'))}s"
            + (
                f"  availability {avail:.4%}"
                if isinstance(avail, float)
                else ""
            )
        )

    sl = s.get("slo")
    if sl:
        lines.extend(_slo_section_lines(sl))

    ctl = s.get("control")
    if ctl:
        lines.append(
            f"== control ({ctl['n']} decision(s), "
            f"breaker {ctl['breaker_last']}) =="
        )
        lines.append(
            "  actions             "
            + "  ".join(
                f"{k}:{n}" for k, n in sorted(ctl["by_outcome"].items())
            )
        )
        lines.append(
            f"  ok/failed/observe   {ctl['actions_ok']}"
            f"/{ctl['actions_failed']}/{ctl['observe_only']}"
        )
        if ctl["holds"]:
            lines.append(
                f"  holds               {ctl['holds']} ("
                + "  ".join(
                    f"{k}:{n}"
                    for k, n in sorted(ctl["hold_reasons"].items())
                )
                + ")"
            )
        if ctl.get("rebalance_p99_s") is not None:
            lines.append(
                "  rebalance dur (s)   "
                f"p50={_fmt(ctl['rebalance_p50_s'])} "
                f"p99={_fmt(ctl['rebalance_p99_s'])}"
            )
        if ctl["breaker_tripped"]:
            lines.append(
                "  BREAKER TRIPPED     controller halted after repeated"
                " action failures; restart required"
            )

    al = s.get("alerts")
    if al:
        lines.append(
            f"== alerts ({al['fired']} fired, "
            f"{len(al['firing_at_end'])} still firing) =="
        )
        for row in al["timeline"][-12:]:
            lines.append(
                f"  t={_fmt(row.get('t'))} {row.get('state'):<8s}"
                f"{str(row.get('rule')):<22s}"
                + (
                    f"({row.get('severity')}) "
                    if row.get("state") == "firing" and row.get("severity")
                    else ""
                )
                + (
                    str(row.get("message"))
                    if row.get("state") == "firing" and row.get("message")
                    else (
                        f"after {_fmt(row.get('active_s'))}s"
                        if row.get("active_s") is not None
                        else ""
                    )
                )
            )

    inc = s.get("incident")
    if inc:
        lines.append(
            f"== incident ({inc['dumps']} blackbox dump(s), "
            f"{inc['sweeps']} sweep(s)) =="
        )
        if inc["by_component"]:
            lines.append(
                "  dumps by component  "
                + "  ".join(
                    f"{comp}:{n}"
                    for comp, n in sorted(inc["by_component"].items())
                )
            )
        if inc["by_trigger"]:
            lines.append(
                "  dumps by trigger    "
                + "  ".join(
                    f"{trig}:{n}"
                    for trig, n in sorted(inc["by_trigger"].items())
                )
            )
        lines.append(f"  ring events dumped  {inc['ring_events']}")
        if inc.get("hosts") is not None:
            lines.append(
                f"  sweep hosts         {inc['hosts_online']}/{inc['hosts']}"
                " online"
                + (
                    " (unreachable: "
                    + ", ".join(inc["hosts_offline"]) + ")"
                    if inc.get("hosts_offline")
                    else ""
                )
            )
            lines.append(
                "  timeline            "
                f"{inc.get('timeline_entries', 0)} cross-host entries"
                + (
                    f" (+{inc['timeline_truncated']} truncated)"
                    if inc.get("timeline_truncated")
                    else ""
                )
                + (
                    f", request {inc['request_id']}"
                    if inc.get("request_id")
                    else ""
                )
            )
            for entry in inc.get("timeline_tail") or []:
                # Absolute stamp at full sub-second precision: a forensics
                # timeline collapses into mush under %g's 6 significant
                # digits (every 2026 unix stamp prints as 1.78e+09).
                unix = entry.get("time_unix")
                lines.append(
                    "    unix="
                    + (
                        f"{unix:.3f}"
                        if isinstance(unix, (int, float))
                        else "?"
                    )
                    + " "
                    f"[{str(entry.get('component') or '?'):<5s}] "
                    f"{str(entry.get('event')):<16s}"
                    + (
                        f" req={entry['request_id']}"
                        if entry.get("request_id")
                        else ""
                    )
                    + (
                        f" x{entry['count']}"
                        if entry.get("count")
                        else ""
                    )
                )

    rs = s["resources"]
    if rs:
        lines.append(f"== resources ({rs['n']} samples) ==")
        for key, label, scale in (
            ("host_rss_bytes", "host rss", 2**20),
            ("live_buffer_bytes", "live buffers", 2**20),
            ("hbm_bytes_in_use", "hbm in use", 2**20),
            ("hbm_peak_bytes_in_use", "hbm peak", 2**20),
            ("params_bytes", "params/chip", 2**20),
            ("opt_state_bytes", "opt state/chip", 2**20),
        ):
            st_r = rs[key]
            if st_r:
                lines.append(
                    f"  {label:<15s}{st_r['first'] / scale:,.1f} -> "
                    f"{st_r['last'] / scale:,.1f} MiB"
                    f"  (max {st_r['max'] / scale:,.1f})"
                )
        if rs["hbm_bytes_limit"] and rs["hbm_bytes_in_use"]:
            limit = rs["hbm_bytes_limit"]["last"]
            if limit:
                lines.append(
                    f"  hbm headroom {100 * (1 - rs['hbm_bytes_in_use']['last'] / limit):.1f}%"
                    f" of {limit / 2**30:,.2f} GiB"
                )
        if rs["compile_events"]:
            ce = rs["compile_events"]
            lines.append(
                f"  compile events {_fmt(ce.get('first'))} -> {_fmt(ce.get('last'))}"
            )

    at = s["attribution"]
    if at:
        lines.append(
            f"== attribution ({at['n']} records, steps "
            f"{at['step_range'][0]}..{at['step_range'][1]}) =="
        )

        def frac(stats_d):
            mean = (stats_d or {}).get("mean")
            return f"{mean:.1%}" if isinstance(mean, (int, float)) else "n/a"

        wall = (at["wall_step_s"] or {}).get("mean")
        device = (at["device_step_s"] or {}).get("mean")
        lines.append(
            f"  step time: compute {frac(at['compute_frac'])}"
            f"  collective {frac(at['collective_frac'])}"
            f"  host gap {frac(at['host_gap_frac'])}"
            + (
                f"   (wall {wall * 1e3:,.2f} ms, device {device * 1e3:,.2f} ms)"
                if isinstance(wall, (int, float))
                and isinstance(device, (int, float))
                else ""
            )
        )
        if at["mfu_last"] is not None and at["mfu_if_compute_only"] is not None:
            lines.append(
                f"  mfu {_fmt(at['mfu_last'], 3)} -> "
                f"{_fmt(at['mfu_if_compute_only'], 3)} ceiling if "
                "collective + host gap were zero (beyond that: kernels/"
                "layout, not overlap)"
            )
        peak = at.get("train_peak_hbm_bytes")
        if isinstance(peak, (int, float)):
            knobs = [
                f"remat={at.get('remat_policy') or 'n/a'}",
                f"grads={at.get('grads_dtype') or 'n/a'}",
            ]
            if at.get("scan_layers"):
                knobs.append("scan_layers")
            lines.append(
                f"  train step peak HBM {peak / 2**20:,.1f} MiB"
                f"  ({', '.join(knobs)})"
            )
        if at["programs"]:
            lines.append(
                f"  {'program':<18s}{'GFLOPs':>10s}{'MB moved':>10s}"
                f"{'AI f/B':>9s}  verdict"
            )
            ranked = sorted(
                at["programs"],
                key=lambda p: -(p.get("flops") or 0),
            )
            for prog in ranked:
                flops = prog.get("flops")
                nbytes = prog.get("bytes_accessed")
                ai = prog.get("arithmetic_intensity")
                lines.append(
                    f"  {str(prog.get('name', '?')):<18s}"
                    + (
                        f"{flops / 1e9:>10,.2f}"
                        if isinstance(flops, (int, float))
                        else f"{'-':>10s}"
                    )
                    + (
                        f"{nbytes / 2**20:>10,.1f}"
                        if isinstance(nbytes, (int, float))
                        else f"{'-':>10s}"
                    )
                    + (
                        f"{ai:>9,.1f}"
                        if isinstance(ai, (int, float))
                        else f"{'-':>9s}"
                    )
                    + f"  {prog.get('bound', 'unknown')}"
                )

    dy = s["dynamics"]
    if dy:
        lines.append(
            f"== dynamics ({dy['n']} records, steps "
            f"{dy['step_range'][0]}..{dy['step_range'][1]}) =="
        )
        lines.append(
            f"  {'layer':<20s}{'grad norm (first -> last)':<28s}"
            f"{'upd/param':>10s}{'act rms':>9s}{'entropy':>9s}"
        )
        for label, st_l in dy["per_layer"].items():
            gn = st_l["grad_norm"]
            traj = (
                f"{_fmt(gn.get('first'))} -> {_fmt(gn.get('last'))}"
                if gn
                else "-"
            )
            lines.append(
                f"  {label:<20s}{traj:<28s}"
                f"{_fmt(st_l['update_ratio_last'], 3):>10s}"
                f"{_fmt(st_l['act_rms_last'], 3):>9s}"
                f"{_fmt(st_l['attn_entropy_last'], 3):>9s}"
            )
        if dy["first_nonfinite"]:
            lines.append(
                f"  ! first non-finite: {dy['first_nonfinite']['path']} "
                f"at step {dy['first_nonfinite']['step']}"
            )
        for outlier in dy["update_ratio_outliers"]:
            lines.append(
                f"  ! update-ratio outlier: {outlier['layer']} at "
                f"{_fmt(outlier['ratio'], 3)} "
                f"({outlier['x_median']:.1f}x the per-layer median)"
            )

    rc = s["recovery"]
    if rc:
        lines.append("== recovery ==")
        lines.append(
            f"  rollbacks {rc['rollbacks']}"
            f"  lost steps ~{rc['lost_steps_total']}"
            f"  preemptions {len(rc['preemptions'])}"
        )
        for path in rc["nonfinite_paths"]:
            lines.append(f"  non-finite localized to {path}")
        for rb in rc["rollback_timeline"]:
            lines.append(
                f"  rollback #{rb['rollbacks']}: step {rb['step']} -> "
                f"restored {rb['restored_step']}"
            )
        for pre in rc["preemptions"]:
            lines.append(
                f"  preemption at step {pre['step']} ({pre['signal']}"
                + (f", t={_fmt(pre['t'])}s" if pre.get("t") is not None else "")
                + ")"
                + (
                    f" -> {pre['checkpoint']}"
                    if pre.get("checkpoint")
                    else " -> NO emergency checkpoint"
                )
            )

    if s["spans"]:
        lines.append("== spans ==")
        for path, entry in sorted(
            s["spans"].items(), key=lambda kv: -kv[1]["total_s"]
        ):
            lines.append(
                f"  {path:<28s} n={entry['n']:<4d} total {entry['total_s']:.3f}s"
                f"  max {entry['max_s']:.3f}s"
            )

    if s["health_last"]:
        lines.append("== health (last logged) ==")
        for key in sorted(s["health_last"]):
            lines.append(f"  {key} = {_fmt(s['health_last'][key])}")

    lines.append(f"== anomalies ({len(s['anomalies'])}) ==")
    for anomaly in s["anomalies"]:
        lines.append(f"  ! {anomaly}")
    if not s["anomalies"]:
        footer = s["footer"]
        verdict = "clean footer" if footer and footer.get("clean") else "none detected"
        lines.append(f"  {verdict}")
    return "\n".join(lines)


# ------------------------------------------------------ regression compare

#: Comparable metrics: name -> (extractor over a summarize() dict, better).
#: ``better`` is the direction of improvement; a move AGAINST it beyond the
#: threshold is a regression.  Extractors return None when the stream lacks
#: the metric — such metrics are simply skipped (a training stream and a
#: serving stream share a schema, not a metric set).
COMPARE_METRICS: dict = {
    "loss_last": (
        lambda s: s["steps"]["loss"].get("last"), "lower"),
    "val_loss_best": (
        lambda s: s["val_loss"].get("min"), "lower"),
    "tokens_per_sec_mean": (
        lambda s: s["throughput"]["tokens_per_sec"].get("mean"), "higher"),
    "tokens_per_sec_per_chip_mean": (
        lambda s: s["throughput"]["tokens_per_sec_per_chip"].get("mean"),
        "higher"),
    "mfu_mean": (
        lambda s: s["throughput"]["mfu"].get("mean"), "higher"),
    "step_wall_s_mean": (
        lambda s: s["throughput"]["step_wall_s"].get("mean"), "lower"),
    "serve_tokens_per_sec_mean": (
        lambda s: (s["serving"] or {}).get("tokens_per_sec", {}).get("mean"),
        "higher"),
    "serve_decode_p95_s": (
        lambda s: ((s["serving"] or {}).get("phases", {})
                   .get("decode", {}).get("p95_s")), "lower"),
    "serve_queue_wait_p95_s": (
        lambda s: ((s["serving"] or {}).get("phases", {})
                   .get("queue_wait", {}).get("p95_s")), "lower"),
    "serve_request_p99_s": (
        lambda s: ((s["serving"] or {}).get("total", {}) or {}).get("p99_s"),
        "lower"),
    "collective_frac": (
        lambda s: ((s.get("attribution") or {}).get("collective_frac", {})
                   or {}).get("mean"), "lower"),
    "host_gap_frac": (
        lambda s: ((s.get("attribution") or {}).get("host_gap_frac", {})
                   or {}).get("mean"), "lower"),
    # Training-step memory/MFU gate (): the compiled update's peak
    # HBM envelope (what the remat policy, bf16 grad boundary, and loss
    # chunking move) and the compute-only MFU ceiling (mfu /
    # compute_frac — rises when kernels/layout improve, independent of
    # host-gap noise).  A run whose peak grows back or whose ceiling sinks
    # against the baseline lost a pinned training-efficiency win.
    "train_peak_hbm_bytes": (
        lambda s: (s.get("attribution") or {}).get("train_peak_hbm_bytes"),
        "lower"),
    "mfu_compute_ceiling": (
        lambda s: (s.get("attribution") or {}).get("mfu_if_compute_only"),
        "higher"),
    "hbm_peak_bytes": (
        lambda s: (s["resources"] or {}).get("hbm_peak_bytes_in_use", {}).get("max")
        if s.get("resources") else None, "lower"),
    # Paged-KV pool effectiveness (kind="kvpool"): a shared-prefix workload
    # whose hit rate falls — or whose free-block floor sinks — regressed
    # the radix cache or leaked blocks.
    "prefix_hit_rate": (
        lambda s: (s.get("kvpool") or {}).get("prefix_hit_rate"), "higher"),
    "kv_blocks_free": (
        lambda s: ((s.get("kvpool") or {}).get("blocks_free", {})
                   or {}).get("min"), "higher"),
    # KV-memory regression gate (): a run whose per-token KV bytes
    # or resident pool bytes grow back against an int8 baseline lost the
    # quantization win — gate it like any throughput regression.
    "kv_bytes_per_token": (
        lambda s: (s.get("kvpool") or {}).get("kv_bytes_per_token"),
        "lower"),
    "kv_pool_bytes": (
        lambda s: (s.get("kvpool") or {}).get("kv_pool_bytes"), "lower"),
    # Serving weight bytes per tick (): a run whose decode tick
    # streams more weight bytes than its int8 baseline lost the weight-
    # quantization win — the memory-bound tick's latency floor moves with
    # this number, so it gates like a throughput regression.
    "serve_weight_bytes": (
        lambda s: (s.get("roofline") or {}).get("weight_bytes"), "lower"),
    # Disaggregated-serving gates (kind="migration"): the
    # migration tail (a transport regression shows up here before it
    # shows up in request p99) and the disaggregated decode p99 — the
    # headline the two-tier split exists for; a stream whose migrated-run
    # decode p99 grows back toward the monolithic baseline lost the
    # prefill/decode isolation win.
    "migration_p99_s": (
        lambda s: (s.get("migration") or {}).get("p99_s"), "lower"),
    "decode_p99_disagg": (
        lambda s: (s.get("migration") or {}).get("decode_p99_s"), "lower"),
    # Speculative-decoding effectiveness (kind="spec"): a workload whose
    # draft acceptance falls — or whose emitted-tokens-per-verify-pass
    # sinks toward 1.0 — lost the tick-count win speculation pays for
    # (draft drift, a broken rewind, a mis-sized K).
    "accept_rate": (
        lambda s: (s.get("spec") or {}).get("accept_rate"), "higher"),
    "tokens_per_target_step": (
        lambda s: (s.get("spec") or {}).get("tokens_per_target_step"),
        "higher"),
    # Fleet-level serving health (kind="fleet"/"slo"): the SLO
    # burn rate gates a serving regression the same way throughput rows
    # gate a training one — a stream whose worst burn rises past the
    # baseline's is failing its latency/availability objectives harder.
    "slo_max_burn_rate": (
        lambda s: (s.get("slo") or {}).get("max_burn_rate"), "lower"),
    # Flight-recorder forensics coverage (kind="blackbox"): an
    # incident stream that stops carrying its black-box dumps — a trigger
    # hook unwired, a ring silently disabled — has lost its evidence
    # plane; "higher" because this row gates dump COVERAGE in forensics
    # fixtures, not incident frequency in production streams (streams
    # without dumps skip the row entirely).
    "blackbox_dumps_total": (
        lambda s: (s.get("incident") or {}).get("dumps"), "higher"),
    "fleet_tokens_per_sec_mean": (
        lambda s: ((s.get("fleet") or {}).get("tokens_per_sec", {})
                   or {}).get("mean"), "higher"),
    "fleet_request_p99_s": (
        lambda s: (s.get("fleet") or {}).get("request_p99_s"), "lower"),
    "fleet_availability": (
        lambda s: (s.get("fleet") or {}).get("availability"), "higher"),
    "fleet_kv_headroom_min": (
        lambda s: ((s.get("fleet") or {}).get("kv_headroom_frac", {})
                   or {}).get("min"), "higher"),
    # Control-plane health (kind="control"): a controller whose
    # actions start failing after retries — or whose rebalance latency
    # tail stretches — is a self-healing loop that stopped healing; both
    # rows gate the closed loop the same way slo_max_burn_rate gates the
    # data plane.
    "control_actions_failed": (
        lambda s: (s.get("control") or {}).get("actions_failed"), "lower"),
    "rebalance_p99_s": (
        lambda s: (s.get("control") or {}).get("rebalance_p99_s"), "lower"),
    # Per-chip state bytes (optimizer sharding's memory win): a run whose
    # opt_state_bytes shrinks 1/N against the unsharded baseline shows up
    # as an "improved" row; growing back is a gated regression.
    "params_bytes_per_chip": (
        lambda s: ((s.get("resources") or {}).get("params_bytes", {})
                   or {}).get("last"), "lower"),
    "opt_state_bytes_per_chip": (
        lambda s: ((s.get("resources") or {}).get("opt_state_bytes", {})
                   or {}).get("last"), "lower"),
}


def extract_compare_metrics(summary: dict) -> dict:
    """``{name: (value, better)}`` for every comparable metric the stream
    actually carries (finite values only)."""
    out = {}
    for name, (extract, better) in COMPARE_METRICS.items():
        try:
            value = extract(summary)
        except (KeyError, TypeError, AttributeError):
            value = None
        if isinstance(value, (int, float)) and math.isfinite(value):
            out[name] = (float(value), better)
    return out


def baseline_capture_metrics(capture: dict) -> dict:
    """Comparable metrics out of a bench capture JSON (``bench.py``'s
    ``tpu_capture_*.json`` / a benchmark's ``BENCH_*.json`` with its payload
    under ``"parsed"``), mapped onto the stream metric names."""
    if isinstance(capture.get("parsed"), dict):
        capture = capture["parsed"]
    out = {}
    value = capture.get("value")
    if isinstance(value, (int, float)) and math.isfinite(value):
        out["tokens_per_sec_per_chip_mean"] = (float(value), "higher")
    mfu = capture.get("mfu")
    if isinstance(mfu, (int, float)) and math.isfinite(mfu):
        out["mfu_mean"] = (float(mfu), "higher")
    val_loss = capture.get("final_val_loss")
    if isinstance(val_loss, (int, float)) and math.isfinite(val_loss):
        out["val_loss_best"] = (float(val_loss), "lower")
    # Sharded-optimizer capture rows (benchmarks/bench_sharded_opt.py):
    # per-chip state bytes and the attribution fractions, gateable against
    # a later stream the same way as throughput.
    for cap_key, metric in (
        ("opt_state_bytes", "opt_state_bytes_per_chip"),
        ("params_bytes", "params_bytes_per_chip"),
        ("host_gap_frac", "host_gap_frac"),
        ("collective_frac", "collective_frac"),
        # Training-MFU push capture rows (bench_breakdown
        # --mfu-push): the compiled step's peak-HBM envelope gates a later
        # stream's attribution records.
        ("train_peak_hbm_bytes", "train_peak_hbm_bytes"),
        ("mfu_compute_ceiling", "mfu_compute_ceiling"),
        # Speculative-serving capture rows (bench_serving.py --speculate):
        # acceptance evidence gates against a later stream's spec records.
        ("accept_rate", "accept_rate"),
        ("tokens_per_target_step", "tokens_per_target_step"),
        # Fleet/SLO capture rows (): a pinned burn-rate baseline
        # gates a later fleet stream's serving health.
        ("slo_max_burn_rate", "slo_max_burn_rate"),
        ("fleet_request_p99_s", "fleet_request_p99_s"),
        ("availability", "fleet_availability"),
    ):
        value = capture.get(cap_key)
        if isinstance(value, (int, float)) and math.isfinite(value):
            out[metric] = (float(value), COMPARE_METRICS[metric][1])
    return out


def compare_metrics(
    baseline: dict,
    current: dict,
    default_threshold_pct: float = 5.0,
    thresholds: dict | None = None,
) -> tuple[list[dict], list[str]]:
    """Per-metric deltas of current vs baseline over their SHARED metrics.

    Returns ``(rows, regressions)``: one row per shared metric with the
    signed percent delta and a verdict (``ok`` / ``improved`` /
    ``regressed``), and the names that regressed beyond their threshold.
    """
    thresholds = thresholds or {}
    rows: list[dict] = []
    regressions: list[str] = []
    for name in COMPARE_METRICS:
        if name not in baseline or name not in current:
            continue
        base_value, better = baseline[name]
        cur_value, _ = current[name]
        threshold = float(thresholds.get(name, default_threshold_pct))
        if base_value == 0:
            delta_pct = 0.0 if cur_value == 0 else math.inf
        else:
            delta_pct = 100.0 * (cur_value - base_value) / abs(base_value)
        worse = delta_pct < 0 if better == "higher" else delta_pct > 0
        beyond = abs(delta_pct) > threshold
        verdict = "ok"
        if beyond:
            verdict = "regressed" if worse else "improved"
        if verdict == "regressed":
            regressions.append(name)
        rows.append(
            {
                "metric": name,
                "baseline": base_value,
                "current": cur_value,
                "delta_pct": delta_pct,
                "threshold_pct": threshold,
                "better": better,
                "verdict": verdict,
            }
        )
    return rows, regressions


def render_compare(
    rows: list[dict], regressions: list[str], baseline_label: str
) -> str:
    lines = [f"== compare vs {baseline_label} =="]
    if not rows:
        lines.append("  (no shared metrics to compare)")
        return "\n".join(lines)
    lines.append(
        f"  {'metric':<30s}{'baseline':>14s}{'current':>14s}"
        f"{'delta':>10s}  verdict"
    )
    for row in rows:
        marker = {"regressed": "!! ", "improved": "   "}.get(row["verdict"], "   ")
        lines.append(
            f"  {row['metric']:<30s}{_fmt(row['baseline'], 6):>14s}"
            f"{_fmt(row['current'], 6):>14s}{row['delta_pct']:>+9.1f}%"
            f"  {marker}{row['verdict']}"
        )
    if regressions:
        lines.append(
            f"  {len(regressions)} regression(s): {', '.join(regressions)}"
        )
    else:
        lines.append("  no regressions beyond threshold")
    return "\n".join(lines)


def _load_capture_json(path: str | Path) -> dict | None:
    """A bench capture JSON (one pretty-printed object, not JSONL), or None
    when the file isn't one.  Lets the compare gate run capture-vs-capture
    (``report new_capture.json --baseline prev_capture.json``) — the shape
    ``benchmarks/tpu_queue.sh`` self-reports with after each pass."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


def _parse_thresholds(pairs: list[str]) -> dict:
    """``--threshold metric=pct`` pairs -> {metric: pct}; unknown metric
    names are rejected so a typo cannot silently disable a gate."""
    out: dict = {}
    for pair in pairs:
        name, sep, pct = pair.partition("=")
        if not sep or name not in COMPARE_METRICS:
            known = ", ".join(sorted(COMPARE_METRICS))
            raise ValueError(
                f"bad --threshold {pair!r} (want METRIC=PCT with METRIC one "
                f"of: {known})"
            )
        out[name] = float(pct)
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="bpe-tpu report",
        description="Summarize a telemetry metrics.jsonl; optionally gate "
        "it against a baseline stream or bench capture.",
    )
    parser.add_argument("metrics", help="telemetry metrics.jsonl to report on")
    parser.add_argument(
        "--compare", metavar="BASELINE_JSONL", default=None,
        help="baseline telemetry stream: print per-metric deltas and exit "
        "3 when any shared metric regresses beyond its threshold",
    )
    parser.add_argument(
        "--baseline", metavar="BENCH_JSON", default=None,
        help="bench capture JSON (tpu_capture_*.json / BENCH_*.json) as the "
        "comparison baseline instead of a second stream",
    )
    parser.add_argument(
        "--trace", metavar="OUT_JSON", default=None,
        help="export the span stream as Chrome trace-event JSON (open in "
        "Perfetto / chrome://tracing); engine/resources records become "
        "counter tracks",
    )
    parser.add_argument(
        "--slo", action="store_true",
        help="force the SLO section: reuse the stream's slo records, or "
        "evaluate the default objectives over its fleet records; a stream "
        "with neither gets a graceful notice, never a stack trace",
    )
    parser.add_argument(
        "--threshold-pct", type=float, default=5.0,
        help="default regression threshold in percent (default: 5)",
    )
    parser.add_argument(
        "--threshold", action="append", default=[], metavar="METRIC=PCT",
        help="per-metric threshold override (repeatable)",
    )
    try:
        args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    except SystemExit as exc:
        # argparse exits 2 on usage errors; surface that as a return code so
        # callers (and tests) never see a SystemExit from library use.
        return int(exc.code or 0)

    records = load_records(args.metrics)
    capture_current = None
    if len(records) == 1 and (
        "parsed" in records[0]
        or ("value" in records[0] and "metric" in records[0])
    ):
        # A compact single-line bench capture parses as a 1-record "stream";
        # route it to the capture path like its pretty-printed siblings.
        capture_current = records[0]
        records = []
    if not records and capture_current is None:
        # Not a JSONL stream — maybe a bench capture JSON (capture-vs-
        # capture compare, the tpu_queue.sh self-report shape).
        capture_current = _load_capture_json(args.metrics)
        if capture_current is None:
            print(
                f"report: no readable records in {args.metrics} — empty, "
                "missing, or fully corrupt stream (nothing to summarize)",
                file=sys.stderr,
            )
            return 1
    try:
        thresholds = _parse_thresholds(args.threshold)
    except ValueError as exc:
        print(f"report: {exc}", file=sys.stderr)
        return 2
    if capture_current is not None:
        current_metrics = baseline_capture_metrics(capture_current)
        if not current_metrics:
            print(
                f"report: {args.metrics} is neither a telemetry stream nor "
                "a bench capture with comparable metrics",
                file=sys.stderr,
            )
            return 1
        parsed = (
            capture_current["parsed"]
            if isinstance(capture_current.get("parsed"), dict)
            else capture_current
        )
        print(f"== bench capture {args.metrics} ==")
        print(
            f"  {parsed.get('metric', '?')}  value {_fmt(parsed.get('value'), 6)}"
            f"  mfu {_fmt(parsed.get('mfu'))}"
            f"  platform {parsed.get('platform', '?')}"
        )
    else:
        summary = summarize(records)
        current_metrics = extract_compare_metrics(summary)
        print(render_report(records))

    if args.slo:
        if capture_current is not None:
            print("report: --slo needs a telemetry stream, not a bench "
                  "capture JSON", file=sys.stderr)
            return 2
        slo_records = [r for r in records if r.get("kind") == "slo"]
        fleet_records = [r for r in records if r.get("kind") == "fleet"]
        if not slo_records and fleet_records:
            # No pre-evaluated rows: run the default objectives over the
            # stream's fleet records on the spot (offline twin of the
            # aggregator's per-sweep evaluation).
            from bpe_transformer_tpu_torch.telemetry.slo import evaluate

            slo_records = evaluate(fleet_records)
        if not slo_records:
            # Pinned graceful-empty contract: a training
            # or single-replica stream simply has no fleet evidence.
            print(
                "== slo ==\n  no fleet/slo records in this stream — "
                "nothing to evaluate (run bpe-tpu fleet --metrics-jsonl "
                "against the replicas)"
            )
        elif summary.get("slo") is None:
            # Section not already rendered above: show the on-demand rows
            # AND feed their worst burn into the compare gate — a stream
            # whose aggregator died before emitting slo rows must not
            # slip a printed-as-BURNING regression past --baseline.
            from bpe_transformer_tpu_torch.telemetry.slo import burn_summary

            on_demand = burn_summary(slo_records)
            on_demand["n"] = len(slo_records)
            print("\n".join(_slo_section_lines(on_demand)))
            worst = on_demand.get("max_burn_rate")
            if isinstance(worst, (int, float)) and math.isfinite(worst):
                current_metrics.setdefault(
                    "slo_max_burn_rate", (float(worst), "lower")
                )

    if args.trace is not None:
        if not records:
            print(
                "report: --trace needs a telemetry stream, not a bench "
                "capture JSON",
                file=sys.stderr,
            )
            return 2
        from bpe_transformer_tpu_torch.telemetry.trace import write_trace

        n = write_trace(records, args.trace)
        print(
            f"wrote {n} trace events -> {args.trace} "
            "(open in Perfetto / chrome://tracing)"
        )

    if args.compare is None and args.baseline is None:
        return 0
    if args.compare is not None and args.baseline is not None:
        print("report: use --compare OR --baseline, not both", file=sys.stderr)
        return 2
    if args.compare is not None:
        base_records = load_records(args.compare)
        if not base_records:
            print(
                f"report: no readable records in baseline {args.compare}",
                file=sys.stderr,
            )
            return 1
        base_metrics = extract_compare_metrics(summarize(base_records))
        label = args.compare
    else:
        try:
            with open(args.baseline) as f:
                capture = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"report: unreadable baseline {args.baseline}: {exc}",
                  file=sys.stderr)
            return 1
        if not isinstance(capture, dict):
            print(f"report: baseline {args.baseline} is not a JSON object",
                  file=sys.stderr)
            return 1
        base_metrics = baseline_capture_metrics(capture)
        label = args.baseline
    rows, regressions = compare_metrics(
        base_metrics,
        current_metrics,
        default_threshold_pct=args.threshold_pct,
        thresholds=thresholds,
    )
    print()
    print(render_compare(rows, regressions, label))
    return 3 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
