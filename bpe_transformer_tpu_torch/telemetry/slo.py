"""Service-level objectives over the fleet stream: declarative targets,
rolling-window SLIs, and multi-window error-budget burn rates (the port's
copy of ``bpe_transformer_tpu/telemetry/slo.py``, torch-free).

The fleet aggregator (`telemetry/fleet.py`) emits ``kind="fleet"`` records
carrying CUMULATIVE good/total counters: router success/failure counts for
availability, and merged per-phase latency histograms (cumulative Prometheus
bucket pairs) for latency objectives.  Cumulative counters are the whole
trick — any window's SLI is an exact delta between two records, no
per-request data needed, and two pollers scraping the same fleet always
agree.

An objective declares what "good" means:

* ``availability`` — a routed request that some replica answered
  (``requests_ok`` vs ``requests_ok + requests_failed``);
* latency objectives — a request whose ``total`` (or ``ttfb``) phase
  landed at or under ``threshold_s``, counted exactly from the histogram
  bucket at that bound (thresholds should sit on bucket edges from
  ``serving/metrics.DEFAULT_BUCKETS``; an off-edge threshold rounds DOWN
  to the bucket at or below it, so a request between the edge and the
  threshold is judged bad, never good — strict, the SLI can only be
  understated by the rounding).

The SRE arithmetic (Google SRE workbook, multi-window multi-burn-rate):
``sli = good/total`` over the window, ``error budget = 1 - target``,
``burn_rate = (1 - sli) / (1 - target)`` — burn 1.0 spends the budget
exactly at the objective's horizon, burn 14 is the classic page-now
threshold for a 1h window on a 30-day 99.9% objective.  Each evaluation
emits one ``kind="slo"`` record per (objective, window); ``burn_rate`` is
null when the window saw no traffic (no evidence is not good news, but it
is not bad news either).

``report --baseline`` gates on the stream's worst burn rate
(``slo_max_burn_rate``) exactly like a throughput regression — a serving
PR that melts p99 or availability fails CI with exit 3, same as one that
melts tokens/sec.

Torch-free: evaluation is pure arithmetic over parsed JSONL records.
"""

from __future__ import annotations

import dataclasses
import json
import math

__all__ = [
    "DEFAULT_OBJECTIVES",
    "DEFAULT_WINDOWS_S",
    "SLObjective",
    "burn_summary",
    "evaluate",
    "hist_quantile",
    "objectives_from_json",
]

#: Rolling evaluation windows (seconds): a short window that pages fast and
#: a long one that ignores blips — the standard multi-window pair, sized
#: for in-process fleets (production configs override via --slo-config).
DEFAULT_WINDOWS_S = (300.0, 3600.0)


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective.

    ``target`` is the good-event fraction the SLO promises (0.999 =
    "three nines").  Latency objectives additionally carry ``phase``
    (which fleet histogram: ``total`` | ``ttfb``) and ``threshold_s``
    (the per-request bound that makes a request "good")."""

    name: str
    target: float
    phase: str | None = None
    threshold_s: float | None = None

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1), got "
                f"{self.target}"
            )
        if (self.phase is None) != (self.threshold_s is None):
            raise ValueError(
                f"objective {self.name!r}: phase and threshold_s come "
                "together (latency objective) or not at all (availability)"
            )


#: The out-of-the-box fleet objectives: availability plus total-request
#: and time-to-first-byte latency bounds on DEFAULT_BUCKETS edges.
DEFAULT_OBJECTIVES = (
    SLObjective(name="availability", target=0.999),
    SLObjective(
        name="request_latency", target=0.99, phase="total", threshold_s=2.5
    ),
    SLObjective(name="ttfb", target=0.99, phase="ttfb", threshold_s=1.0),
)


def objectives_from_json(text: str) -> tuple[SLObjective, ...]:
    """Parse a ``--slo-config`` payload: a JSON list of objective objects
    (``{"name", "target", "phase"?, "threshold_s"?}``).  Raises
    ``ValueError`` on anything malformed — a typo'd SLO config must fail
    the launch, not silently gate nothing."""
    try:
        payload = json.loads(text)
    except json.JSONDecodeError as exc:
        raise ValueError(f"slo config is not valid JSON: {exc}") from exc
    if not isinstance(payload, list) or not payload:
        raise ValueError("slo config must be a non-empty JSON list")
    out = []
    for entry in payload:
        if not isinstance(entry, dict) or "name" not in entry or (
            "target" not in entry
        ):
            raise ValueError(
                f"slo config entry needs 'name' and 'target': {entry!r}"
            )
        unknown = set(entry) - {"name", "target", "phase", "threshold_s"}
        if unknown:
            raise ValueError(
                f"slo config entry {entry.get('name')!r}: unknown keys "
                f"{sorted(unknown)}"
            )
        out.append(
            SLObjective(
                name=str(entry["name"]),
                target=float(entry["target"]),
                phase=entry.get("phase"),
                threshold_s=(
                    float(entry["threshold_s"])
                    if entry.get("threshold_s") is not None
                    else None
                ),
            )
        )
    return tuple(out)


# ----------------------------------------------------- histogram arithmetic


def _hist_pairs(record: dict, phase: str) -> list | None:
    """The cumulative ``[le, count]`` pairs of one fleet record's phase
    histogram (``le`` null = +Inf overflow bucket), or None when absent."""
    hist = record.get(f"hist_{phase}")
    return hist if isinstance(hist, list) and hist else None


def _hist_total(pairs: list) -> int:
    """Total observations: the +Inf bucket's cumulative count."""
    best = 0
    for pair in pairs:
        if isinstance(pair, (list, tuple)) and len(pair) == 2:
            best = max(best, int(pair[1] or 0))
    return best


def _hist_good(pairs: list, threshold_s: float) -> int:
    """Observations provably at or under ``threshold_s``: the cumulative
    count of the LARGEST bucket bound <= the threshold.  An off-edge
    threshold rounds DOWN — a request between the bucket edge and the
    threshold cannot be proven good from the histogram, so it counts
    bad; the rounding only ever understates the SLI (strict), never
    hides a violation."""
    finite = sorted(
        (float(le), int(count or 0))
        for le, count in pairs
        if le is not None
    )
    good = 0
    for le, count in finite:
        if le <= threshold_s + 1e-12:
            good = count
        else:
            break
    return good


def hist_quantile(pairs: list, q: float) -> float | None:
    """Bucket-upper-bound quantile of a cumulative ``[le, count]`` pair
    list (None when empty) — the fleet-level twin of
    ``serving.metrics.LatencyHistogram.percentile``."""
    total = _hist_total(pairs or [])
    if not total:
        return None
    rank = max(1, math.ceil(q * total))
    finite = sorted(
        (float(le), int(count or 0))
        for le, count in pairs
        if le is not None
    )
    for le, count in finite:
        if count >= rank:
            return le
    return finite[-1][0] if finite else None


# ------------------------------------------------------------- evaluation


def _good_total(record: dict, objective: SLObjective):
    """Cumulative (good, total) counters of one fleet record under one
    objective, or None when the record carries no evidence for it."""
    if objective.phase is None:
        ok = record.get("requests_ok")
        failed = record.get("requests_failed")
        if ok is None or failed is None:
            return None
        return int(ok), int(ok) + int(failed)
    pairs = _hist_pairs(record, objective.phase)
    if pairs is None:
        return None
    return (
        _hist_good(pairs, objective.threshold_s),
        _hist_total(pairs),
    )


def evaluate(
    fleet_records: list[dict],
    objectives=DEFAULT_OBJECTIVES,
    windows_s=DEFAULT_WINDOWS_S,
    t_end: float | None = None,
) -> list[dict]:
    """Evaluate every objective over every rolling window ending at
    ``t_end`` (default: the last fleet record's ``t``), returning one
    ``kind="slo"`` record per (objective, window).

    The window's (good, total) is the DELTA between the last record inside
    the window and the newest record at/before the window start (falling
    back to zero counters when the window covers the whole stream); a
    window with no traffic reports ``burn_rate: null``."""
    records = [
        r
        for r in fleet_records
        if r.get("kind") == "fleet" and isinstance(r.get("t"), (int, float))
    ]
    records.sort(key=lambda r: r["t"])
    out: list[dict] = []
    if not records:
        return out
    if t_end is None:
        t_end = float(records[-1]["t"])
    for objective in objectives:
        series = [
            (float(r["t"]), gt)
            for r in records
            if (gt := _good_total(r, objective)) is not None
        ]
        for window_s in windows_s:
            row = {
                "kind": "slo",
                "t": round(t_end, 6),
                "objective": objective.name,
                "window_s": float(window_s),
                "target": objective.target,
                "good": None,
                "total": None,
                "sli": None,
                "burn_rate": None,
            }
            if objective.threshold_s is not None:
                row["threshold_s"] = objective.threshold_s
            inside = [
                (t, gt) for t, gt in series if t_end - window_s < t <= t_end
            ]
            if inside:
                base = (0, 0)
                for t, gt in series:
                    if t <= t_end - window_s:
                        base = gt
                    else:
                        break
                # Prometheus increase() semantics: the window's counts are
                # the SUM of per-step POSITIVE deltas, never end-minus-base
                # raw.  The fleet aggregator already keeps its histogram
                # counters monotone per replica, so this clamp is the
                # BACKSTOP for the counters that remain single-source —
                # the router's availability counts across a router
                # restart, or hand-built fleet streams — where a dip
                # would otherwise go negative and report the outage
                # window as "no traffic".  (The clamp is per merged step:
                # one dipping sweep loses that sweep's coincident
                # traffic, strictly better than losing the window.)
                good = total = 0
                prev = base
                for _, gt in inside:
                    good += max(gt[0] - prev[0], 0)
                    total += max(gt[1] - prev[1], 0)
                    prev = gt
                row["good"] = good
                row["total"] = total
                if total > 0:
                    sli = good / total
                    row["sli"] = round(sli, 6)
                    row["burn_rate"] = round(
                        (1.0 - sli) / (1.0 - objective.target), 4
                    )
            out.append(row)
    return out


def burn_summary(slo_records: list[dict]) -> dict:
    """Per-(objective, window) burn digest of a stream's ``kind="slo"``
    records: ``{"objective (Ws)": {"last_burn", "max_burn", "window_s",
    "target", "last_sli"}}`` plus the stream-wide ``"max_burn_rate"`` —
    the number the compare gate rides.  Windows are SEPARATE entries: the
    multi-window pattern's whole point is that the 5-minute burn pages
    while the 1-hour burn shrugs, so folding them into one row would hide
    exactly the spike that matters."""
    per: dict[str, dict] = {}
    overall = None
    for record in slo_records:
        if record.get("kind") != "slo":
            continue
        name = record.get("objective")
        window_s = record.get("window_s")
        label = (
            f"{name} ({window_s:g}s)"
            if isinstance(window_s, (int, float))
            else str(name)
        )
        burn = record.get("burn_rate")
        entry = per.setdefault(
            label,
            {
                "last_burn": None,
                "max_burn": None,
                "window_s": window_s,
                "target": record.get("target"),
                "last_sli": None,
            },
        )
        if isinstance(burn, (int, float)) and math.isfinite(burn):
            entry["last_burn"] = burn
            entry["max_burn"] = (
                burn
                if entry["max_burn"] is None
                else max(entry["max_burn"], burn)
            )
            overall = burn if overall is None else max(overall, burn)
        if record.get("sli") is not None:
            entry["last_sli"] = record["sli"]
    return {"objectives": per, "max_burn_rate": overall}
