"""Chrome trace-event export: the span stream as a Perfetto-viewable JSON
(the port's torch-free copy of ``bpe_transformer_tpu/telemetry/trace.py``).

``bpe-tpu report --trace out.json`` turns the unified telemetry stream's
``kind="span"`` records into Chrome trace-event *complete* events (``"ph":
"X"``) and the periodic ``kind="engine"`` / ``kind="resources"`` /
``kind="attribution"`` snapshots into *counter* tracks (``"ph": "C"``),
producing a file chrome://tracing and https://ui.perfetto.dev open
directly.  Torch-free, like the rest of the report tooling.

Layout: every distinct span ``path`` gets its own named thread lane
(first-seen order, so ``setup`` sorts above ``setup/resume`` — parents
open before children) — EXCEPT serving spans carrying a ``request_id``,
which land in a per-request ``request/<id>`` lane so each request reads
as one queue→prefill→decode timeline instead of interleaving with its
neighbors in shared phase lanes.

Timeline assumptions (declared in :data:`TRACE_ASSUMPTIONS`, cross-checked
against the schema registry by ``tools/check_telemetry_schema.py``): span
``t``/``dur_s`` are seconds relative to the run's ``Telemetry`` epoch —
engine records share that ``t`` axis; resources records carry absolute
``time_unix`` and are re-based against the manifest's ``time_utc`` (the
run start) when present, else against the first resources sample.
"""

from __future__ import annotations

import datetime
import json
import sys
from pathlib import Path

#: Record kind -> fields this exporter reads.  Every entry must be a
#: subset of the kind's required schema fields (telemetry/schema.py) —
#: tools/check_telemetry_schema.py enforces it, so a schema change cannot
#: silently break the exporter.
TRACE_ASSUMPTIONS: dict[str, set[str]] = {
    "span": {"name", "path", "t", "dur_s"},
    "engine": {"kind", "t"},
    "resources": {"kind", "time_unix"},
    "attribution": {"kind", "t"},
    "kvpool": {"kind", "t"},
    "fleet": {"kind", "t"},
    "alert": {"kind", "t", "rule", "state"},
    "event": {"kind", "name", "t"},
    "blackbox": {"kind", "t", "trigger"},
}

#: Counter series pulled from each periodic record kind.
_ENGINE_COUNTERS = ("active_slots", "queue_depth", "tokens_per_sec")
_KVPOOL_COUNTERS = ("blocks_free", "blocks_shared", "prefill_pending_tokens")
_FLEET_COUNTERS = (
    "replicas_online", "queue_depth", "tokens_per_sec", "active_slots"
)
_ATTRIBUTION_COUNTERS = ("compute_frac", "collective_frac", "host_gap_frac")
_RESOURCE_COUNTERS = (
    "host_rss_bytes",
    "live_buffer_bytes",
    "hbm_bytes_in_use",
    "compile_events",
)

_PID = 1

#: Per-request serving lanes are capped: beyond this many distinct
#: request_ids the remaining serve/* spans fall back to the shared phase
#: lanes (serve/queue_wait|prefill|decode) — an hours-long serving stream
#: must not explode into one Perfetto row per request.
_MAX_REQUEST_LANES = 64


def _manifest_epoch_unix(records: list[dict]) -> float | None:
    """The run-start unix time from the latest manifest's ``time_utc``
    (ISO-8601), or None when absent/unparseable."""
    for record in reversed(records):
        if record.get("kind") == "manifest" and record.get("time_utc"):
            try:
                return datetime.datetime.fromisoformat(
                    str(record["time_utc"])
                ).timestamp()
            except ValueError:
                return None
    return None


def trace_events(records: list[dict]) -> list[dict]:
    """Telemetry records -> a Chrome trace-event list (ts/dur in µs)."""
    events: list[dict] = [
        {
            "ph": "M",
            "pid": _PID,
            "name": "process_name",
            "args": {"name": "bpe-tpu telemetry"},
        }
    ]
    tids: dict[str, int] = {}

    def tid_for(path: str) -> int:
        tid = tids.get(path)
        if tid is None:
            tid = tids[path] = len(tids) + 1
            events.append(
                {
                    "ph": "M",
                    "pid": _PID,
                    "tid": tid,
                    "name": "thread_name",
                    "args": {"name": path},
                }
            )
            events.append(
                {
                    "ph": "M",
                    "pid": _PID,
                    "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": tid},
                }
            )
        return tid

    request_lanes: set[str] = set()
    epoch_unix = _manifest_epoch_unix(records)
    first_resources_unix = next(
        (
            r["time_unix"]
            for r in records
            if r.get("kind") == "resources"
            and isinstance(r.get("time_unix"), (int, float))
        ),
        None,
    )

    for record in records:
        kind = record.get("kind")
        if kind == "span":
            t, dur = record.get("t"), record.get("dur_s")
            if not isinstance(t, (int, float)) or not isinstance(
                dur, (int, float)
            ):
                continue
            path = str(record.get("path") or record.get("name") or "?")
            # Per-request serving lanes: serve/* spans carry a request_id,
            # and giving each request its own lane turns three overlapping
            # phase lanes into one readable queue->prefill->decode timeline
            # per request (concurrent requests no longer garble a shared
            # serve/decode lane).  Capped at _MAX_REQUEST_LANES distinct
            # requests; overflow stays in the shared phase lanes.
            # Router spans (router/pick|hop|request) carry the same
            # request_id the replica's serve/* spans do — in a merged or
            # router-only stream they join the request's lane, so a
            # failover request reads as hop, hop, queue, prefill, decode
            # on one row.
            rid = record.get("request_id")
            if rid and path.startswith(("serve/", "router/")):
                lane = f"request/{rid}"
                if lane in request_lanes:
                    path = lane
                elif len(request_lanes) < _MAX_REQUEST_LANES:
                    request_lanes.add(lane)
                    path = lane
            args = {
                k: v
                for k, v in record.items()
                if k not in ("kind", "name", "path", "t", "dur_s")
            }
            events.append(
                {
                    "ph": "X",
                    "pid": _PID,
                    "tid": tid_for(path),
                    "name": str(record.get("name", path)),
                    "cat": "span",
                    "ts": round(t * 1e6, 1),
                    "dur": round(dur * 1e6, 1),
                    **({"args": args} if args else {}),
                }
            )
        elif kind == "engine":
            t = record.get("t")
            if not isinstance(t, (int, float)):
                continue
            series = {
                k: record[k]
                for k in _ENGINE_COUNTERS
                if isinstance(record.get(k), (int, float))
            }
            if series:
                events.append(
                    {
                        "ph": "C",
                        "pid": _PID,
                        "name": "engine",
                        "ts": round(t * 1e6, 1),
                        "args": series,
                    }
                )
        elif kind == "kvpool":
            t = record.get("t")
            if not isinstance(t, (int, float)):
                continue
            series = {
                k: record[k]
                for k in _KVPOOL_COUNTERS
                if isinstance(record.get(k), (int, float))
            }
            if series:
                events.append(
                    {
                        "ph": "C",
                        "pid": _PID,
                        "name": "kvpool",
                        "ts": round(t * 1e6, 1),
                        "args": series,
                    }
                )
        elif kind == "attribution":
            t = record.get("t")
            if not isinstance(t, (int, float)):
                continue
            series = {
                k: record[k]
                for k in _ATTRIBUTION_COUNTERS
                if isinstance(record.get(k), (int, float))
            }
            if series:
                events.append(
                    {
                        "ph": "C",
                        "pid": _PID,
                        "name": "attribution",
                        "ts": round(t * 1e6, 1),
                        "args": series,
                    }
                )
        elif kind == "fleet":
            t = record.get("t")
            if not isinstance(t, (int, float)):
                continue
            series = {
                k: record[k]
                for k in _FLEET_COUNTERS
                if isinstance(record.get(k), (int, float))
            }
            if series:
                events.append(
                    {
                        "ph": "C",
                        "pid": _PID,
                        "name": "fleet",
                        "ts": round(t * 1e6, 1),
                        "args": series,
                    }
                )
        elif kind in ("alert", "event", "blackbox"):
            # Point-in-time markers: alert edges, watchdog/NaN events, and
            # black-box dump flushes land as process-scoped instants on the
            # shared timeline, so an incident's trigger lines up visually
            # with the span/counter lanes around it.
            t = record.get("t")
            if not isinstance(t, (int, float)):
                continue
            if kind == "alert":
                name = f"alert:{record.get('rule')} {record.get('state')}"
            elif kind == "blackbox":
                name = f"blackbox:{record.get('trigger')}"
            else:
                name = str(record.get("name", "event"))
            args = {
                k: v
                for k, v in record.items()
                if k not in ("kind", "t", "events") and v is not None
                and isinstance(v, (str, int, float, bool))
            }
            events.append(
                {
                    "ph": "i",
                    "s": "p",
                    "pid": _PID,
                    "name": name,
                    "cat": kind,
                    "ts": round(t * 1e6, 1),
                    **({"args": args} if args else {}),
                }
            )
        elif kind == "resources":
            t_unix = record.get("time_unix")
            if not isinstance(t_unix, (int, float)):
                continue
            base = epoch_unix if epoch_unix is not None else first_resources_unix
            series = {
                k: record[k]
                for k in _RESOURCE_COUNTERS
                if isinstance(record.get(k), (int, float))
            }
            if series:
                events.append(
                    {
                        "ph": "C",
                        "pid": _PID,
                        "name": "resources",
                        "ts": round(max(t_unix - (base or t_unix), 0.0) * 1e6, 1),
                        "args": series,
                    }
                )
    return events


def request_timeline(
    streams: list[list[dict]], trace_id: str
) -> list[dict]:
    """One request's end-to-end timeline assembled ACROSS telemetry
    streams by its trace id (): the router's pick/hop spans and
    the replica's queue_wait/prefill/decode spans, ordered on one axis.

    ``streams`` is a list of parsed record lists (e.g. the router's JSONL
    and each replica's) — every span whose ``request_id`` equals
    ``trace_id`` joins the timeline.  Each stream has its OWN ``t`` epoch
    (its Telemetry object's creation), so ordering uses the spans'
    absolute ``time_unix`` start stamps (both emitters write them);
    stamp-less spans (older streams) fall back to their stream-relative
    ``t``, which still orders correctly within one stream.  Rows carry
    ``stream`` (the index into ``streams``), the span fields, and
    ``t_rel`` — seconds since the timeline's earliest stamped span — so a
    failover request renders as::

        t_rel=0.000  [0] router/hop   replica=A outcome=connect_failed
        t_rel=0.021  [0] router/hop   replica=B outcome=ok
        t_rel=0.022  [1] serve/queue_wait
        t_rel=0.024  [1] serve/prefill
        t_rel=0.061  [1] serve/decode
    """
    rows: list[dict] = []
    for index, records in enumerate(streams):
        for record in records or []:
            if (
                record.get("kind") != "span"
                or str(record.get("request_id") or "") != str(trace_id)
            ):
                continue
            row = dict(record)
            row["stream"] = index
            rows.append(row)
    stamped = [
        r["time_unix"]
        for r in rows
        if isinstance(r.get("time_unix"), (int, float))
    ]
    base = min(stamped) if stamped else None

    def sort_key(row):
        wall = row.get("time_unix")
        if isinstance(wall, (int, float)):
            return (0, wall)
        return (1, row.get("t") or 0.0)

    rows.sort(key=sort_key)
    for row in rows:
        wall = row.get("time_unix")
        row["t_rel"] = (
            round(wall - base, 6)
            if base is not None and isinstance(wall, (int, float))
            else None
        )
    return rows


def write_trace(records: list[dict], out_path: str | Path) -> int:
    """Write the Chrome trace JSON; returns the number of non-metadata
    events exported (0 = the stream had no spans/counters to export)."""
    events = trace_events(records)
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    Path(out_path).write_text(json.dumps(payload) + "\n")
    return sum(1 for e in events if e.get("ph") != "M")


def main(argv: list[str] | None = None) -> int:
    """Standalone entry: ``python -m ...telemetry.trace in.jsonl out.json``
    (the CLI route is ``bpe-tpu report in.jsonl --trace out.json``)."""
    from bpe_transformer_tpu_torch.telemetry.report import load_records

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: trace METRICS_JSONL OUT_JSON", file=sys.stderr)
        return 2
    records = load_records(argv[0])
    if not records:
        print(f"trace: no readable records in {argv[0]}", file=sys.stderr)
        return 1
    n = write_trace(records, argv[1])
    print(f"wrote {n} trace events -> {argv[1]} (open in Perfetto / chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
