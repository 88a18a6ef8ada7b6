"""Incident forensics: sweep flight recorders fleet-wide into one bundle
(the port's copy of ``bpe_transformer_tpu/telemetry/incident.py``).

``incident`` is the postmortem half of the flight-recorder story
(``telemetry/flightrecorder.py``): each replica and the router keep an
always-on ring of decision events and flush triggered ``kind="blackbox"``
dumps, but an incident is a FLEET event — the router's failover hops, one
replica's parked admissions, and the alert that fired live in three
different processes.  This tool:

* **sweeps** every host's ``GET /debug/flightrecorder`` page concurrently
  (the fleet aggregator's pattern: one daemon thread per host, joined
  with a timeout, so a dead host costs ONE timeout — never the sum);
* **correlates** what it finds by absolute ``time_unix`` stamps (every
  ring entry carries one) and, when ``--request`` is given, by the
  X-Request-Id that tags admissions, hops, and finishes across hosts;
* **writes one bundle**: a JSONL stream ``report`` reads — a
  manifest header, every retained black-box dump re-stamped with its
  source ``host``, a synthesized ``trigger="sweep"`` dump of each live
  ring (evidence that never got a trigger still makes the bundle), and a
  closing ``kind="incident"`` record whose ``timeline`` interleaves every
  host's events in wall-clock order.

Deliberately stdlib-only and torch-free, like the fleet aggregator and the
report tool: postmortems run on whatever box the operator has.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

__all__ = ["sweep_hosts", "assemble_bundle", "write_bundle", "main"]

#: Merged timeline entries kept in the ``kind="incident"`` record; the
#: overflow count is recorded (``timeline_truncated``), never silent.
TIMELINE_CAP = 2000


def _fetch_json(url: str, timeout_s: float):
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def _sweep_one(url: str, timeout_s: float, out: dict) -> None:
    """One host's /debug/flightrecorder page into the shared dict.  Any
    failure marks the host offline with the error recorded — never raises
    (the sweep must survive any host)."""
    snap: dict = {"url": url, "online": False, "error": None, "page": None}
    try:
        page = _fetch_json(f"{url}/debug/flightrecorder", timeout_s)
        if not isinstance(page, dict):
            raise ValueError("flightrecorder page is not a JSON object")
        snap["page"] = page
        snap["online"] = True
    except Exception as exc:  # noqa: BLE001 — any host failure is one row
        snap["error"] = repr(exc)
    out[url] = snap


def sweep_hosts(urls: list[str], timeout_s: float = 5.0) -> list[dict]:
    """Sweep every host's flight-recorder page CONCURRENTLY: one daemon
    thread per host, each joined with the timeout (+1s of grace), so the
    whole sweep costs one timeout no matter how many hosts are dead."""
    urls = [u if "://" in u else f"http://{u}" for u in urls]
    urls = [u.rstrip("/") for u in urls]
    out: dict = {}
    threads: list[tuple[str, threading.Thread]] = []
    for url in urls:
        thread = threading.Thread(
            target=_sweep_one, args=(url, timeout_s, out), daemon=True
        )
        thread.start()
        threads.append((url, thread))
    for url, thread in threads:
        thread.join(timeout=timeout_s + 1.0)
        if url not in out:
            out[url] = {
                "url": url,
                "online": False,
                "error": "sweep thread stalled",
                "page": None,
            }
    return [out[url] for url in urls]


def assemble_bundle(
    snaps: list[dict],
    request_id: str | None = None,
    timeline_cap: int = TIMELINE_CAP,
) -> list[dict]:
    """The bundle's record list (manifest excluded — the writer stamps
    one): every host's retained black-box dumps re-stamped with ``host``,
    one synthesized ``trigger="sweep"`` dump of each live ring, and the
    closing ``kind="incident"`` summary whose merged ``timeline`` is
    wall-clock-ordered by absolute ``time_unix`` across hosts.

    ``request_id`` narrows the timeline to one request's entries — the
    X-Request-Id correlation: admissions, router hops, and finishes all
    carry the same id across processes."""
    records: list[dict] = []
    timeline: list[dict] = []
    seen: set[tuple] = set()
    host_rows: list[dict] = []
    for snap in snaps:
        page = snap.get("page") or {}
        dumps = page.get("dumps") or []
        events = page.get("events") or []
        host_rows.append(
            {
                "url": snap["url"],
                "online": snap["online"],
                "error": snap.get("error"),
                "component": page.get("component"),
                "dumps": len(dumps),
                "events": len(events),
                "dropped": page.get("dropped"),
            }
        )
        if not snap["online"]:
            continue
        for dump in dumps:
            if isinstance(dump, dict):
                records.append({**dump, "host": snap["url"]})
        # Evidence that never got a trigger still makes the bundle: the
        # live ring leaves as a synthesized sweep dump.
        records.append(
            {
                "kind": "blackbox",
                "t": (
                    events[-1].get("t", 0.0)
                    if events and isinstance(events[-1], dict)
                    else 0.0
                ),
                "time_unix": round(time.time(), 6),
                "component": page.get("component") or "?",
                "trigger": "sweep",
                "recorded": page.get("recorded"),
                "dropped": page.get("dropped"),
                "events": events,
                "host": snap["url"],
            }
        )
        # Timeline: the union of the live ring and every dump's ring
        # (a dump may retain events the live ring has since evicted),
        # de-duplicated by (host, event, t) — the same entry snapshotted
        # twice is one moment, not two.
        for entry in list(events) + [
            e
            for dump in dumps
            if isinstance(dump, dict)
            for e in dump.get("events") or []
        ]:
            if not isinstance(entry, dict):
                continue
            if request_id is not None and (
                str(entry.get("request_id") or "") != str(request_id)
            ):
                continue
            key = (
                snap["url"],
                entry.get("event"),
                entry.get("t"),
                entry.get("time_unix"),
            )
            if key in seen:
                continue
            seen.add(key)
            timeline.append(
                {
                    "host": snap["url"],
                    "component": page.get("component"),
                    **entry,
                }
            )
    # Wall-clock order ACROSS hosts: every ring entry carries an absolute
    # time_unix stamp exactly for this merge (each host's t axis has its
    # own epoch).  Stamp-less entries (malformed) sort last, stably.
    timeline.sort(
        key=lambda e: (
            not isinstance(e.get("time_unix"), (int, float)),
            e.get("time_unix") or 0.0,
        )
    )
    truncated = max(len(timeline) - timeline_cap, 0)
    if truncated:
        timeline = timeline[-timeline_cap:]
    summary: dict = {
        "kind": "incident",
        "time_unix": round(time.time(), 6),
        "hosts": host_rows,
        "hosts_online": sum(1 for row in host_rows if row["online"]),
        "dumps": sum(row["dumps"] for row in host_rows),
        "timeline": timeline,
    }
    if truncated:
        summary["timeline_truncated"] = truncated
    if request_id is not None:
        summary["request_id"] = request_id
    records.append(summary)
    return records


def write_bundle(records: list[dict], out_path: str) -> int:
    """Write the postmortem bundle JSONL (a manifest header first, so
    ``report`` resolves it like any other stream); returns the
    number of records written, header included."""
    from bpe_transformer_tpu_torch.telemetry.manifest import host_manifest

    lines = [host_manifest("incident")] + list(records)
    with open(out_path, "w") as fh:
        for record in lines:
            fh.write(json.dumps(record) + "\n")
    return len(lines)


def main(argv: list[str] | None = None) -> int:
    """``incident`` entry point (torch-free)."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli incident",
        description="Sweep router + replica flight recorders into one "
        "postmortem bundle (wall-clock-ordered cross-replica timeline; "
        "torch-free).  Summarize with report.",
    )
    parser.add_argument("--replica", action="append", required=True,
                        metavar="HOST:PORT",
                        help="replica base URL (repeatable)")
    parser.add_argument("--router", default=None, metavar="HOST:PORT",
                        help="router base URL (its hop ring joins the "
                        "timeline)")
    parser.add_argument("--timeout", type=float, default=5.0,
                        help="per-host sweep timeout in seconds (a dead "
                        "host costs one timeout)")
    parser.add_argument("--request", default=None, metavar="REQUEST_ID",
                        help="narrow the timeline to one X-Request-Id")
    parser.add_argument("--timeline-cap", type=int, default=TIMELINE_CAP,
                        help="max merged timeline entries (overflow is "
                        "counted, never silent)")
    parser.add_argument("--out", default="incident.jsonl",
                        help="bundle path (JSONL; read it with "
                        "report)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    urls = list(args.replica)
    if args.router:
        urls = [args.router] + urls
    snaps = sweep_hosts(urls, timeout_s=args.timeout)
    records = assemble_bundle(
        snaps, request_id=args.request, timeline_cap=args.timeline_cap
    )
    n = write_bundle(records, args.out)
    summary = records[-1]
    for row in summary["hosts"]:
        state = "online" if row["online"] else f"OFFLINE ({row['error']})"
        print(
            f"incident: {row['url']} [{row.get('component') or '?'}] "
            f"{state} — {row['dumps']} dump(s), {row['events']} ring "
            "event(s)"
        )
    print(
        f"incident: wrote {n} records -> {args.out} "
        f"({len(summary['timeline'])} timeline entries"
        + (
            f", {summary['timeline_truncated']} truncated"
            if summary.get("timeline_truncated")
            else ""
        )
        + ")"
    )
    return 0 if summary["hosts_online"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
