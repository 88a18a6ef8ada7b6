"""Fleet aggregator: one operational surface over N serve replicas + the
router (``fleet``; the port's copy of ``bpe_transformer_tpu/telemetry/fleet.py``).

Every observability layer before this one is per-process: a replica's
``/metrics``, the router's routing counters, one JSONL per run.  A fleet
question — "are WE meeting p99", "which replica is about to run out of KV
blocks", "how many replicas are actually taking traffic" — has no single
place to be answered.  This module is that place:

* a poller sweeps every replica's ``/statusz`` (occupancy, drain state,
  kvpool gauges) **and** ``/metrics`` (token counters, phase latency
  histograms, spec counters, compile counter) plus the router's
  ``/statusz`` (success/failure counters for availability), CONCURRENTLY
  with per-host timeouts — poller discipline: one dead host costs
  one timeout, never the sweep;
* each sweep folds into one schema-registered ``kind="fleet"`` record:
  online/draining counts, fleet-summed token rates and queue depths,
  worst-replica KV headroom, fleet accept rate, cumulative availability
  counters, and MERGED cumulative latency histograms (Prometheus buckets
  sum exactly across replicas — fleet p99 is computed from the merged
  histogram, not averaged from per-replica p99s, which would be wrong);
* `telemetry/slo.py` evaluates the declared objectives over the rolling
  fleet stream after every sweep (``kind="slo"`` burn-rate records), and
  `telemetry/alerts.py` fleet rules (queue growth, pool exhaustion
  trend, accept collapse, replica flapping) fire ``kind="alert"``
  events;
* the aggregator serves its own ``GET /statusz`` + ``GET /metrics`` so
  the fleet is monitorable exactly like one replica
  (``monitor --fleet HOST:PORT``), and writes the records into a
  metrics JSONL ``report`` summarizes and gates.

Deliberately stdlib-only and importable without torch, like the router and
monitor: it runs on a front-end box with no accelerator runtime.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request

from bpe_transformer_tpu_torch.telemetry import alerts as alerts_mod
from bpe_transformer_tpu_torch.telemetry import slo as slo_mod

__all__ = ["FleetAggregator", "make_fleet_http_server", "main"]

#: ``bpe_tpu_request_phase_seconds_bucket{phase="total",le="0.5"} 12``
_BUCKET_LINE = re.compile(
    r'^bpe_tpu_request_phase_seconds_bucket\{phase="(\w+)",le="([^"]+)"\}\s+'
    r"(\d+(?:\.\d+)?(?:e[+-]?\d+)?)$"
)


def parse_phase_histograms(prometheus_text: str) -> dict:
    """Per-phase cumulative ``[le, count]`` pairs out of a replica's
    ``/metrics`` exposition (``le`` None = the +Inf overflow bucket) —
    the mergeable raw form of the latency evidence."""
    out: dict[str, list] = {}
    for line in prometheus_text.splitlines():
        match = _BUCKET_LINE.match(line.strip())
        if not match:
            continue
        phase, le_text, count = match.groups()
        le = None if le_text == "+Inf" else float(le_text)
        out.setdefault(phase, []).append([le, int(float(count))])
    return out


def merge_histograms(hists: list[list]) -> list:
    """Sum cumulative ``[le, count]`` pair lists across replicas.  Bucket
    bounds are fixed per process (``serving/metrics.DEFAULT_BUCKETS``), so
    the union keyed by bound sums exactly; the +Inf bucket (``le`` None)
    sorts last."""
    acc: dict = {}
    for pairs in hists:
        for le, count in pairs or []:
            key = float("inf") if le is None else float(le)
            acc[key] = acc.get(key, 0) + int(count or 0)
    return [
        [None if key == float("inf") else key, count]
        for key, count in sorted(acc.items())
    ]


def _fetch(url: str, timeout_s: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read()


class FleetAggregator:
    """Poll replicas + router into ``kind="fleet"`` records, evaluate
    SLOs, run the fleet alert rules, and serve the fleet surface.  Thread
    model matches the router: one poller thread mutates state under a
    lock; HTTP handler threads read snapshots."""

    def __init__(
        self,
        replica_urls: list[str],
        *,
        router_url: str | None = None,
        poll_interval_s: float = 2.0,
        poll_timeout_s: float = 5.0,
        telemetry=None,
        objectives=slo_mod.DEFAULT_OBJECTIVES,
        slo_windows_s=slo_mod.DEFAULT_WINDOWS_S,
        alert_rules=None,
        clock=time.monotonic,
    ):
        if not replica_urls:
            raise ValueError("fleet aggregator needs at least one replica URL")
        self.replica_urls = [self._canonical(u) for u in replica_urls]
        self.router_url = (
            self._canonical(router_url) if router_url else None
        )
        self.poll_interval_s = poll_interval_s
        self.poll_timeout_s = poll_timeout_s
        self.objectives = tuple(objectives)
        self.slo_windows_s = tuple(slo_windows_s)
        self._telemetry = telemetry
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self.alerts = alerts_mod.AlertEngine(
            alert_rules
            if alert_rules is not None
            else alerts_mod.default_fleet_rules()
        )
        #: Previous sweep's per-replica cumulative token counts (rates).
        self._prev_tokens: dict[str, tuple[float, float]] = {}
        #: Last-seen per-replica latency histograms + the monotone fleet
        #: accumulator they feed: each sweep adds every replica's
        #: per-bucket clamped increment (new cumulative minus last seen,
        #: floored at 0).  A dead replica contributes nothing — its
        #: served history is already accumulated — and a RESTART's
        #: counter reset swallows only its own dip, never a surviving
        #: replica's traffic; the emitted fleet counters therefore never
        #: decrease, which is the contract the SLO window deltas ride.
        self._prev_hists: dict[str, dict] = {}
        self._hist_cum: dict[str, dict] = {}
        #: Rolling fleet records the SLO evaluator windows over — bounded:
        #: the longest window at the fastest plausible poll cadence.
        self._records: list[dict] = []
        self._max_records = 8192
        self._latest: dict | None = None
        self._latest_slo: list[dict] = []
        self.polls = 0
        self._thread: threading.Thread | None = None
        self._running = False

    @staticmethod
    def _canonical(url: str) -> str:
        url = url if "://" in url else f"http://{url}"
        return url.rstrip("/")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FleetAggregator":
        if self._thread is not None:
            return self
        self.poll_once()
        self._running = True
        self._thread = threading.Thread(
            target=self._poll_loop, name="fleet-poller", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "FleetAggregator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _poll_loop(self) -> None:
        while self._running:
            time.sleep(self.poll_interval_s)
            if self._running:
                self.poll_once()

    # -------------------------------------------------------------- polling

    def _poll_replica(self, url: str, out: dict) -> None:
        """One replica's snapshot: /statusz JSON + /metrics exposition.
        Any failure marks the replica offline with the error recorded —
        never raises (the sweep must survive any host)."""
        snap: dict = {"url": url, "online": False, "error": None}
        try:
            page = json.loads(_fetch(f"{url}/statusz", self.poll_timeout_s))
            prom = _fetch(f"{url}/metrics", self.poll_timeout_s).decode(
                "utf-8", "replace"
            )
        except (OSError, ValueError) as exc:
            snap["error"] = f"poll failed: {exc}"
            out[url] = snap
            return
        from bpe_transformer_tpu_torch.telemetry.monitor import parse_prometheus

        samples = parse_prometheus(prom)
        kvpool = page.get("kvpool") or {}
        snap.update(
            {
                "online": bool(page.get("worker_alive", True)),
                "draining": bool(page.get("draining", False)),
                "engine_kind": page.get("engine_kind"),
                "role": page.get("role") or "both",
                "migrations_out": samples.get(
                    "bpe_tpu_migrations_out_total"
                ),
                "migrations_in": samples.get(
                    "bpe_tpu_migrations_in_total"
                ),
                "queue_depth": int(page.get("queue_depth") or 0),
                "slots": int(page.get("slots") or 0),
                "active_slots": int(page.get("active_slots") or 0),
                "requests_finished": page.get("requests_finished"),
                "kv_blocks_free": kvpool.get("kv_blocks_free"),
                "kv_blocks_total": kvpool.get("kv_blocks_total"),
                "alerts_firing": len(page.get("alerts") or []),
                "tokens_total": samples.get("bpe_tpu_tokens_generated_total"),
                "compile_events": samples.get("bpe_tpu_compile_events_total"),
                "spec_proposed": samples.get(
                    "bpe_tpu_spec_proposed_tokens_total"
                ),
                "spec_accepted": samples.get(
                    "bpe_tpu_spec_accepted_tokens_total"
                ),
                "hists": parse_phase_histograms(prom),
            }
        )
        out[url] = snap

    def _poll_router(self, out: dict) -> None:
        try:
            page = json.loads(
                _fetch(f"{self.router_url}/statusz", self.poll_timeout_s)
            )
        except (OSError, ValueError) as exc:
            out["router"] = {"online": False, "error": f"poll failed: {exc}"}
            return
        out["router"] = {
            "online": True,
            "requests_routed": int(page.get("requests_routed") or 0),
            "requests_failed": int(page.get("requests_failed") or 0),
            "requests_retried": int(page.get("requests_retried") or 0),
        }

    def poll_once(self) -> dict:
        """One concurrent sweep -> the new ``kind="fleet"`` record (also
        emitted, along with any SLO rows and alert transitions, into the
        attached telemetry stream)."""
        results: dict = {}
        threads = [
            threading.Thread(
                target=self._poll_replica, args=(url, results), daemon=True
            )
            for url in self.replica_urls
        ]
        if self.router_url:
            threads.append(
                threading.Thread(
                    target=self._poll_router, args=(results,), daemon=True
                )
            )
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=self.poll_timeout_s + 1.0)

        now = self._clock()
        t = round(now - self._t0, 6)
        snaps = [
            results.get(url, {"url": url, "online": False,
                              "error": "poll thread stalled"})
            for url in self.replica_urls
        ]
        online = [s for s in snaps if s.get("online")]

        # Per-replica token RATES from cumulative counters across sweeps
        # (a restarted replica resets its counter: negative deltas clamp
        # to a fresh baseline instead of reporting a huge negative rate).
        fleet_rate = 0.0
        any_rate = False
        for snap in snaps:
            tokens = snap.get("tokens_total")
            if tokens is None:
                continue
            prev = self._prev_tokens.get(snap["url"])
            self._prev_tokens[snap["url"]] = (now, tokens)
            if prev is None or tokens < prev[1] or now <= prev[0]:
                continue
            rate = (tokens - prev[1]) / (now - prev[0])
            snap["tokens_per_sec"] = round(rate, 3)
            fleet_rate += rate
            any_rate = True

        headrooms = [
            s["kv_blocks_free"] / s["kv_blocks_total"]
            for s in online
            if s.get("kv_blocks_total") and s.get("kv_blocks_free") is not None
        ]
        proposed = sum(s.get("spec_proposed") or 0 for s in online)
        accepted = sum(s.get("spec_accepted") or 0 for s in online)
        # Latency evidence accumulates PER REPLICA into monotone fleet
        # histograms (see _prev_hists/_hist_cum): per-bucket clamped
        # increments, so neither a replica death nor a restart's counter
        # reset ever makes the fleet counters dip.
        for snap in online:
            hists = snap.get("hists")
            if not hists:
                continue
            prev = self._prev_hists.get(snap["url"]) or {}
            for phase, pairs in hists.items():
                acc = self._hist_cum.setdefault(phase, {})
                old = {
                    (float("inf") if le is None else float(le)):
                    int(count or 0)
                    for le, count in prev.get(phase) or []
                }
                for le, count in pairs:
                    key = float("inf") if le is None else float(le)
                    inc = int(count or 0) - old.get(key, 0)
                    if inc > 0:
                        acc[key] = acc.get(key, 0) + inc
            self._prev_hists[snap["url"]] = hists

        def _cum_pairs(phase):
            return [
                [None if key == float("inf") else key, count]
                for key, count in sorted(
                    (self._hist_cum.get(phase) or {}).items()
                )
            ]

        hist_total = _cum_pairs("total")
        hist_ttfb = _cum_pairs("ttfb")
        router = results.get("router")
        requests_ok = requests_failed = None
        if router and router.get("online"):
            requests_ok = router["requests_routed"]
            requests_failed = router["requests_failed"]

        record: dict = {
            "kind": "fleet",
            "t": t,
            "time_unix": round(time.time(), 3),
            "replicas_total": len(snaps),
            "replicas_online": len(online),
            "replicas_draining": sum(
                1 for s in online if s.get("draining")
            ),
            "queue_depth": sum(s.get("queue_depth") or 0 for s in online),
            "active_slots": sum(s.get("active_slots") or 0 for s in online),
            "slots": sum(s.get("slots") or 0 for s in online),
            "tokens_per_sec": round(fleet_rate, 3) if any_rate else None,
            "tokens_total": (
                sum(s.get("tokens_total") or 0 for s in online)
                if any(s.get("tokens_total") is not None for s in online)
                else None
            ),
            "kv_blocks_free": (
                sum(s.get("kv_blocks_free") or 0 for s in online)
                if headrooms
                else None
            ),
            "kv_blocks_total": (
                sum(s.get("kv_blocks_total") or 0 for s in online)
                if headrooms
                else None
            ),
            # WORST replica's free-block fraction: the router can spread
            # around one starved pool, but the fleet's admission headroom
            # is bounded by its thinnest member.
            "kv_headroom_frac": (
                round(min(headrooms), 4) if headrooms else None
            ),
            "spec_proposed": proposed or None,
            "spec_accepted": accepted or None,
            "accept_rate": (
                round(accepted / proposed, 4) if proposed else None
            ),
            # Disaggregated-fleet shape + KV transport volume:
            # role census and cumulative migration counts, so one fleet
            # record answers "is the two-tier split carrying traffic".
            # Counts stay explicit zeros while ANY replica answers — a
            # prefill tier that died must read 0, not vanish (an
            # absent-gauge alert can never fire).
            "replicas_prefill": (
                sum(1 for s in online if s.get("role") == "prefill")
                if online else None
            ),
            "replicas_decode": (
                sum(1 for s in online if s.get("role") == "decode")
                if online else None
            ),
            "migrations_out": (
                sum(int(s.get("migrations_out") or 0) for s in online)
                if any(s.get("migrations_out") is not None for s in online)
                else None
            ),
            "migrations_in": (
                sum(int(s.get("migrations_in") or 0) for s in online)
                if any(s.get("migrations_in") is not None for s in online)
                else None
            ),
            "compile_events": (
                sum(s.get("compile_events") or 0 for s in online)
                if any(s.get("compile_events") is not None for s in online)
                else None
            ),
            "requests_ok": requests_ok,
            "requests_failed": requests_failed,
            "availability": (
                round(requests_ok / (requests_ok + requests_failed), 6)
                if requests_ok is not None
                and (requests_ok + requests_failed) > 0
                else None
            ),
            "hist_total": hist_total or None,
            "hist_ttfb": hist_ttfb or None,
            "request_p99_s": slo_mod.hist_quantile(hist_total, 0.99),
            "ttfb_p99_s": slo_mod.hist_quantile(hist_ttfb, 0.99),
            "per_replica": [
                {k: v for k, v in s.items() if k != "hists"} for s in snaps
            ],
        }

        alert_sample = {
            "queue_depth": record["queue_depth"],
            "kv_blocks_free": record["kv_blocks_free"],
            "kv_blocks_total": record["kv_blocks_total"],
            "compile_events": record["compile_events"],
            "spec_accept_rate": record["accept_rate"],
            "spec_proposed": record["spec_proposed"],
            "replica_online": {
                s["url"]: bool(s.get("online")) for s in snaps
            },
        }
        with self._lock:
            self.polls += 1
            self._records.append(record)
            if len(self._records) > self._max_records:
                self._records = self._records[-self._max_records:]
            slo_rows = slo_mod.evaluate(
                self._records,
                objectives=self.objectives,
                windows_s=self.slo_windows_s,
                t_end=t,
            )
            transitions = self.alerts.feed(alert_sample, t)
            self._latest = record
            self._latest_slo = slo_rows
        if self._telemetry is not None:
            self._telemetry.emit(record)
            for row in slo_rows:
                self._telemetry.emit(row)
            for transition in transitions:
                self._telemetry.emit(transition)
        return record

    # ------------------------------------------------------------- surface

    def statusz(self) -> dict:
        with self._lock:
            latest = dict(self._latest) if self._latest else None
            slo_rows = list(self._latest_slo)
            active = self.alerts.active()
            polls = self.polls
        per_replica = (latest or {}).pop("per_replica", [])
        return {
            "uptime_s": round(self._clock() - self._t0, 3),
            "polls": polls,
            "router_url": self.router_url,
            "fleet": latest,
            "replicas": per_replica,
            "alerts": active,
            # Last few firing->cleared transitions (AlertEngine.history):
            # a flap that cleared between polls still shows up here and on
            # the monitor panel.
            "alert_history": self.alerts.history(16),
            "slo": slo_rows,
        }

    def prometheus_metrics(self, prefix: str = "bpe_tpu_fleet") -> str:
        from bpe_transformer_tpu_torch.serving.metrics import emit_prometheus

        with self._lock:
            latest = dict(self._latest) if self._latest else {}
            slo_rows = list(self._latest_slo)
            active = self.alerts.active()
        lines: list = []

        def emit(name, kind, help_text, samples):
            emit_prometheus(lines, prefix, name, kind, help_text, samples)

        emit("replicas_total", "gauge", "Replicas the aggregator polls.",
             [({}, latest.get("replicas_total"))])
        emit("replicas_online", "gauge", "Replicas answering their poll.",
             [({}, latest.get("replicas_online"))])
        emit("replicas_draining", "gauge", "Online replicas draining.",
             [({}, latest.get("replicas_draining"))])
        emit("queue_depth", "gauge", "Fleet-summed admission queue depth.",
             [({}, latest.get("queue_depth"))])
        emit("active_slots", "gauge", "Fleet-summed occupied slots.",
             [({}, latest.get("active_slots"))])
        emit("tokens_per_sec", "gauge",
             "Fleet-summed decode token rate between sweeps.",
             [({}, latest.get("tokens_per_sec"))])
        emit("kv_headroom_frac", "gauge",
             "WORST replica's free KV-block fraction.",
             [({}, latest.get("kv_headroom_frac"))])
        emit("accept_rate", "gauge",
             "Fleet speculative-decoding acceptance rate.",
             [({}, latest.get("accept_rate"))])
        emit("replicas_prefill", "gauge",
             "Online prefill-role replicas (disaggregated tier census).",
             [({}, latest.get("replicas_prefill"))])
        emit("replicas_decode", "gauge",
             "Online decode-role replicas (disaggregated tier census).",
             [({}, latest.get("replicas_decode"))])
        emit("migrations_out_total", "counter",
             "Fleet-summed sessions exported as KV payloads.",
             [({}, latest.get("migrations_out"))])
        emit("migrations_in_total", "counter",
             "Fleet-summed sessions grafted from KV payloads.",
             [({}, latest.get("migrations_in"))])
        emit("availability", "gauge",
             "Cumulative routed-request success fraction (router counters).",
             [({}, latest.get("availability"))])
        emit("request_p99_seconds", "gauge",
             "Fleet p99 total-request latency (merged histograms).",
             [({}, latest.get("request_p99_s"))])
        emit("ttfb_p99_seconds", "gauge",
             "Fleet p99 time-to-first-byte (merged histograms).",
             [({}, latest.get("ttfb_p99_s"))])
        emit("slo_burn_rate", "gauge",
             "Error-budget burn rate per objective and window.",
             [
                 (
                     {
                         "objective": row["objective"],
                         "window_s": f"{row['window_s']:g}",
                     },
                     row.get("burn_rate"),
                 )
                 for row in slo_rows
             ])
        emit("alerts_firing", "gauge", "Alert rules currently firing.",
             [({}, len(active))])
        emit("alert_active", "gauge", "1 while the named rule fires.",
             [({"rule": a["rule"]}, 1) for a in active])
        emit("replica_online", "gauge", "Per-replica poll verdict.",
             [
                 ({"replica": s["url"]}, int(bool(s.get("online"))))
                 for s in latest.get("per_replica", [])
             ])
        return "\n".join(lines) + "\n"


def make_fleet_http_server(
    fleet: FleetAggregator, host: str = "127.0.0.1", port: int = 8200
):
    """``GET /statusz`` (fleet table + alerts + SLO rows), ``GET
    /metrics`` (Prometheus), ``GET /healthz`` — the same surface shape as
    one replica, so every existing tool points at a fleet unchanged."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # noqa: D102
            pass

        def _reply(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            path = self.path.split("?", 1)[0]
            if path in ("/statusz", "/healthz"):
                page = fleet.statusz()
                if path == "/healthz":
                    online = (page.get("fleet") or {}).get(
                        "replicas_online", 0
                    )
                    page = {"ok": bool(online), **page}
                return self._reply(
                    200, json.dumps(page).encode("utf-8"),
                    "application/json",
                )
            if path == "/metrics":
                return self._reply(
                    200, fleet.prometheus_metrics().encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            return self._reply(
                404, b'{"error": "unknown path"}', "application/json"
            )

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: list[str] | None = None) -> int:
    """``fleet`` entry point (torch-free)."""
    import argparse
    import sys
    from pathlib import Path

    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli fleet",
        description="Fleet aggregator over serve replicas + router:"
        " kind=fleet/slo/alert records, fleet /statusz + /metrics "
        "(torch-free).",
    )
    parser.add_argument("--replica", action="append", required=True,
                        metavar="HOST:PORT",
                        help="replica base URL (repeatable)")
    parser.add_argument("--router", default=None, metavar="HOST:PORT",
                        help="router base URL (availability counters)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8200,
                        help="fleet HTTP port (0: ephemeral)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="seconds between fleet sweeps")
    parser.add_argument("--poll-timeout", type=float, default=5.0,
                        help="per-host poll timeout in seconds")
    parser.add_argument("--metrics-jsonl", default=None,
                        help="write fleet/slo/alert records (and a "
                        "manifest/footer) to this JSONL; summarize with "
                        "report")
    parser.add_argument("--slo-config", default=None, metavar="JSON",
                        help="objectives as inline JSON or a path to a "
                        "JSON file (default: availability 99.9%%, total "
                        "p99<=2.5s, ttfb p99<=1s)")
    parser.add_argument("--window", action="append", type=float,
                        default=None, metavar="SECONDS",
                        help="SLO evaluation window (repeatable; default "
                        "300 and 3600)")
    parser.add_argument("--once", action="store_true",
                        help="one sweep, print the fleet record as JSON, "
                        "exit")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    objectives = slo_mod.DEFAULT_OBJECTIVES
    if args.slo_config:
        text = args.slo_config
        if Path(text).is_file():
            text = Path(text).read_text(encoding="utf-8")
        try:
            objectives = slo_mod.objectives_from_json(text)
        except ValueError as exc:
            print(f"fleet: bad --slo-config: {exc}", file=sys.stderr)
            return 2

    from bpe_transformer_tpu_torch.telemetry.manifest import host_manifest
    from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger
    from bpe_transformer_tpu_torch.telemetry.spans import Telemetry

    logger = MetricsLogger(jsonl_path=args.metrics_jsonl)
    telemetry = Telemetry(sink=logger.log) if args.metrics_jsonl else None
    if telemetry is not None:
        telemetry.emit(host_manifest("fleet"))

    fleet = FleetAggregator(
        args.replica,
        router_url=args.router,
        poll_interval_s=args.interval,
        poll_timeout_s=args.poll_timeout,
        telemetry=telemetry,
        objectives=objectives,
        slo_windows_s=tuple(args.window) if args.window else (
            slo_mod.DEFAULT_WINDOWS_S
        ),
    )
    try:
        if args.once:
            record = fleet.poll_once()
            print(json.dumps(record))
            return 0
        server = make_fleet_http_server(fleet, host=args.host, port=args.port)
        host, port = server.server_address[:2]
        with fleet:
            print(
                f"fleet view on http://{host}:{port} over "
                f"{len(fleet.replica_urls)} replicas"
                + (f" + router {fleet.router_url}" if fleet.router_url else "")
                + " (GET /healthz /metrics /statusz; Ctrl-C stops)",
                flush=True,
            )
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.shutdown()
                server.server_close()
        return 0
    finally:
        if telemetry is not None:
            telemetry.footer(clean=True, polls=fleet.polls)
        logger.close()


if __name__ == "__main__":
    import sys

    sys.exit(main())
