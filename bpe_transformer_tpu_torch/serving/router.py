"""Health-aware fleet router: one torch-free HTTP front over N engine
replicas (``route``; the port's copy of ``bpe_transformer_tpu/serving/router.py``).

One ``serve`` process owns one accelerator; serving real traffic
means a FLEET of replicas, and the fleet needs exactly two things a single
replica cannot provide: capacity-weighted spreading and survival of any
one replica draining (rolling restarts) or dying (exit-75 respawn
window).  This router provides both from the replicas' existing
operational surface — no new protocol:

* a poller thread GETs each replica's ``/statusz`` every
  ``poll_interval_s``: ``queue_depth``, ``active_slots``/``slots``, the
  paged pool's ``kv_blocks_free``, ``draining``, ``worker_alive``, and
  the ``last_errors`` ring feed a per-replica health record; a failed
  poll marks the replica down immediately (fast failover), a healthy
  poll brings it back (rejoin after restart needs no operator action);
* ``POST /generate`` picks the healthy, non-draining replica with the
  most free capacity — weighted by free slots, free KV blocks, and queue
  depth — and proxies the request.  A refused/broken connection or a
  draining/backpressure 503 marks the replica and **re-queues the request
  on the next-best replica** (generation is deterministic per seed, so a
  replayed request returns the same tokens), so a rolling restart loses
  zero requests;
* **two-tier disaggregated scheduling**: with
  ``--prefill-threshold N`` and a fleet containing ``--role prefill``
  replicas, prompts of >= N tokens prefill on the best prefill-role
  replica (``POST /kv/export`` returns the finished prefix as a binary
  KV payload) and decode on the least-loaded decode-role replica
  (``POST /kv/import`` grafts it and runs pure ticks) — decode p99
  decouples from prompt-length variance because no decode tick ever
  waits behind a prompt-sized prefill.  Short prompts bypass straight
  to decode-capable replicas; a dead prefill tier degrades to normal
  single-tier balancing, never to an error;
* an optional ``"session"`` body key makes routing STICKY: the key hashes
  to one replica of the fixed fleet list, and while that replica is
  available it is tried first (weighted order is only the fallback on
  drain/death), so a multi-turn conversation keeps landing where its
  radix prefix blocks already live and re-prefills nothing.  The
  affinity hit rate is surfaced in ``/statusz`` + ``/metrics``;
* ``GET /statusz`` (the fleet table: per-replica health + routing
  counters) and ``GET /metrics`` (Prometheus: routed/retried/failed
  counters per replica, per-replica health gauges) make the router
  itself monitorable by the same tools (`monitor --url`);
* **distributed request tracing**: every request gets a
  ``trace_id`` — an inbound ``X-Request-Id`` header honored, one minted
  otherwise — forwarded to the replica (whose serve layer adopts it as
  the ``request_id`` on its spans and slot state) and echoed back on
  EVERY response, 503/504 failures included.  With ``--metrics-jsonl``
  the router narrates its side of each request into its own telemetry
  stream: a ``router/pick`` span (replica selection), one ``router/hop``
  span per ATTEMPTED replica (connect time, time-to-first-byte, outcome
  — a failover request shows every hop it burned), and a
  ``router/request`` envelope span, all tagged ``request_id=trace_id``
  and stamped with absolute ``time_unix`` so
  ``telemetry.trace.request_timeline`` can stitch the router stream and
  the replica streams into one end-to-end timeline.

Deliberately stdlib-only and importable without torch — it runs on a
front-end box with no accelerator runtime, like ``monitor``.
"""

from __future__ import annotations

import collections
import http.client
import json
import threading
import time
import urllib.request
import uuid
import zlib
from urllib.parse import urlsplit

from bpe_transformer_tpu_torch.telemetry.flightrecorder import FlightRecorder

__all__ = ["ReplicaState", "Router", "make_router_http_server", "main"]


class ReplicaState:
    """The router's live view of one replica (mutated by the poller)."""

    __slots__ = (
        "url", "healthy", "draining", "queue_depth", "active_slots",
        "slots", "kv_blocks_free", "kv_blocks_total", "last_error",
        "last_poll_t", "consecutive_failures", "routed", "retried_away",
        "role", "suspect", "next_probe_t", "probe_backoff_s",
    )

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = False  # unknown until the first poll
        self.draining = False
        self.queue_depth = 0
        self.active_slots = 0
        self.slots = 0
        self.kv_blocks_free = None
        self.kv_blocks_total = None
        #: Disaggregated-fleet role from /statusz: "prefill" |
        #: "decode" | "both" — pre-role replicas report nothing and
        #: default to "both".
        self.role = "both"
        self.last_error: str | None = None
        self.last_poll_t: float | None = None
        self.consecutive_failures = 0
        self.routed = 0
        self.retried_away = 0
        #: Suspect replicas: after ``suspect_after`` consecutive
        #: connect failures the replica is quarantined — excluded from
        #: routing AND from the regular poll sweep, probed only when the
        #: exponential backoff deadline (``next_probe_t``) passes.  A live
        #: request never pays a connect timeout against a host the fleet
        #: already knows is gone; a successful probe clears the flag.
        self.suspect = False
        self.next_probe_t: float | None = None
        self.probe_backoff_s = 0.0

    @property
    def available(self) -> bool:
        return self.healthy and not self.draining and not self.suspect

    def weight(self) -> float:
        """Free-capacity score (higher = more headroom): free slots are
        the primary axis, free KV blocks (paged replicas) scale it — a
        replica with slots but a starved block pool would only park
        admissions — and queued requests count against."""
        free_slots = max(self.slots - self.active_slots, 0)
        score = float(free_slots) - float(self.queue_depth)
        if self.kv_blocks_total:
            score += free_slots * (
                (self.kv_blocks_free or 0) / self.kv_blocks_total
            )
        return score

    def snapshot(self) -> dict:
        return {
            "url": self.url,
            "role": self.role,
            "healthy": self.healthy,
            "draining": self.draining,
            "available": self.available,
            "weight": round(self.weight(), 3),
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "slots": self.slots,
            "kv_blocks_free": self.kv_blocks_free,
            "kv_blocks_total": self.kv_blocks_total,
            "routed": self.routed,
            "retried_away": self.retried_away,
            "consecutive_failures": self.consecutive_failures,
            "suspect": self.suspect,
            "probe_backoff_s": round(self.probe_backoff_s, 3),
            "last_error": self.last_error,
        }


class Router:
    """Weighted balancer + failover over a fixed replica list (see module
    docstring).  Thread-safe: HTTP handler threads call :meth:`handle`
    while the poller refreshes health."""

    def __init__(
        self,
        replica_urls: list[str],
        *,
        poll_interval_s: float = 1.0,
        poll_timeout_s: float = 5.0,
        request_timeout_s: float = 600.0,
        connect_timeout_s: float = 5.0,
        prefill_threshold: int | None = None,
        suspect_after: int = 3,
        probe_backoff_s: float = 1.0,
        probe_backoff_max_s: float = 30.0,
        prompt_mix_window: int = 256,
        clock=time.monotonic,
        telemetry=None,
    ):
        if not replica_urls:
            raise ValueError("router needs at least one replica URL")
        self.replicas = [
            ReplicaState(self._canonical(url)) for url in replica_urls
        ]
        self.poll_interval_s = poll_interval_s
        self.poll_timeout_s = poll_timeout_s
        #: ``request_timeout_s`` bounds only the RESPONSE (a generation may
        #: legitimately run minutes); ``connect_timeout_s`` bounds the TCP
        #: connect, so a network-blackholed replica costs seconds before
        #: failover, not the whole request budget.
        self.request_timeout_s = request_timeout_s
        self.connect_timeout_s = connect_timeout_s
        #: Two-tier scheduling: prompts of at least this many
        #: tokens prefill on a prefill-role replica (``/kv/export``) and
        #: decode on the least-loaded decode-role replica
        #: (``/kv/import``), so decode ticks never pay a prompt-sized
        #: stall.  Shorter prompts bypass straight to decode-capable
        #: replicas.  None disables (single-tier routing) — as does a
        #: fleet with no available prefill-role replica (the threshold
        #: degrades to normal balancing, never to an error).
        self.prefill_threshold = prefill_threshold
        #: Suspect quarantine: consecutive connect failures
        #: before a replica is suspected, and the probe backoff that
        #: replaces the regular poll while it is (doubles per failed
        #: probe, capped).
        self.suspect_after = max(int(suspect_after), 1)
        self.probe_backoff_s = probe_backoff_s
        self.probe_backoff_max_s = probe_backoff_max_s
        self.suspected_total = 0
        self.probes_total = 0
        self.recoveries_total = 0
        #: Live prompt-mix window: recent prompt token counts,
        #: so the fleet controller can retune --prefill-threshold to the
        #: traffic actually arriving instead of a provisioning-time guess.
        self._prompt_mix: collections.deque = collections.deque(
            maxlen=max(int(prompt_mix_window), 1)
        )
        self.threshold_updates = 0
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._rr = 0  # round-robin tiebreak cursor
        self.requests_routed = 0
        self.requests_retried = 0
        self.requests_failed = 0
        #: 4xx pass-throughs: the CALLER's error, served correctly by the
        #: fleet — counted separately so client mistakes never burn the
        #: availability SLO's error budget (requests_failed stays what its
        #: help text says: requests no replica could serve).
        self.requests_client_errors = 0
        #: Session-affinity accounting: requests that carried a session
        #: key, and how many were SERVED by their sticky replica (a miss
        #: means the sticky home was draining/dead and the weighted
        #: fallback answered — its prefix blocks start cold there).
        self.session_requests = 0
        self.affinity_hits = 0
        #: Two-tier accounting: requests served via the prefill->decode
        #: migration path (export + import both landed).
        self.requests_migrated = 0
        #: Optional Telemetry: the router's OWN trace stream — pick/hop/
        #: request spans per proxied request (`route
        #: --metrics-jsonl`).  Emission is direct (no nesting stack):
        #: handler threads interleave, like serving/server._span.
        self._telemetry = telemetry
        #: Always-on decision ring (telemetry/flightrecorder.py): every
        #: pick/hop/request outcome the span path already computes is teed
        #: in, sink or no sink — `incident` sweeps it over
        #: GET /debug/flightrecorder next to the replicas' rings.
        self.flightrecorder = FlightRecorder("route", clock=clock)
        self._thread: threading.Thread | None = None
        self._running = False

    def _span(self, name: str, dur: float, trace_id: str, **attrs) -> None:
        """Emit one router-phase span tagged with the request's trace id.
        Spans carry absolute ``time_unix`` start stamps so cross-stream
        assembly (router + replica JSONLs) can order hops on one axis."""
        # Tee into the decision ring BEFORE the sink guard: hop outcomes
        # must be sweepable from a router run without --metrics-jsonl.
        self.flightrecorder.record(
            name,
            request_id=trace_id,
            dur_s=round(max(float(dur), 0.0), 6),
            **{k: v for k, v in attrs.items() if v is not None},
        )
        if self._telemetry is None:
            return
        dur = max(float(dur), 0.0)
        self._telemetry.emit(
            {
                "kind": "span",
                "name": name,
                "path": f"router/{name}",
                "t": round(max(self._telemetry.now() - dur, 0.0), 6),
                "dur_s": round(dur, 6),
                "request_id": trace_id,
                "time_unix": round(time.time() - dur, 6),
                **{k: v for k, v in attrs.items() if v is not None},
            }
        )

    @staticmethod
    def _canonical(url: str) -> str:
        return url if "://" in url else f"http://{url}"

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Router":
        if self._thread is not None:
            return self
        self.poll_once()  # routing before the first poll would be blind
        self._running = True
        self._thread = threading.Thread(
            target=self._poll_loop, name="router-poller", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _poll_loop(self) -> None:
        while self._running:
            time.sleep(self.poll_interval_s)
            if self._running:
                self.poll_once()

    # -------------------------------------------------------------- health

    def poll_once(self) -> None:
        """Refresh every replica's health from its ``/statusz``.  Replicas
        are polled CONCURRENTLY: one blackholed host must cost one poll
        timeout, not delay the whole fleet's health refresh by N of them.

        SUSPECT replicas (>= ``suspect_after`` consecutive connect
        failures) are skipped until their exponential-backoff probe
        deadline passes — a dead host costs one connect timeout per
        probe window, not one per poll interval."""
        now = self._clock()
        due = []
        with self._lock:
            for replica in self.replicas:
                if replica.suspect:
                    if (
                        replica.next_probe_t is not None
                        and now < replica.next_probe_t
                    ):
                        continue
                    self.probes_total += 1
                due.append(replica)
        threads = [
            threading.Thread(
                target=self._poll_replica, args=(replica,), daemon=True
            )
            for replica in due
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=self.poll_timeout_s + 1.0)

    def _poll_replica(self, replica: ReplicaState) -> None:
        try:
            with urllib.request.urlopen(
                f"{replica.url}/statusz", timeout=self.poll_timeout_s
            ) as resp:
                page = json.loads(resp.read())
        except (OSError, ValueError) as exc:
            self._mark_down(replica, f"poll failed: {exc}")
            return
        kvpool = page.get("kvpool") or {}
        with self._lock:
            replica.healthy = bool(page.get("worker_alive", True))
            replica.draining = bool(page.get("draining", False))
            replica.role = str(page.get("role") or "both")
            replica.queue_depth = int(page.get("queue_depth") or 0)
            replica.slots = int(page.get("slots") or 0)
            replica.active_slots = int(page.get("active_slots") or 0)
            replica.kv_blocks_free = kvpool.get("kv_blocks_free")
            replica.kv_blocks_total = kvpool.get("kv_blocks_total")
            replica.consecutive_failures = 0
            if replica.suspect:
                # Recovery: a successful probe clears the quarantine and
                # the replica rejoins routing on the next pick.
                replica.suspect = False
                replica.next_probe_t = None
                replica.probe_backoff_s = 0.0
                self.recoveries_total += 1
                self.flightrecorder.record(
                    "suspect_cleared", replica=replica.url
                )
            replica.last_poll_t = self._clock()
            errors = page.get("last_errors") or []
            replica.last_error = (
                errors[-1].get("error")
                if errors and isinstance(errors[-1], dict)
                else None
            )

    def _mark_down(self, replica: ReplicaState, error: str) -> None:
        with self._lock:
            replica.healthy = False
            replica.consecutive_failures += 1
            replica.last_error = error
            replica.last_poll_t = self._clock()
            if replica.consecutive_failures < self.suspect_after:
                return
            # Quarantine: enough consecutive connect failures
            # that live requests must stop paying the connect timeout.
            # Each failed probe doubles the next probe's deadline, capped.
            if not replica.suspect:
                replica.suspect = True
                replica.probe_backoff_s = self.probe_backoff_s
                self.suspected_total += 1
                self.flightrecorder.record(
                    "suspect_marked", replica=replica.url,
                    failures=replica.consecutive_failures,
                )
            else:
                replica.probe_backoff_s = min(
                    replica.probe_backoff_s * 2.0, self.probe_backoff_max_s
                )
            replica.next_probe_t = self._clock() + replica.probe_backoff_s

    # -------------------------------------------------------------- routing

    def pick_order(
        self,
        session: str | None = None,
        *,
        sticky: ReplicaState | None = None,
        pool: str = "generate",
    ) -> list[ReplicaState]:
        """Available replicas, best weight first; round-robin rotation
        breaks exact ties so equal replicas share load evenly.

        ``pool`` partitions the fleet by role: ``"generate"``
        (default) is every decode-capable replica — prefill-role replicas
        never take a whole generation; ``"prefill"`` the DEDICATED
        chunk-machine tier (role ``prefill`` only: a ``both`` replica may
        be dense or already loaded with decode work, and a failed export
        there would bounce as a client error — the single-tier fallback
        already covers it); ``"decode"`` the graft-accepting tier
        (decode + both).

        A ``session`` key prepends its STICKY replica (stable hash over the
        fixed fleet list, so stickiness survives health flaps of OTHER
        replicas) when it is available — multi-turn traffic lands where its
        radix prefix blocks live; the weighted order remains the failover
        tail, so a draining/dead sticky home degrades to normal balancing
        rather than an error.  A caller that already resolved the sticky
        home passes it as ``sticky`` (skips the re-hash)."""
        roles = {
            "generate": ("decode", "both"),
            "decode": ("decode", "both"),
            "prefill": ("prefill",),
        }[pool]
        with self._lock:
            avail = [
                r for r in self.replicas
                if r.available and r.role in roles
            ]
            self._rr += 1
            rotation = self._rr
        rotated = avail[rotation % len(avail):] + avail[: rotation % len(avail)] if avail else []
        order = sorted(rotated, key=lambda r: -r.weight())
        if sticky is None and session is not None:
            sticky = self.sticky_replica(session)
        if sticky is not None and sticky in order:
            order.remove(sticky)
            order.insert(0, sticky)
        return order

    def _has_prefill_tier(self) -> bool:
        with self._lock:
            return any(
                r.available and r.role == "prefill" for r in self.replicas
            )

    def sticky_replica(self, session: str) -> ReplicaState:
        """The session's affinity home: a stable hash into the FIXED
        replica list (never the currently-available subset — availability
        churn elsewhere must not reshuffle every session)."""
        digest = zlib.crc32(str(session).encode("utf-8"))
        return self.replicas[digest % len(self.replicas)]

    def _post(
        self,
        replica: ReplicaState,
        path: str,
        body: bytes,
        trace_id: str | None = None,
        content_type: str = "application/json",
    ):
        """POST ``path`` with a short CONNECT timeout and the full
        request timeout only on the response.  Returns ``(phase, value,
        timing)``: ``("response", (status, ctype, data_bytes))`` on an
        HTTP answer, ``("connect", exc)`` when the replica was
        unreachable (safe to fail over), ``("slow", exc)`` when an
        ESTABLISHED request timed out (the generation is still running —
        replaying would duplicate it), ``("read", exc)`` when the
        connection died mid-request (replica killed — replay is safe,
        the work died with it).  ``timing`` carries ``connect_s`` and
        ``ttfb_s`` (send -> response headers; for these blocking
        endpoints the first byte arrives when the replica finishes, so
        hop ttfb ~= the replica's whole request) for the hop span.  The
        trace id is forwarded as ``X-Request-Id`` so the replica adopts
        it."""
        parts = urlsplit(replica.url)
        timing: dict = {"connect_s": None, "ttfb_s": None}
        conn = http.client.HTTPConnection(
            parts.hostname, parts.port, timeout=self.connect_timeout_s
        )
        try:
            t0 = self._clock()
            try:
                conn.connect()
            except OSError as exc:
                return "connect", exc, timing
            timing["connect_s"] = round(self._clock() - t0, 6)
            conn.sock.settimeout(self.request_timeout_s)
            headers = {"Content-Type": content_type}
            if trace_id is not None:
                headers["X-Request-Id"] = trace_id
            try:
                t_send = self._clock()
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                timing["ttfb_s"] = round(self._clock() - t_send, 6)
                data = resp.read()
            except TimeoutError as exc:  # socket.timeout on the read side
                return "slow", exc, timing
            except (OSError, http.client.HTTPException) as exc:
                return "read", exc, timing
            ctype = (resp.getheader("Content-Type") or "").split(";")[0]
            return "response", (resp.status, ctype, data), timing
        finally:
            conn.close()

    def _post_generate(
        self, replica: ReplicaState, body: bytes, trace_id: str | None = None
    ):
        """:meth:`_post` to /generate with the response parsed as JSON —
        the single-tier proxy hop."""
        phase, value, timing = self._post(replica, "/generate", body, trace_id)
        if phase != "response":
            return phase, value, timing
        status, _ctype, data = value
        try:
            payload = json.loads(data)
            if not isinstance(payload, dict):
                raise ValueError
        except ValueError:
            payload = {"error": data.decode("utf-8", "replace")[:200]}
        return "response", (status, payload), timing

    def handle_generate(
        self, body: bytes, trace_id: str | None = None
    ) -> tuple[int, dict]:
        """Proxy one generate request with failover: try replicas in
        weight order (the request's sticky session replica first, when it
        has one and it is available); connection failures, mid-request
        deaths, and 503s (draining replica, full queue) re-queue the
        request on the next-best replica.

        ``trace_id`` is the request's fleet-wide identity (an inbound
        ``X-Request-Id``; minted here when absent): forwarded to every
        attempted replica, stamped on the router's own spans, and
        guaranteed present in the returned payload's ``request_id`` so
        even an all-replicas-down 503 is traceable."""
        if trace_id is None:
            trace_id = uuid.uuid4().hex
        t_request = self._clock()
        route: dict = {"hops": 0, "replica": None}
        code, payload = self._route_generate(body, trace_id, route)
        payload.setdefault("request_id", trace_id)
        self._span(
            "request", self._clock() - t_request, trace_id,
            status=code, hops=route["hops"], replica=route["replica"],
        )
        return code, payload

    @staticmethod
    def _prompt_tokens(parsed: dict) -> int:
        """Approximate prompt length for the two-tier threshold:
        ``prompt_ids`` counts exactly; a text ``prompt`` is estimated at
        ~4 chars/token (the router has no tokenizer — the threshold is a
        scheduling heuristic, not a contract)."""
        ids = parsed.get("prompt_ids")
        if isinstance(ids, list):
            return len(ids)
        prompt = parsed.get("prompt")
        if isinstance(prompt, str):
            return -(-len(prompt) // 4)
        return 0

    def _route_generate(
        self, body: bytes, trace_id: str, route: dict
    ) -> tuple[int, dict]:
        session = None
        # The body is parsed once for everything the router reads out of
        # it: the sticky session key, the two-tier threshold's prompt
        # length, and the live prompt-mix window the fleet controller
        # retunes the threshold from (the mix must be observed
        # even while the threshold is unarmed, or the controller has no
        # evidence to arm it with).
        parsed = None
        if body:
            try:
                parsed = json.loads(body)
                if isinstance(parsed, dict):
                    session = parsed.get("session")
                else:
                    parsed = None
            except ValueError:
                pass  # the replica will 400 it; routing just goes unsticky
        if parsed is not None:
            n_prompt = self._prompt_tokens(parsed)
            if n_prompt > 0:
                with self._lock:
                    self._prompt_mix.append(n_prompt)
        # Two-tier dispatch: a long prompt with a live prefill
        # tier prefills there and decodes on the least-loaded decode
        # node; everything else (short prompts, no prefill tier, no
        # threshold) takes the single-tier path below.
        if (
            self.prefill_threshold is not None
            and parsed is not None
            and self._prompt_tokens(parsed) >= self.prefill_threshold
            and self._has_prefill_tier()
        ):
            return self._route_disagg(body, trace_id, route, session)
        return self._route_single(body, trace_id, route, session)

    def _route_single(
        self, body: bytes, trace_id: str, route: dict, session
    ) -> tuple[int, dict]:
        """Single-tier proxying with failover (the pre-disaggregation
        path): weighted order over decode-capable replicas, the sticky
        session home first."""
        sticky = (
            self.sticky_replica(session) if session is not None else None
        )
        if session is not None:
            with self._lock:
                self.session_requests += 1
        t_pick = self._clock()
        order = self.pick_order(session, sticky=sticky)
        self._span(
            "pick", self._clock() - t_pick, trace_id,
            n_available=len(order), sticky=bool(sticky is not None),
        )
        if not order:
            with self._lock:
                self.requests_failed += 1
            return 503, {"error": "no available replica"}
        last_error = "no available replica"
        for i, replica in enumerate(order):
            if i > 0:
                with self._lock:
                    self.requests_retried += 1
                    order[i - 1].retried_away += 1
            # Accumulate, don't assign: a request that burned prefill-tier
            # hops before falling back here keeps them on its span.
            route["hops"] += 1
            t_hop = self._clock()
            phase, value, timing = self._post_generate(
                replica, body, trace_id
            )
            hop_dur = self._clock() - t_hop

            def hop_span(outcome, status=None):
                # One span per ATTEMPTED replica — a failover request's
                # trace shows every hop it burned, not just the winner.
                self._span(
                    "hop", hop_dur, trace_id, replica=replica.url,
                    hop=i, outcome=outcome, status=status,
                    connect_s=timing["connect_s"], ttfb_s=timing["ttfb_s"],
                )

            if phase == "response":
                status, payload = value
                if status == 200:
                    hop_span("ok", status=200)
                    route["replica"] = replica.url
                    with self._lock:
                        replica.routed += 1
                        self.requests_routed += 1
                        if sticky is not None and replica is sticky:
                            self.affinity_hits += 1
                    payload["replica"] = replica.url
                    return 200, payload
                detail = str(payload.get("error", ""))
                hop_span("backpressure" if status == 503 else "client_error",
                         status=status)
                if status == 503:
                    # Draining or backpressured: route around it.  A
                    # drain 503 means the replica is going away — flag it
                    # so new picks skip it before the next poll lands.
                    if "drain" in detail:
                        with self._lock:
                            replica.draining = True
                    last_error = f"{replica.url}: 503 {detail}"
                    continue
                # 4xx is the CALLER's error: no other replica will judge
                # it differently, so fail it through without retrying —
                # and without charging the fleet's failure counter (a
                # malformed-request storm must not page an availability
                # SLO the fleet is actually meeting).
                with self._lock:
                    self.requests_client_errors += 1
                return status, {"error": detail or f"HTTP {status}"}
            if phase == "slow":
                # The replica ACCEPTED the request and is still working:
                # it is not dead, and replaying elsewhere would run the
                # same generation twice fleet-wide.  Fail THIS request
                # through as a gateway timeout; routing state untouched.
                hop_span("slow")
                with self._lock:
                    self.requests_failed += 1
                return 504, {
                    "error": f"{replica.url} did not answer within "
                    f"{self.request_timeout_s}s (generation still "
                    "running; not replayed)"
                }
            # "connect" (unreachable) or "read" (died mid-request): the
            # replica is gone and so is any in-flight work — mark it down
            # and replay the request elsewhere.
            hop_span(f"{phase}_failed")
            self._mark_down(replica, f"{phase} failed: {value}")
            last_error = f"{replica.url}: {value}"
        with self._lock:
            self.requests_failed += 1
        return 503, {"error": f"all replicas unavailable (last: {last_error})"}

    def _route_disagg(
        self, body: bytes, trace_id: str, route: dict, session
    ) -> tuple[int, dict]:
        """The two-tier path: ``/kv/export`` on the best prefill replica
        (failover across the prefill pool), then ``/kv/import`` of the
        returned payload on the least-loaded decode replica (failover
        across the decode pool — an import replay is safe: the dead
        replica's graft died with it).  A JSON 200 from /kv/export means
        the first token already finished the request — returned as-is.
        When every prefill attempt fails, the request falls back to the
        single-tier path rather than failing (decode-capable replicas can
        always serve it whole)."""
        payload = None
        for i, replica in enumerate(self.pick_order(pool="prefill")):
            route["hops"] += 1
            t_hop = self._clock()
            phase, value, timing = self._post(
                replica, "/kv/export", body, trace_id
            )
            hop_dur = self._clock() - t_hop

            def hop_span(outcome, status=None, replica=replica,
                         timing=timing, hop_dur=hop_dur, i=i):
                self._span(
                    "hop", hop_dur, trace_id, replica=replica.url,
                    hop=i, outcome=outcome, status=status, tier="prefill",
                    connect_s=timing["connect_s"], ttfb_s=timing["ttfb_s"],
                )

            if phase == "response":
                status, ctype, data = value
                if status == 200 and ctype == "application/octet-stream":
                    hop_span("exported", status=200)
                    payload = data
                    break
                if status == 200:
                    # Finished at the first token: a complete JSON result.
                    hop_span("ok", status=200)
                    try:
                        out = json.loads(data)
                    except ValueError:
                        out = {"error": "bad replica response"}
                    route["replica"] = replica.url
                    with self._lock:
                        replica.routed += 1
                        self.requests_routed += 1
                    out["replica"] = replica.url
                    return 200, out
                hop_span(
                    "backpressure" if status == 503 else "client_error",
                    status=status,
                )
                if status == 503:
                    if b"drain" in data:
                        with self._lock:
                            replica.draining = True
                    continue
                with self._lock:
                    self.requests_client_errors += 1
                detail = data.decode("utf-8", "replace")[:200]
                return status, {"error": detail or f"HTTP {status}"}
            if phase == "slow":
                hop_span("slow")
                with self._lock:
                    self.requests_failed += 1
                return 504, {
                    "error": f"{replica.url} did not answer within "
                    f"{self.request_timeout_s}s (prefill still running; "
                    "not replayed)"
                }
            hop_span(f"{phase}_failed")
            self._mark_down(replica, f"{phase} failed: {value}")
        if payload is None:
            # No prefill tier could take it: serve whole on the decode
            # pool (strictly better than failing the request).
            return self._route_single(body, trace_id, route, session)

        # Decode tier: graft the payload, weighted least-loaded first
        # (sticky session home tried first — the migrated prefix seeds
        # its radix cache there).
        if session is not None:
            with self._lock:
                self.session_requests += 1
        last_error = "no available decode replica"
        order = self.pick_order(session, pool="decode")
        for i, replica in enumerate(order):
            route["hops"] += 1
            t_hop = self._clock()
            phase, value, timing = self._post(
                replica, "/kv/import", payload, trace_id,
                content_type="application/octet-stream",
            )
            hop_dur = self._clock() - t_hop

            def hop_span(outcome, status=None, replica=replica,
                         timing=timing, hop_dur=hop_dur, i=i):
                self._span(
                    "hop", hop_dur, trace_id, replica=replica.url,
                    hop=i, outcome=outcome, status=status, tier="decode",
                    connect_s=timing["connect_s"], ttfb_s=timing["ttfb_s"],
                )

            if phase == "response":
                status, _ctype, data = value
                try:
                    out = json.loads(data)
                    if not isinstance(out, dict):
                        raise ValueError
                except ValueError:
                    out = {"error": data.decode("utf-8", "replace")[:200]}
                if status == 200:
                    hop_span("ok", status=200)
                    route["replica"] = replica.url
                    with self._lock:
                        replica.routed += 1
                        self.requests_routed += 1
                        self.requests_migrated += 1
                        if session is not None and replica is self.sticky_replica(session):
                            self.affinity_hits += 1
                    out["replica"] = replica.url
                    return 200, out
                detail = str(out.get("error", ""))
                hop_span(
                    "backpressure" if status == 503 else "client_error",
                    status=status,
                )
                if status == 503:
                    if "drain" in detail:
                        with self._lock:
                            replica.draining = True
                    last_error = f"{replica.url}: 503 {detail}"
                    continue
                with self._lock:
                    self.requests_client_errors += 1
                return status, {"error": detail or f"HTTP {status}"}
            if phase == "slow":
                hop_span("slow")
                with self._lock:
                    self.requests_failed += 1
                return 504, {
                    "error": f"{replica.url} did not answer within "
                    f"{self.request_timeout_s}s (decode still running; "
                    "not replayed)"
                }
            # connect/read failure: the graft died with the replica —
            # replaying the payload elsewhere is safe and deterministic.
            hop_span(f"{phase}_failed")
            self._mark_down(replica, f"{phase} failed: {value}")
            last_error = f"{replica.url}: {value}"
        with self._lock:
            self.requests_failed += 1
        return 503, {
            "error": f"no decode replica could graft (last: {last_error})"
        }

    # ------------------------------------------------------------- surface

    def set_prefill_threshold(self, threshold: int | None) -> int | None:
        """Retune the two-tier split at runtime (``POST /admin/threshold``
        — the fleet controller's tier-retuning actuator).  ``None``
        disables two-tier routing; returns the new value."""
        if threshold is not None:
            threshold = int(threshold)
            if threshold < 1:
                raise ValueError("prefill_threshold must be >= 1 (or null)")
        with self._lock:
            old = self.prefill_threshold
            self.prefill_threshold = threshold
            self.threshold_updates += 1
        self.flightrecorder.record(
            "threshold_set", old=old, new=threshold
        )
        return threshold

    def prompt_mix_summary(self) -> dict:
        """Percentile summary of the recent prompt-length window — the
        evidence the controller's tier-retuning rule reads."""
        with self._lock:
            window = sorted(self._prompt_mix)
            threshold = self.prefill_threshold
        if not window:
            return {"count": 0}
        n = len(window)

        def pct(p: float) -> int:
            return window[min(int(p * (n - 1) + 0.5), n - 1)]

        return {
            "count": n,
            "mean": round(sum(window) / n, 1),
            "p25": pct(0.25),
            "p50": pct(0.50),
            "p75": pct(0.75),
            "p90": pct(0.90),
            "max": window[-1],
            "long_frac": (
                round(sum(1 for x in window if x >= threshold) / n, 4)
                if threshold is not None else None
            ),
        }

    def statusz(self) -> dict:
        with self._lock:
            replicas = [r.snapshot() for r in self.replicas]
            routed, retried, failed = (
                self.requests_routed,
                self.requests_retried,
                self.requests_failed,
            )
            client_errors = self.requests_client_errors
            sessions, hits = self.session_requests, self.affinity_hits
            migrated = self.requests_migrated
            suspected, probes, recoveries = (
                self.suspected_total, self.probes_total,
                self.recoveries_total,
            )
            threshold_updates = self.threshold_updates
        return {
            "uptime_s": round(self._clock() - self._t0, 3),
            "replicas": replicas,
            "available": sum(1 for r in replicas if r["available"]),
            "prefill_threshold": self.prefill_threshold,
            "prompt_mix": self.prompt_mix_summary(),
            "threshold_updates": threshold_updates,
            # Suspect quarantine: lifetime mark/probe/recover
            # counters plus the live count of quarantined replicas.
            "suspect": sum(1 for r in replicas if r["suspect"]),
            "suspected_total": suspected,
            "probes_total": probes,
            "recoveries_total": recoveries,
            "requests_routed": routed,
            "requests_retried": retried,
            "requests_failed": failed,
            "requests_client_errors": client_errors,
            # Two-tier scheduling: requests served through the
            # prefill->migrate->decode path.
            "requests_migrated": migrated,
            # Session affinity (sticky routing): how much multi-turn
            # traffic actually landed on its prefix-block home.
            "session_requests": sessions,
            "affinity_hits": hits,
            "affinity_hit_rate": (
                round(hits / sessions, 6) if sessions else None
            ),
            "flightrecorder": self.flightrecorder.stats(),
        }

    def blackbox_dump(self, trigger: str, force: bool = False) -> dict | None:
        """Flush the router's decision ring as a ``kind="blackbox"`` record
        with the fleet table attached; emitted to the telemetry stream when
        a sink is attached, always retained for the /debug endpoints."""
        with self._lock:
            context = {
                "replicas": [r.snapshot() for r in self.replicas],
                "requests_routed": self.requests_routed,
                "requests_retried": self.requests_retried,
                "requests_failed": self.requests_failed,
            }
        dump = self.flightrecorder.blackbox(
            trigger, context=context, force=force
        )
        if dump is not None and self._telemetry is not None:
            self._telemetry.emit(dump)
        return dump

    def prometheus_metrics(self, prefix: str = "bpe_tpu_router") -> str:
        with self._lock:
            replicas = [r.snapshot() for r in self.replicas]
            routed, retried, failed = (
                self.requests_routed,
                self.requests_retried,
                self.requests_failed,
            )
            client_errors = self.requests_client_errors
            sessions, hits = self.session_requests, self.affinity_hits
            migrated = self.requests_migrated
        # serving/metrics.py is torch-free at import: the router can share
        # the exposition formatter without touching an accelerator runtime.
        from bpe_transformer_tpu_torch.serving.metrics import emit_prometheus

        lines: list = []

        def emit(name, kind, help_text, samples):
            emit_prometheus(lines, prefix, name, kind, help_text, samples)

        emit("requests_routed_total", "counter",
             "Requests successfully proxied to a replica.", [({}, routed)])
        emit("requests_retried_total", "counter",
             "Requests replayed on another replica after a failure/503.",
             [({}, retried)])
        emit("requests_failed_total", "counter",
             "Requests no replica could serve (4xx pass-throughs "
             "excluded — see requests_client_errors_total).",
             [({}, failed)])
        emit("requests_client_errors_total", "counter",
             "4xx responses passed through (caller's error; not an "
             "availability failure).",
             [({}, client_errors)])
        emit("session_requests_total", "counter",
             "Requests that carried a session key (sticky routing).",
             [({}, sessions)])
        emit("affinity_hits_total", "counter",
             "Session requests served by their sticky replica.",
             [({}, hits)])
        emit("requests_migrated_total", "counter",
             "Requests served via the two-tier prefill->decode KV "
             "migration path.", [({}, migrated)])
        emit("replica_healthy", "gauge", "Replica reachable and worker alive.",
             [({"replica": r["url"]}, int(r["healthy"])) for r in replicas])
        emit("replica_role", "gauge",
             "Disaggregated-fleet role per replica (1 for the labeled "
             "role).",
             [({"replica": r["url"], "role": r["role"]}, 1)
              for r in replicas])
        emit("replica_draining", "gauge", "Replica draining (rolling restart).",
             [({"replica": r["url"]}, int(r["draining"])) for r in replicas])
        emit("replica_suspect", "gauge",
             "Replica quarantined after consecutive connect failures "
             "(probed on exponential backoff).",
             [({"replica": r["url"]}, int(r["suspect"])) for r in replicas])
        emit("replicas_suspected_total", "counter",
             "Replicas marked suspect over the router's lifetime.",
             [({}, self.suspected_total)])
        emit("suspect_probes_total", "counter",
             "Backoff probes sent to suspect replicas.",
             [({}, self.probes_total)])
        emit("suspect_recoveries_total", "counter",
             "Suspect replicas cleared by a successful probe.",
             [({}, self.recoveries_total)])
        emit("replica_weight", "gauge", "Free-capacity routing weight.",
             [({"replica": r["url"]}, r["weight"]) for r in replicas])
        emit("replica_routed_total", "counter", "Requests routed per replica.",
             [({"replica": r["url"]}, r["routed"]) for r in replicas])
        return "\n".join(lines) + "\n"


def make_router_http_server(
    router: Router, host: str = "127.0.0.1", port: int = 8100
):
    """A `ThreadingHTTPServer` front for the router: ``POST /generate``
    (proxied with failover), ``GET /statusz`` (fleet table), ``GET
    /metrics`` (Prometheus), ``GET /healthz``, plus the forensics pair —
    ``GET /debug/flightrecorder`` (the live decision ring) and ``POST
    /debug/dump`` (force a black-box flush).  ``port=0`` binds an
    ephemeral port; the caller owns ``serve_forever()``/``shutdown()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # noqa: D102
            pass

        def _reply(
            self, code: int, payload: dict, request_id: str | None = None
        ) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            if request_id is not None:
                # Echoed on EVERY proxied response — the all-replicas-down
                # 503 and the not-replayed 504 read-timeout included — so
                # a client-side failure report carries the id that finds
                # the request in the router/replica trace streams.
                self.send_header("X-Request-Id", request_id)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                page = router.statusz()
                return self._reply(
                    200, {"ok": page["available"] > 0, **page}
                )
            if path == "/statusz":
                return self._reply(200, router.statusz())
            if path == "/metrics":
                body = router.prometheus_metrics().encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if path == "/debug/flightrecorder":
                return self._reply(200, router.flightrecorder.debug_page())
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802 (stdlib API)
            if self.path == "/debug/dump":
                dump = router.blackbox_dump("manual", force=True)
                return self._reply(200, dump)
            if self.path == "/admin/threshold":
                # Runtime tier retuning: the fleet controller
                # adjusts the two-tier split to the live prompt mix.
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    new = router.set_prefill_threshold(
                        body.get("prefill_threshold")
                    )
                except (ValueError, TypeError) as exc:
                    return self._reply(400, {"error": str(exc)})
                return self._reply(200, {"prefill_threshold": new})
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            trace_id = (self.headers.get("X-Request-Id") or "").strip()
            trace_id = trace_id[:128] or uuid.uuid4().hex
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) or b"{}"
            code, payload = router.handle_generate(body, trace_id=trace_id)
            return self._reply(code, payload, request_id=trace_id)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: list[str] | None = None) -> int:
    """``route`` entry point (torch-free)."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli route",
        description="Health-aware HTTP router over serve replicas "
        "(torch-free).",
    )
    parser.add_argument("--replica", action="append", required=True,
                        metavar="HOST:PORT",
                        help="replica base URL (repeatable)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8100,
                        help="router HTTP port (0: ephemeral)")
    parser.add_argument("--poll-interval", type=float, default=1.0,
                        help="seconds between replica health polls")
    parser.add_argument("--request-timeout", type=float, default=600.0,
                        help="seconds to wait for a replica's RESPONSE "
                        "(generations may run long; a timeout is NOT "
                        "replayed — the work is still running)")
    parser.add_argument("--connect-timeout", type=float, default=5.0,
                        help="seconds to wait for a replica's TCP connect "
                        "(failover to the next replica after)")
    parser.add_argument("--prefill-threshold", type=int, default=None,
                        metavar="TOKENS",
                        help="two-tier disaggregated scheduling: prompts "
                        "of >= TOKENS prefill on a --role prefill replica "
                        "(/kv/export) and decode on the least-loaded "
                        "decode replica (/kv/import); shorter prompts "
                        "bypass straight to decode nodes (default: "
                        "single-tier routing); retunable at runtime via "
                        "POST /admin/threshold")
    parser.add_argument("--suspect-after", type=int, default=3,
                        metavar="N",
                        help="consecutive connect failures before a "
                        "replica is quarantined as suspect and probed on "
                        "exponential backoff instead of every poll")
    parser.add_argument("--metrics-jsonl", default=None,
                        help="write the router's trace stream (pick/hop/"
                        "request spans per proxied request, manifest + "
                        "footer) to this JSONL; one trace_id joins it to "
                        "the replicas' streams")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    from bpe_transformer_tpu_torch.telemetry.manifest import host_manifest
    from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger
    from bpe_transformer_tpu_torch.telemetry.spans import Telemetry

    logger = MetricsLogger(jsonl_path=args.metrics_jsonl)
    telemetry = Telemetry(sink=logger.log) if args.metrics_jsonl else None
    if telemetry is not None:
        # host_manifest, not run_manifest: the router must never touch a
        # CUDA context as a side effect of writing its stream header.
        telemetry.emit(host_manifest("route"))

    router = Router(
        args.replica,
        poll_interval_s=args.poll_interval,
        request_timeout_s=args.request_timeout,
        connect_timeout_s=args.connect_timeout,
        prefill_threshold=args.prefill_threshold,
        suspect_after=args.suspect_after,
        telemetry=telemetry,
    )
    server = make_router_http_server(router, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    try:
        with router:
            available = sum(1 for r in router.replicas if r.available)
            print(
                f"routing on http://{host}:{port} over {len(router.replicas)} "
                f"replicas ({available} available; POST /generate, GET /healthz "
                "/metrics /statusz; Ctrl-C stops)",
                flush=True,
            )
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.shutdown()
                server.server_close()
    finally:
        if telemetry is not None:
            telemetry.footer(
                clean=True, requests=router.requests_routed,
                failed=router.requests_failed,
            )
        logger.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
