"""Self-healing fleet control plane: sense -> decide -> act (the port's
copy of ``bpe_transformer_tpu/serving/controller.py``).

The fleet's senses are the aggregator (`fleet`: SLO burn rates,
edge-triggered alerts); its muscles are KV migration (`/kv/export` ->
`/kv/import`, drain evacuation, two-tier routing).  This module closes the
loop: a **torch-free** controller (`control`) polls the
aggregator's ``/statusz`` (and the router's) and ACTS:

* **hot rebalancing** — when one replica's queue/KV-headroom burn
  diverges from the fleet (session-affinity skew is a known source), it
  picks victim sessions on the hot replica and moves them to the coldest
  peer over the wire (``POST /admin/evacuate`` -> the replica's
  ``/kv/export`` -> peer ``/kv/import`` relay path);
* **tier retuning** — it watches the router's live prompt-mix window and
  adjusts the two-tier ``prefill_threshold`` split to the traffic
  actually arriving (``POST /admin/threshold``);
* **elastic capacity** — on SUSTAINED ``queue_growth`` /
  ``block_exhaustion`` alerts it spawns a replica from a pre-declared
  slot list through the supervisor machinery (crash-respawn with
  backoff); a long-quiet fleet retires the newest spawned
  replica with SIGTERM (the replica's graceful drain evacuates its
  sessions when started with ``--evacuate-to``).

A controller that acts wrongly is worse than no controller, so every
action is wrapped in real robustness machinery:

* **per-action timeout + exponential backoff + bounded retries** — an
  actuator endpoint that hangs costs ``action_timeout_s``, not the loop;
* **action-budget crash-loop breaker** (:class:`ActionBudget`, after the
  training loop's ``RollbackBudget``) — ``max_consecutive_failures`` failed
  actions without one success trips the breaker and the controller
  HALTS (observe-only until restarted), because a flapping controller
  amplifies the incident it is supposed to absorb;
* **hysteresis/cooldown per (rule, target)** — an edge-triggered alert
  or a noisy gauge cannot thrash the same replica twice inside
  ``cooldown_s``;
* **graceful degradation to observe-only** — stale fleet evidence (the
  aggregator's record is older than ``evidence_max_age_s``), an
  unreachable aggregator, or a partially-failed peer sweep each emit a
  ``kind="control"`` record saying why and hold the affected rules
  rather than acting on a wrong picture of the fleet.

Elastic capacity composes with the router's FIXED replica list via the
suspect quarantine: declare every potential slot to ``route`` /
``fleet`` up front — un-spawned slots sit quarantined at
near-zero poll cost, and a spawned replica rejoins on its first
successful probe.

Deliberately stdlib-only and importable without torch — it runs on the
same front-end box as the router and aggregator.
"""

from __future__ import annotations

import collections
import json
import shlex
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from bpe_transformer_tpu_torch.telemetry.flightrecorder import FlightRecorder

__all__ = [
    "ActionBudget",
    "ReplicaSpawner",
    "FleetController",
    "make_control_http_server",
    "main",
]


class ActionBudget:
    """Crash-loop breaker for control actions (the ``RollbackBudget``
    idiom): failures are only forgiven by real progress — here, a
    SUCCESSFUL action.  ``max_consecutive_failures`` failures in a row
    trip the breaker; a tripped controller stops acting (observe-only)
    until a human restarts it, because auto-untripping would just
    re-arm the flapping it exists to stop."""

    def __init__(self, max_consecutive_failures: int = 5):
        if max_consecutive_failures < 1:
            raise ValueError(
                "max_consecutive_failures must be >= 1, got "
                f"{max_consecutive_failures}"
            )
        self.max_consecutive_failures = max_consecutive_failures
        self.total_failures = 0
        self.consecutive = 0
        self.tripped = False

    def note(self, ok: bool) -> None:
        if ok:
            self.consecutive = 0
            return
        self.total_failures += 1
        self.consecutive += 1
        if self.consecutive >= self.max_consecutive_failures:
            self.tripped = True

    @property
    def state(self) -> str:
        return "tripped" if self.tripped else "closed"


class ReplicaSpawner:
    """Spawn/retire serve replicas from a pre-declared slot list, each
    child supervised as a supervisor does: a crash respawns it with exponential
    backoff until ``max_restarts`` consecutive failures, a retire
    SIGTERM stops it gracefully (the serve CLI drains — and evacuates,
    with ``--evacuate-to`` — before exiting).

    ``slots`` is ``[(url, argv), ...]``: the replica's base URL (as the
    router/fleet know it) and the command that serves it.  Slots start
    idle; ``spawn()`` starts the next idle one, ``retire()`` stops the
    most recently spawned.  Torch-free: children own any accelerator.
    """

    def __init__(
        self,
        slots: list[tuple[str, list[str]]],
        *,
        max_restarts: int = 3,
        backoff_s: float = 0.5,
        backoff_max_s: float = 30.0,
        log=print,
        sleep=time.sleep,
    ):
        self._slots = [
            {"url": url.rstrip("/"), "argv": list(argv), "proc": None,
             "thread": None, "retiring": False, "restarts": 0}
            for url, argv in slots
        ]
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self._log = log
        self._sleep = sleep
        self._lock = threading.Lock()

    def active(self) -> list[str]:
        with self._lock:
            return [
                s["url"] for s in self._slots
                if s["proc"] is not None and not s["retiring"]
            ]

    def idle(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s["proc"] is None)

    def spawn(self) -> str | None:
        """Start the next idle slot under supervision; returns its URL,
        or None when every slot is already live."""
        with self._lock:
            slot = next(
                (s for s in self._slots if s["proc"] is None), None
            )
            if slot is None:
                return None
            slot["retiring"] = False
            slot["restarts"] = 0
            slot["proc"] = subprocess.Popen(slot["argv"])
            slot["thread"] = threading.Thread(
                target=self._supervise, args=(slot,),
                name=f"spawn-{slot['url']}", daemon=True,
            )
            slot["thread"].start()
            self._log(f"controller: spawned replica {slot['url']}")
            return slot["url"]

    def _supervise(self, slot: dict) -> None:
        # The supervisor loop (resilience/supervisor.py, serving flavor):
        # a clean exit or a retire ends supervision; a crash respawns
        # with exponential backoff until the restart budget is spent.
        from bpe_transformer_tpu_torch.resilience.supervisor import _describe_exit

        while True:
            proc = slot["proc"]
            rc = proc.wait()
            with self._lock:
                if slot["retiring"] or rc == 0:
                    slot["proc"] = None
                    slot["retiring"] = False
                    return
                slot["restarts"] += 1
                restarts = slot["restarts"]
                if restarts > self.max_restarts:
                    self._log(
                        f"controller: giving up on {slot['url']} — "
                        f"{_describe_exit(rc)}, {restarts} consecutive "
                        f"failures (max_restarts={self.max_restarts})"
                    )
                    slot["proc"] = None
                    return
            delay = min(
                self.backoff_s * (2 ** (restarts - 1)), self.backoff_max_s
            )
            self._log(
                f"controller: replica {slot['url']} {_describe_exit(rc)}; "
                f"respawning in {delay:.1f}s "
                f"({restarts}/{self.max_restarts})"
            )
            self._sleep(delay)
            with self._lock:
                if slot["retiring"]:
                    slot["proc"] = None
                    slot["retiring"] = False
                    return
                slot["proc"] = subprocess.Popen(slot["argv"])

    def retire(self, url: str | None = None) -> str | None:
        """SIGTERM the given (default: most recently spawned) live
        replica — its serve process drains gracefully; returns the URL
        retired, or None when nothing is live."""
        with self._lock:
            live = [
                s for s in self._slots
                if s["proc"] is not None and not s["retiring"]
            ]
            if url is not None:
                live = [s for s in live if s["url"] == url.rstrip("/")]
            if not live:
                return None
            slot = live[-1]
            slot["retiring"] = True
            slot["proc"].terminate()
            self._log(f"controller: retiring replica {slot['url']}")
            return slot["url"]

    def stop_all(self, timeout_s: float = 30.0) -> None:
        with self._lock:
            live = [s for s in self._slots if s["proc"] is not None]
            for slot in live:
                slot["retiring"] = True
                try:
                    slot["proc"].terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + timeout_s
        for slot in live:
            proc = slot["proc"]
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "url": s["url"],
                    "live": s["proc"] is not None and not s["retiring"],
                    "retiring": s["retiring"],
                    "restarts": s["restarts"],
                }
                for s in self._slots
            ]


class FleetController:
    """The closed loop.  One decision thread polls evidence and acts;
    HTTP handler threads read snapshots — same thread model as the
    router and aggregator.  ``run_once()`` is one sense->decide->act
    tick returning the ``kind="control"`` records it emitted (tests
    drive it directly; ``decide()`` is pure over gathered evidence)."""

    #: Decision rules, in priority order.
    RULES = ("rebalance", "retune", "scale_up", "scale_down")

    def __init__(
        self,
        fleet_url: str,
        *,
        router_url: str | None = None,
        spawner: ReplicaSpawner | None = None,
        poll_interval_s: float = 2.0,
        poll_timeout_s: float = 5.0,
        evidence_max_age_s: float = 10.0,
        cooldown_s: float = 30.0,
        action_timeout_s: float = 30.0,
        action_retries: int = 3,
        action_backoff_s: float = 0.5,
        max_consecutive_failures: int = 5,
        rebalance_min_gap: int = 3,
        rebalance_headroom_frac: float = 0.15,
        rebalance_batch: int = 1,
        retune_min_samples: int = 16,
        retune_margin: float = 0.25,
        scale_sustain_s: float = 10.0,
        scale_down_idle_s: float = 120.0,
        observe_only: bool = False,
        telemetry=None,
        clock=time.monotonic,
        wall_clock=time.time,
        sleep=time.sleep,
    ):
        self.fleet_url = self._canonical(fleet_url)
        self.router_url = (
            self._canonical(router_url) if router_url else None
        )
        self.spawner = spawner
        self.poll_interval_s = poll_interval_s
        self.poll_timeout_s = poll_timeout_s
        self.evidence_max_age_s = evidence_max_age_s
        self.cooldown_s = cooldown_s
        self.action_timeout_s = action_timeout_s
        self.action_retries = max(int(action_retries), 1)
        self.action_backoff_s = action_backoff_s
        self.rebalance_min_gap = rebalance_min_gap
        self.rebalance_headroom_frac = rebalance_headroom_frac
        self.rebalance_batch = rebalance_batch
        self.retune_min_samples = retune_min_samples
        self.retune_margin = retune_margin
        self.scale_sustain_s = scale_sustain_s
        self.scale_down_idle_s = scale_down_idle_s
        self.observe_only = observe_only
        self.budget = ActionBudget(max_consecutive_failures)
        self._telemetry = telemetry
        self._clock = clock
        self._wall = wall_clock
        self._sleep = sleep
        self._t0 = clock()
        self._lock = threading.Lock()
        #: (action, target) -> clock deadline before the pair may refire.
        self._cooldowns: dict[tuple[str, str], float] = {}
        #: Edge-triggering for hold records: the reason currently held
        #: on, so an hour of staleness is one record, not 1800.
        self._hold_reason: str | None = None
        #: Last clock time the fleet had work (scale-down idle timer).
        self._last_busy_t = clock()
        self.ticks = 0
        self.actions_ok = 0
        self.actions_failed = 0
        self.holds = 0
        self.cooldown_skips = 0
        self._recent: collections.deque = collections.deque(maxlen=256)
        self.flightrecorder = FlightRecorder("control", clock=clock)
        self._thread: threading.Thread | None = None
        self._running = False

    @staticmethod
    def _canonical(url: str) -> str:
        url = url if "://" in url else f"http://{url}"
        return url.rstrip("/")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FleetController":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="control-loop", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.spawner is not None:
            self.spawner.stop_all()

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        while self._running:
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 — the loop must survive
                self._emit(self._record(
                    "hold", outcome="failed",
                    reason=f"tick crashed: {exc}",
                ))
                self.budget.note(False)
            time.sleep(self.poll_interval_s)

    # --------------------------------------------------------------- sense

    def _get_json(self, url: str) -> dict:
        with urllib.request.urlopen(
            url, timeout=self.poll_timeout_s
        ) as resp:
            return json.loads(resp.read())

    def _post_json(self, url: str, body: dict, timeout_s: float) -> dict:
        req = urllib.request.Request(
            url,
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())

    def gather(self) -> dict:
        """One evidence sweep: the aggregator's fleet surface plus (when
        configured) the router's.  Never raises — missing pieces are
        recorded so :meth:`decide` can hold the rules that need them."""
        ev: dict = {"fleet": None, "router": None, "errors": {}}
        try:
            ev["fleet"] = self._get_json(f"{self.fleet_url}/statusz")
        except (OSError, ValueError) as exc:
            ev["errors"]["fleet"] = str(exc)
        if self.router_url:
            try:
                ev["router"] = self._get_json(f"{self.router_url}/statusz")
            except (OSError, ValueError) as exc:
                ev["errors"]["router"] = str(exc)
        return ev

    def _staleness(self, ev: dict) -> str | None:
        """Why the fleet evidence cannot be acted on, or None when it
        can.  Decisions ride on the aggregator's LAST sweep; a wedged or
        dead aggregator must freeze the controller's hands, not its
        picture of a fleet that has since moved on."""
        if ev.get("fleet") is None:
            return f"fleet_unreachable: {ev['errors'].get('fleet')}"
        record = ev["fleet"].get("fleet")
        if not record:
            return "stale_evidence: aggregator has no fleet record yet"
        age = self._wall() - float(record.get("time_unix") or 0)
        if age > self.evidence_max_age_s:
            return (
                f"stale_evidence: fleet record is {age:.1f}s old "
                f"(max {self.evidence_max_age_s:.1f}s)"
            )
        return None

    @staticmethod
    def _partial_sweep(ev: dict) -> bool:
        """True when the aggregator's last sweep failed against SOME
        replica (an unreachable-but-declared host): the load picture is
        incomplete, so load-comparing rules (rebalance) must hold —
        while alert-driven scaling still acts (a dead replica is exactly
        when capacity is needed)."""
        per_replica = (ev.get("fleet") or {}).get("replicas") or []
        return any(
            not snap.get("online") and snap.get("error")
            for snap in per_replica
        )

    # -------------------------------------------------------------- decide

    def decide(self, ev: dict) -> list[dict]:
        """Pure decision pass over gathered evidence: the actions the
        rules WANT, best-first, before cooldown/budget/observe-only
        gating.  Each decision: ``{"action", "target", "reason",
        "params"}``."""
        out: list[dict] = []
        fleet_page = ev.get("fleet") or {}
        record = fleet_page.get("fleet") or {}
        per_replica = fleet_page.get("replicas") or []
        partial = self._partial_sweep(ev)

        # --- rebalance: hot/cold divergence across decode-capable,
        # paged, online replicas.
        candidates = [
            snap for snap in per_replica
            if snap.get("online") and not snap.get("draining")
            and snap.get("role") in ("decode", "both")
            and snap.get("slots")
        ]

        def load(snap):
            return (snap.get("queue_depth") or 0) + (
                snap.get("active_slots") or 0
            )

        def headroom(snap):
            total = snap.get("kv_blocks_total")
            if not total:
                return 1.0
            return (snap.get("kv_blocks_free") or 0) / total

        if len(candidates) >= 2:
            hot = max(candidates, key=load)
            cold = min(
                candidates, key=lambda s: (load(s), -headroom(s))
            )
            gap = load(hot) - load(cold)
            starved = (
                headroom(hot) < self.rebalance_headroom_frac
                and headroom(cold) >= 2 * self.rebalance_headroom_frac
            )
            if (
                hot is not cold
                and (hot.get("active_slots") or 0) >= 1
                and (cold.get("active_slots") or 0) < (cold.get("slots") or 0)
                and (gap >= self.rebalance_min_gap or starved)
            ):
                reason = (
                    f"kv headroom {headroom(hot):.2f} < "
                    f"{self.rebalance_headroom_frac:.2f} on {hot['url']}"
                    if starved else
                    f"load {load(hot)} on {hot['url']} vs {load(cold)} "
                    f"on {cold['url']} (gap >= {self.rebalance_min_gap})"
                )
                decision = {
                    "action": "rebalance",
                    "target": hot["url"],
                    "reason": reason,
                    "params": {
                        "to": cold["url"],
                        "max_sessions": self.rebalance_batch,
                    },
                }
                if partial:
                    # Incomplete load picture: the "cold" peer may just
                    # be the one the sweep could not see.
                    decision["hold"] = "partial_sweep"
                out.append(decision)

        # --- retune: router prompt-mix window vs the live threshold.
        router_page = ev.get("router")
        if router_page is not None:
            mix = router_page.get("prompt_mix") or {}
            has_prefill_tier = any(
                r.get("role") == "prefill" and r.get("available")
                for r in router_page.get("replicas") or []
            )
            if (
                has_prefill_tier
                and (mix.get("count") or 0) >= self.retune_min_samples
            ):
                # Top-quartile prompts take the two-tier path: long
                # enough that a prefill stall would hurt decode p99,
                # common enough to keep the prefill tier busy.
                desired = max(int(mix["p75"]), 2)
                current = router_page.get("prefill_threshold")
                moved_enough = current is None or abs(
                    desired - current
                ) > max(self.retune_margin * current, 1)
                if moved_enough and desired != current:
                    out.append({
                        "action": "retune",
                        "target": "router",
                        "reason": (
                            f"prompt mix p75={mix['p75']} "
                            f"(n={mix['count']}) vs threshold {current}"
                        ),
                        "params": {
                            "prefill_threshold": desired, "old": current
                        },
                    })

        # --- elastic capacity: sustained pressure alerts spawn, a
        # long-idle fleet retires (controller-spawned replicas only).
        if self.spawner is not None:
            t_now = float(record.get("t") or 0)
            sustained = [
                a for a in fleet_page.get("alerts") or []
                if a.get("rule") in ("queue_growth", "block_exhaustion")
                and t_now - float(a.get("since_t") or t_now)
                >= self.scale_sustain_s
            ]
            if sustained and self.spawner.idle() > 0:
                rules = ",".join(sorted(a["rule"] for a in sustained))
                out.append({
                    "action": "scale_up",
                    "target": "fleet",
                    "reason": f"sustained alerts: {rules} "
                    f">= {self.scale_sustain_s:.0f}s",
                    "params": {"alerts": rules},
                })
            busy = (
                (record.get("queue_depth") or 0) > 0
                or (record.get("active_slots") or 0) > 0
                or bool(fleet_page.get("alerts"))
            )
            now = self._clock()
            if busy:
                self._last_busy_t = now
            elif (
                self.spawner.active()
                and now - self._last_busy_t >= self.scale_down_idle_s
            ):
                out.append({
                    "action": "scale_down",
                    "target": self.spawner.active()[-1],
                    "reason": (
                        f"fleet idle {now - self._last_busy_t:.0f}s "
                        f">= {self.scale_down_idle_s:.0f}s"
                    ),
                    "params": {},
                })
        return out

    # ----------------------------------------------------------------- act

    def _execute(self, decision: dict) -> dict:
        """One decision -> the actuator call, with per-attempt timeout
        and exponential backoff over bounded retries.  Returns
        ``{"ok", "attempts", "detail"}``."""
        action = decision["action"]
        last = ""
        for attempt in range(self.action_retries):
            if attempt:
                self._sleep(self.action_backoff_s * (2 ** (attempt - 1)))
            try:
                if action == "rebalance":
                    out = self._post_json(
                        f"{decision['target']}/admin/evacuate",
                        {
                            "target": decision["params"]["to"],
                            "max_sessions": decision["params"][
                                "max_sessions"
                            ],
                            "timeout_s": self.action_timeout_s,
                        },
                        self.action_timeout_s + 5.0,
                    )
                    return {
                        "ok": True, "attempts": attempt + 1,
                        "detail": out,
                    }
                if action == "retune":
                    out = self._post_json(
                        f"{self.router_url}/admin/threshold",
                        {
                            "prefill_threshold": decision["params"][
                                "prefill_threshold"
                            ]
                        },
                        self.action_timeout_s,
                    )
                    return {
                        "ok": True, "attempts": attempt + 1,
                        "detail": out,
                    }
                if action == "scale_up":
                    url = self.spawner.spawn()
                    return {
                        "ok": url is not None, "attempts": attempt + 1,
                        "detail": {"url": url}
                        if url else "no idle replica slot",
                    }
                if action == "scale_down":
                    url = self.spawner.retire(decision["target"])
                    return {
                        "ok": url is not None, "attempts": attempt + 1,
                        "detail": {"url": url}
                        if url else "no live spawned replica",
                    }
                return {
                    "ok": False, "attempts": attempt + 1,
                    "detail": f"unknown action {action!r}",
                }
            except urllib.error.HTTPError as exc:
                # A 4xx is a semantic refusal (bad target, not paged):
                # retrying the same body cannot succeed.
                last = f"HTTP {exc.code}: {exc.read()[:200]!r}"
                if 400 <= exc.code < 500:
                    break
            except (OSError, ValueError) as exc:
                last = str(exc)
        return {"ok": False, "attempts": self.action_retries, "detail": last}

    # ---------------------------------------------------------------- tick

    def _record(self, action: str, **fields) -> dict:
        return {
            "kind": "control",
            "t": round(self._clock() - self._t0, 6),
            "time_unix": round(self._wall(), 3),
            "action": action,
            "breaker": self.budget.state,
            "consecutive_failures": self.budget.consecutive,
            **fields,
        }

    def _emit(self, record: dict) -> dict:
        self._recent.append(record)
        self.flightrecorder.record(
            f"control_{record['action']}",
            outcome=record.get("outcome"),
            target=record.get("target"),
            reason=record.get("reason"),
        )
        if self._telemetry is not None:
            self._telemetry.emit(record)
        return record

    def run_once(self) -> list[dict]:
        """One sense->decide->act tick; returns the control records it
        emitted (possibly none — a quiet healthy fleet is silent)."""
        with self._lock:
            self.ticks += 1
        emitted: list[dict] = []

        def hold(reason: str) -> list[dict]:
            # Edge-triggered: one record per hold episode, not per tick.
            with self._lock:
                self.holds += 1
                first = self._hold_reason != reason.split(":")[0]
                self._hold_reason = reason.split(":")[0]
            if first:
                emitted.append(self._emit(self._record(
                    "hold", outcome="held", reason=reason,
                )))
            return emitted

        if self.budget.tripped:
            return hold(
                "breaker_tripped: "
                f"{self.budget.consecutive} consecutive action failures"
            )
        ev = self.gather()
        stale = self._staleness(ev)
        if stale is not None:
            return hold(stale)
        with self._lock:
            self._hold_reason = None

        now = self._clock()
        for decision in self.decide(ev):
            key = (decision["action"], decision["target"])
            with self._lock:
                cooling = self._cooldowns.get(key, 0.0) > now
                if cooling:
                    self.cooldown_skips += 1
            if cooling:
                continue
            if decision.get("hold"):
                # The rule wanted to act but its evidence is partial:
                # observe-only, and still cool down (the next complete
                # sweep re-decides from scratch).
                with self._lock:
                    self._cooldowns[key] = now + self.cooldown_s
                emitted.append(self._emit(self._record(
                    decision["action"], outcome="observe_only",
                    target=decision["target"], reason=decision["reason"],
                    held_because=decision["hold"],
                    params=decision["params"],
                )))
                continue
            if self.observe_only:
                with self._lock:
                    self._cooldowns[key] = now + self.cooldown_s
                emitted.append(self._emit(self._record(
                    decision["action"], outcome="observe_only",
                    target=decision["target"], reason=decision["reason"],
                    params=decision["params"],
                )))
                continue
            t_act = self._clock()
            result = self._execute(decision)
            self.budget.note(result["ok"])
            with self._lock:
                self._cooldowns[key] = self._clock() + self.cooldown_s
                if result["ok"]:
                    self.actions_ok += 1
                else:
                    self.actions_failed += 1
            emitted.append(self._emit(self._record(
                decision["action"],
                outcome="ok" if result["ok"] else "failed",
                target=decision["target"], reason=decision["reason"],
                params=decision["params"],
                attempts=result["attempts"],
                dur_s=round(self._clock() - t_act, 6),
                detail=result["detail"],
            )))
            if self.budget.tripped:
                emitted.append(self._emit(self._record(
                    "hold", outcome="held",
                    reason="breaker_tripped: "
                    f"{self.budget.consecutive} consecutive action "
                    "failures — controller halting",
                )))
                with self._lock:
                    self._hold_reason = "breaker_tripped"
                break
        return emitted

    # ------------------------------------------------------------- surface

    def statusz(self) -> dict:
        with self._lock:
            recent = list(self._recent)[-32:]
            cooldowns = {
                f"{action}@{target}": round(deadline - self._clock(), 1)
                for (action, target), deadline in self._cooldowns.items()
                if deadline > self._clock()
            }
            stats = {
                "ticks": self.ticks,
                "actions_ok": self.actions_ok,
                "actions_failed": self.actions_failed,
                "holds": self.holds,
                "cooldown_skips": self.cooldown_skips,
                "hold_reason": self._hold_reason,
            }
        return {
            "uptime_s": round(self._clock() - self._t0, 3),
            "fleet_url": self.fleet_url,
            "router_url": self.router_url,
            "observe_only": self.observe_only,
            "breaker": self.budget.state,
            "consecutive_failures": self.budget.consecutive,
            "total_failures": self.budget.total_failures,
            **stats,
            "cooldowns": cooldowns,
            "spawner": (
                self.spawner.snapshot() if self.spawner else None
            ),
            "recent": recent,
            "flightrecorder": self.flightrecorder.stats(),
        }


def make_control_http_server(
    controller: FleetController, host: str = "127.0.0.1", port: int = 8300
):
    """``GET /statusz`` (loop state: breaker, cooldowns, recent actions),
    ``GET /healthz`` (ok = breaker closed), ``GET /debug/flightrecorder``
    (the decision ring, sweepable by ``incident``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                page = controller.statusz()
                return self._reply(
                    200, {"ok": page["breaker"] == "closed", **page}
                )
            if path == "/statusz":
                return self._reply(200, controller.statusz())
            if path == "/debug/flightrecorder":
                return self._reply(
                    200, controller.flightrecorder.debug_page()
                )
            return self._reply(404, {"error": "unknown path"})

    return ThreadingHTTPServer((host, port), Handler)


def parse_spawn_slot(spec: str) -> tuple[str, list[str]]:
    """``--spawn 'URL=CMD ...'`` -> ``(url, argv)``; the command is
    shell-split (no shell runs it)."""
    url, sep, cmd = spec.partition("=")
    if not sep or not url.strip() or not cmd.strip():
        raise ValueError(
            f"--spawn wants 'URL=CMD ...', got {spec!r}"
        )
    return url.strip(), shlex.split(cmd)


def main(argv: list[str] | None = None) -> int:
    """``control`` entry point (torch-free)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli control",
        description="Self-healing fleet control loop over the "
        "fleet aggregator (torch-free): hot rebalancing, tier retuning, "
        "elastic capacity.",
    )
    parser.add_argument("--fleet", required=True, metavar="HOST:PORT",
                        help="fleet aggregator base URL (fleet)")
    parser.add_argument("--router", default=None, metavar="HOST:PORT",
                        help="router base URL (enables tier retuning)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8300,
                        help="controller HTTP port (0: ephemeral)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="seconds between control ticks")
    parser.add_argument("--evidence-max-age", type=float, default=10.0,
                        help="hold (observe-only) when the aggregator's "
                        "fleet record is older than this")
    parser.add_argument("--cooldown", type=float, default=30.0,
                        help="per-(action, target) hysteresis window")
    parser.add_argument("--action-timeout", type=float, default=30.0,
                        help="per-attempt actuator timeout")
    parser.add_argument("--action-retries", type=int, default=3,
                        help="bounded retries per action (exponential "
                        "backoff between attempts)")
    parser.add_argument("--max-failures", type=int, default=5,
                        help="consecutive action failures before the "
                        "crash-loop breaker trips (controller halts)")
    parser.add_argument("--rebalance-gap", type=int, default=3,
                        help="queue+slots load gap between hottest and "
                        "coldest replica that triggers a rebalance")
    parser.add_argument("--scale-sustain", type=float, default=10.0,
                        help="seconds a queue_growth/block_exhaustion "
                        "alert must persist before scaling up")
    parser.add_argument("--scale-down-idle", type=float, default=120.0,
                        help="seconds of fleet idleness before retiring "
                        "a controller-spawned replica")
    parser.add_argument("--spawn", action="append", default=[],
                        metavar="URL=CMD",
                        help="declarable replica slot for elastic "
                        "capacity: base URL + the command that serves "
                        "it (repeatable; also declare URL to the "
                        "router/fleet)")
    parser.add_argument("--observe-only", action="store_true",
                        help="decide and record, never act")
    parser.add_argument("--once", action="store_true",
                        help="one control tick, print its records, exit")
    parser.add_argument("--metrics-jsonl", default=None,
                        help="write kind=control records (manifest + "
                        "footer) to this JSONL")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    try:
        slots = [parse_spawn_slot(spec) for spec in args.spawn]
    except ValueError as exc:
        print(f"control: {exc}", file=sys.stderr)
        return 2

    from bpe_transformer_tpu_torch.telemetry.manifest import host_manifest
    from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger
    from bpe_transformer_tpu_torch.telemetry.spans import Telemetry

    logger = MetricsLogger(jsonl_path=args.metrics_jsonl)
    telemetry = Telemetry(sink=logger.log) if args.metrics_jsonl else None
    if telemetry is not None:
        telemetry.emit(host_manifest("control"))

    spawner = ReplicaSpawner(slots) if slots else None
    controller = FleetController(
        args.fleet,
        router_url=args.router,
        spawner=spawner,
        poll_interval_s=args.interval,
        evidence_max_age_s=args.evidence_max_age,
        cooldown_s=args.cooldown,
        action_timeout_s=args.action_timeout,
        action_retries=args.action_retries,
        max_consecutive_failures=args.max_failures,
        rebalance_min_gap=args.rebalance_gap,
        scale_sustain_s=args.scale_sustain,
        scale_down_idle_s=args.scale_down_idle,
        observe_only=args.observe_only,
        telemetry=telemetry,
    )
    try:
        if args.once:
            for record in controller.run_once():
                print(json.dumps(record))
            return 0
        server = make_control_http_server(
            controller, host=args.host, port=args.port
        )
        host, port = server.server_address[:2]
        with controller:
            print(
                f"controlling on http://{host}:{port} (fleet "
                f"{args.fleet}"
                + (f", router {args.router}" if args.router else "")
                + (f", {len(slots)} spawn slot(s)" if slots else "")
                + ("; OBSERVE-ONLY" if args.observe_only else "")
                + "; GET /statusz /healthz; Ctrl-C stops)",
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
            telemetry.footer(
                clean=controller.budget.state == "closed",
                actions_ok=controller.actions_ok,
                actions_failed=controller.actions_failed,
            )
        logger.close()


if __name__ == "__main__":
    sys.exit(main())
