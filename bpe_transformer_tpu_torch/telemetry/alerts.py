"""Serving anomaly watchdog: rule-based detectors over engine/fleet gauges.

The port's copy of ``bpe_transformer_tpu/telemetry/alerts.py``.

Training has had a hung-step/NaN watchdog; serving had none —
an operator watching ``bpe-tpu monitor`` could SEE a queue ramp or a block
pool draining, but nothing said so out loud, and nothing said it in the
telemetry stream where ``report`` and CI look.  This module closes that
gap with deliberately boring, rule-based detectors (no learned baselines:
an alert an operator cannot re-derive from the gauges is an alert nobody
trusts):

* **queue growth** — admission queue depth grew monotonically across the
  whole detection window and ended above a floor: demand is outrunning
  the engine and latency is compounding;
* **block exhaustion** — the paged KV pool's free-block count is trending
  down; a least-squares slope over the window projects time-to-dry, and
  the rule fires while that projection is inside the horizon (or the pool
  is already dry) — the fleet router needs to shed load BEFORE admissions
  start parking;
* **accept-rate collapse** — speculative decoding's cumulative acceptance
  fell below a floor after enough proposals to mean it: the draft stopped
  earning its keep and every tick now pays propose+verify for ~1 token;
* **compile storm** — the process compile counter moved more than a warmed
  server ever should: a traffic shape found an un-warmed bucket ladder
  rung (or a restart lost the compile cache) and requests are eating
  multi-second compiles;
* **replica flapping** — a fleet replica's online/offline state toggled
  repeatedly inside the window: a crash loop or a lossy health path, not
  a clean restart.

``AlertEngine`` turns rule verdicts into EDGE-TRIGGERED ``kind="alert"``
records: one ``state="firing"`` record when a rule starts firing, one
``state="cleared"`` when it stops (with how long it was active), and
nothing while a condition merely persists — an hour-long incident is two
records, not 3600.  The currently-firing set is queryable (``active()``)
for ``/statusz``.

Jax-free and host-side by construction: the serving engine feeds it on
the engine-record cadence, the fleet aggregator (`telemetry/fleet.py`) on
its poll cadence, and the same rules run in both places over the same
gauge names.
"""

from __future__ import annotations

import collections
import threading

__all__ = [
    "AcceptRateCollapseRule",
    "AlertEngine",
    "AlertRule",
    "BlockExhaustionRule",
    "CompileStormRule",
    "QueueGrowthRule",
    "ReplicaFlapRule",
    "default_fleet_rules",
    "default_serving_rules",
]


class AlertRule:
    """One detector: ``check(sample, t)`` returns ``(verdict, attrs)``.

    ``verdict`` is True (firing), False (healthy), or None (this sample
    carries no data for the rule — keep whatever state it was in, so a
    dense replica's missing kv gauges never "clear" a fleet-level pool
    alert).  ``attrs`` are evidence fields merged into the alert record.
    """

    name = "rule"
    severity = "warn"

    def check(self, sample: dict, t: float):  # pragma: no cover - interface
        raise NotImplementedError

    def describe(self, attrs: dict) -> str:  # pragma: no cover - interface
        raise NotImplementedError


class QueueGrowthRule(AlertRule):
    """Sustained admission-queue growth: depth never shrank across the
    window, grew net, and ended at/above ``min_depth`` — demand is
    outrunning the engine (a momentary burst that drains does not fire)."""

    name = "queue_growth"
    severity = "page"

    def __init__(self, window: int = 4, min_depth: int = 4):
        self.window = max(2, int(window))
        self.min_depth = min_depth
        self._hist: collections.deque = collections.deque(maxlen=self.window)

    def check(self, sample, t):
        depth = sample.get("queue_depth")
        if depth is None:
            return None, {}
        self._hist.append(int(depth))
        if len(self._hist) < self.window:
            return False, {}
        h = list(self._hist)
        grew = all(b >= a for a, b in zip(h, h[1:])) and h[-1] > h[0]
        if not (grew and h[-1] >= self.min_depth):
            return False, {}
        return True, {"queue_depth": h[-1], "growth": h[-1] - h[0]}

    def describe(self, attrs):
        return (
            f"admission queue grew {attrs.get('growth', '?')} over the "
            f"window to {attrs.get('queue_depth', '?')} waiting requests"
        )


class BlockExhaustionRule(AlertRule):
    """KV block pool trending toward dry: a least-squares slope of
    ``kv_blocks_free`` over the window projects time-to-exhaustion; fires
    while the projection is inside ``horizon_s`` (or the pool is already
    dry), carrying ``projected_dry_s`` so the operator knows how long
    they have."""

    name = "block_exhaustion"
    severity = "page"

    def __init__(self, window: int = 4, horizon_s: float = 120.0):
        self.window = max(3, int(window))
        self.horizon_s = float(horizon_s)
        self._hist: collections.deque = collections.deque(maxlen=self.window)

    def check(self, sample, t):
        free = sample.get("kv_blocks_free")
        if free is None:
            return None, {}
        free = int(free)
        self._hist.append((float(t), free))
        if free == 0:
            return True, {"kv_blocks_free": 0, "projected_dry_s": 0.0}
        if len(self._hist) < self.window:
            return False, {}
        ts = [p[0] for p in self._hist]
        fs = [p[1] for p in self._hist]
        n = len(ts)
        t_mean = sum(ts) / n
        f_mean = sum(fs) / n
        var = sum((x - t_mean) ** 2 for x in ts)
        if var <= 0:
            return False, {}
        slope = sum(
            (x - t_mean) * (y - f_mean) for x, y in zip(ts, fs)
        ) / var  # blocks per second; negative = draining
        if slope >= 0:
            return False, {}
        dry_s = free / -slope
        if dry_s > self.horizon_s:
            return False, {}
        return True, {
            "kv_blocks_free": free,
            "projected_dry_s": round(dry_s, 1),
        }

    def describe(self, attrs):
        return (
            f"KV block pool draining: {attrs.get('kv_blocks_free', '?')} "
            f"blocks free, projected dry in "
            f"{attrs.get('projected_dry_s', '?')}s"
        )


class AcceptRateCollapseRule(AlertRule):
    """Speculative-decoding acceptance fell below a floor after enough
    proposed tokens for the rate to mean something — the draft has
    drifted off the target distribution (or K is mis-sized) and the spec
    tick is now pure overhead."""

    name = "accept_rate_collapse"
    severity = "warn"

    def __init__(self, threshold: float = 0.35, min_proposed: int = 64):
        self.threshold = float(threshold)
        self.min_proposed = int(min_proposed)

    def check(self, sample, t):
        rate = sample.get("spec_accept_rate")
        proposed = sample.get("spec_proposed")
        if rate is None or proposed is None:
            return None, {}
        if proposed < self.min_proposed or rate >= self.threshold:
            return False, {}
        return True, {
            "spec_accept_rate": round(float(rate), 4),
            "spec_proposed": int(proposed),
        }

    def describe(self, attrs):
        return (
            f"spec accept rate collapsed to {attrs.get('spec_accept_rate')}"
            f" over {attrs.get('spec_proposed')} proposed tokens "
            f"(floor {self.threshold})"
        )


class CompileStormRule(AlertRule):
    """The process-wide XLA compile counter moved more than a warmed
    server ever should within the window: some traffic shape is hitting
    cold programs (un-warmed bucket rung, lost compile cache) and those
    requests pay multi-second compiles instead of milliseconds."""

    name = "compile_storm"
    severity = "warn"

    def __init__(self, window: int = 6, min_compiles: int = 4):
        self.window = max(2, int(window))
        self.min_compiles = int(min_compiles)
        self._hist: collections.deque = collections.deque(maxlen=self.window)

    def check(self, sample, t):
        events = sample.get("compile_events")
        if events is None:
            return None, {}
        self._hist.append(int(events))
        if len(self._hist) < 2:
            return False, {}
        delta = self._hist[-1] - self._hist[0]
        if delta < self.min_compiles:
            return False, {}
        return True, {
            "compile_events": self._hist[-1],
            "compiles_in_window": delta,
        }

    def describe(self, attrs):
        return (
            f"compile storm: {attrs.get('compiles_in_window')} XLA "
            f"compiles inside the window (total "
            f"{attrs.get('compile_events')})"
        )


class ReplicaFlapRule(AlertRule):
    """A fleet replica's online state toggled >= ``max_transitions``
    times inside ``window_s``: a crash loop or a lossy health path — not
    the single down->up edge of a clean rolling restart."""

    name = "replica_flap"
    severity = "page"

    def __init__(self, window_s: float = 600.0, max_transitions: int = 3):
        self.window_s = float(window_s)
        self.max_transitions = int(max_transitions)
        self._last: dict[str, bool] = {}
        self._edges: dict[str, collections.deque] = {}

    def check(self, sample, t):
        online = sample.get("replica_online")
        if not isinstance(online, dict):
            return None, {}
        for url, up in online.items():
            up = bool(up)
            prev = self._last.get(url)
            if prev is not None and up != prev:
                self._edges.setdefault(url, collections.deque()).append(t)
            self._last[url] = up
        worst_url, worst_n = None, 0
        for url, edges in self._edges.items():
            while edges and t - edges[0] > self.window_s:
                edges.popleft()
            if len(edges) > worst_n:
                worst_url, worst_n = url, len(edges)
        if worst_n < self.max_transitions:
            return False, {}
        return True, {"replica": worst_url, "transitions": worst_n}

    def describe(self, attrs):
        return (
            f"replica {attrs.get('replica')} flapping: "
            f"{attrs.get('transitions')} online/offline transitions "
            f"inside {self.window_s:g}s"
        )


def default_serving_rules() -> list:
    """The per-replica watchdog ruleset the serving engine feeds on its
    engine-record cadence (flapping is a fleet-level concept and absent)."""
    return [
        QueueGrowthRule(),
        BlockExhaustionRule(),
        AcceptRateCollapseRule(),
        CompileStormRule(),
    ]


def default_fleet_rules() -> list:
    """The fleet-level ruleset (`telemetry/fleet.py` poll cadence): the
    same gauge rules over fleet sums, plus replica flap detection."""
    return [
        QueueGrowthRule(min_depth=8),
        BlockExhaustionRule(),
        AcceptRateCollapseRule(),
        ReplicaFlapRule(),
    ]


class AlertEngine:
    """Edge-triggered alert state machine over a rule list.

    ``feed(sample, t)`` runs every rule against one gauge sample and
    returns the TRANSITION records — ``state="firing"`` when a rule
    starts firing, ``state="cleared"`` (with ``active_s``) when it stops;
    a persisting condition produces nothing (its evidence attrs are
    refreshed in :meth:`active`).  The caller owns emission: the serving
    engine routes transitions into its telemetry stream, the fleet
    aggregator into its own.

    Thread-safe: the serving worker feeds while /statusz handler threads
    read ``active()`` — one lock covers the firing set, and ``active()``
    returns COPIES so a handler mid-``json.dumps`` never races a
    refresh.  (Rule ``check`` state is only ever touched under the lock
    too, so a single engine may be fed from one thread at a time plus
    read from many.)
    """

    def __init__(self, rules=None, history_limit: int = 64):
        self.rules = list(rules) if rules is not None else []
        self._firing: dict[str, dict] = {}
        self._history: collections.deque[dict] = collections.deque(
            maxlen=history_limit
        )
        self._lock = threading.Lock()

    def feed(self, sample: dict, t: float) -> list[dict]:
        out: list[dict] = []
        with self._lock:
            for rule in self.rules:
                verdict, attrs = rule.check(sample, t)
                if verdict is None:
                    continue
                live = self._firing.get(rule.name)
                if verdict and live is None:
                    message = rule.describe(attrs)
                    self._firing[rule.name] = {
                        "rule": rule.name,
                        "severity": rule.severity,
                        "since_t": round(float(t), 6),
                        "message": message,
                        **attrs,
                    }
                    out.append(
                        {
                            "kind": "alert",
                            "t": round(float(t), 6),
                            "rule": rule.name,
                            "state": "firing",
                            "severity": rule.severity,
                            "message": message,
                            **attrs,
                        }
                    )
                elif verdict and live is not None:
                    live.update(attrs)
                    live["message"] = rule.describe(attrs)
                elif not verdict and live is not None:
                    self._firing.pop(rule.name)
                    out.append(
                        {
                            "kind": "alert",
                            "t": round(float(t), 6),
                            "rule": rule.name,
                            "state": "cleared",
                            "severity": rule.severity,
                            "message": f"{rule.name} cleared",
                            "active_s": round(
                                float(t) - live["since_t"], 3
                            ),
                        }
                    )
            # Persist every edge into the bounded history so /statusz and
            # monitor can show the last N transitions after they clear —
            # active() alone forgets an incident the moment it ends.
            for transition in out:
                self._history.append(dict(transition))
        return out

    def active(self) -> list[dict]:
        """Currently-firing alerts (the ``/statusz`` view), oldest first."""
        with self._lock:
            return sorted(
                (dict(a) for a in self._firing.values()),
                key=lambda a: a["since_t"],
            )

    def history(self, n: int | None = None) -> list[dict]:
        """The last ``n`` firing/cleared transitions (all retained ones when
        ``n`` is None), oldest first, as copies."""
        with self._lock:
            items = list(self._history)
        if n is not None:
            items = items[-n:]
        return [dict(item) for item in items]
