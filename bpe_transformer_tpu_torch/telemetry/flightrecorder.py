"""Flight recorder: always-on bounded ring of structured decision events.

The port's copy of ``bpe_transformer_tpu/telemetry/flightrecorder.py``.

Every control-plane component that makes scheduling decisions — the serving
engine (admit/park/reject/deadline/finish, migration, rewind, drain), the
prefill scheduler (budget deferrals), the router (per-hop outcomes), and the
training loop (rollback/preemption/watchdog transitions) — records them here
as plain host-side dicts.  The ring is the component's short-term memory:
alerts fire off instantaneous state, but *why* the state got there (which
admissions parked, which hops failed over, which slots migrated) is only in
this buffer.

Design constraints, in order:

- **jax-free** — the incident tool and report run on hosts with no
  accelerator runtime;
- **sync-free** — ``record()`` is append-only host bookkeeping; callers pass
  only values they already hold on the host (the fetch-count test
  pattern pins zero extra ``device_get``/``block_until_ready`` with
  recording enabled);
- **bounded** — a fixed-capacity deque evicts oldest-first (``dropped``
  counts evictions), and high-frequency events (tick summaries, spec
  rewinds) coalesce in place via ``coalesce=True`` so steady-state chatter
  cannot evict the rare decision events an incident needs;
- **lock-protected** — the serving worker thread, HTTP handler threads, and
  the alert path all touch the ring; one ``threading.Lock`` guards it.

On a trigger (alert firing, watchdog NaN/hang, SIGTERM epilogue, or
``POST /debug/dump``) the owner calls :meth:`blackbox` to flush a
``kind="blackbox"`` record — the ring contents plus whatever host-side
context the owner attaches (statusz snapshot, slot states, kvpool gauges,
alert history) — into the telemetry stream.  A cooldown de-duplicates dump
storms: one incident, one dump, unless forced.
"""

from __future__ import annotations

import collections
import threading
import time


class FlightRecorder:
    """Bounded, lock-protected ring buffer of decision events.

    >>> rec = FlightRecorder("serve", capacity=128)
    >>> rec.record("admit", request_id="r1", slot=0)
    >>> rec.record("tick", coalesce=True, active=4)   # repeats merge in place
    >>> dump = rec.blackbox("alert:block_exhaustion", context={"queue": 9})

    ``clock`` is the run-relative monotonic clock (injectable for tests);
    ``time_unix`` on every event is absolute wall clock so cross-host
    timelines can be merged by the incident tool.
    """

    def __init__(
        self,
        component: str,
        capacity: int = 256,
        clock=time.monotonic,
        dump_cooldown_s: float = 30.0,
        max_dumps: int = 4,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.component = component
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._dumps: collections.deque[dict] = collections.deque(maxlen=max_dumps)
        self._dump_cooldown_s = dump_cooldown_s
        self._last_dump_t: float | None = None
        self.recorded = 0
        self.dropped = 0

    # ------------------------------------------------------------------ ring

    def record(self, event: str, coalesce: bool = False, **fields) -> None:
        """Append one decision event (host-side bookkeeping only, no device
        syncs).  ``coalesce=True`` merges into the previous entry when it is
        the same event name: ``count`` increments and the fields/timestamps
        refresh in place, so per-tick chatter occupies one slot instead of
        flooding the ring."""
        t = round(self._clock() - self._t0, 6)
        entry = {
            "event": event,
            "t": t,
            "time_unix": round(time.time(), 6),
        }
        for key, value in fields.items():
            if value is not None:
                entry[key] = value
        with self._lock:
            if (
                coalesce
                and self._ring
                and self._ring[-1]["event"] == event
                and self._ring[-1].get("request_id")
                == entry.get("request_id")
            ):
                prev = self._ring[-1]
                entry["count"] = prev.get("count", 1) + 1
                entry["first_t"] = prev.get("first_t", prev["t"])
                self._ring[-1] = entry
                return
            self.recorded += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(entry)

    def try_record(self, event: str, **fields) -> bool:
        """Signal-handler-safe variant: never blocks on the lock (a handler
        interrupting a thread mid-``record`` must not deadlock on the
        non-reentrant lock).  Returns False when the lock was busy and the
        event was dropped."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            entry = {
                "event": event,
                "t": round(self._clock() - self._t0, 6),
                "time_unix": round(time.time(), 6),
            }
            entry.update({k: v for k, v in fields.items() if v is not None})
            self.recorded += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(entry)
            return True
        finally:
            self._lock.release()

    def snapshot(self) -> list[dict]:
        """Copies of the ring contents, oldest first."""
        with self._lock:
            return [dict(entry) for entry in self._ring]

    def stats(self) -> dict:
        with self._lock:
            return {
                "component": self.component,
                "capacity": self.capacity,
                "size": len(self._ring),
                "recorded": self.recorded,
                "dropped": self.dropped,
                "dumps": len(self._dumps),
            }

    # --------------------------------------------------------------- dumping

    def blackbox(
        self, trigger: str, context: dict | None = None, force: bool = False
    ) -> dict | None:
        """Flush the ring as a ``kind="blackbox"`` record, or None while the
        post-dump cooldown holds (one incident should produce one dump, not
        one per alert re-evaluation).  ``force=True`` bypasses the cooldown —
        explicit ``POST /debug/dump`` and terminal paths (preemption
        epilogue, non-finite abort) always dump."""
        now = self._clock()
        with self._lock:
            if (
                not force
                and self._last_dump_t is not None
                and now - self._last_dump_t < self._dump_cooldown_s
            ):
                return None
            self._last_dump_t = now
            events = [dict(entry) for entry in self._ring]
            recorded, dropped = self.recorded, self.dropped
        dump = {
            "kind": "blackbox",
            "t": round(now - self._t0, 6),
            "time_unix": round(time.time(), 6),
            "component": self.component,
            "trigger": trigger,
            "recorded": recorded,
            "dropped": dropped,
            "events": events,
        }
        if context:
            for key, value in context.items():
                if key not in dump:
                    dump[key] = value
        with self._lock:
            self._dumps.append(dump)
        return dump

    def dumps(self) -> list[dict]:
        """Copies of the retained dumps, oldest first (bounded deque)."""
        with self._lock:
            return [dict(d) for d in self._dumps]

    def debug_page(self) -> dict:
        """The ``GET /debug/flightrecorder`` payload: live ring + retained
        dumps + counters, all copies."""
        stats = self.stats()
        return {
            "component": self.component,
            "capacity": self.capacity,
            "recorded": stats["recorded"],
            "dropped": stats["dropped"],
            "events": self.snapshot(),
            "dumps": self.dumps(),
        }
