"""FIFO admission queue for the serving engine: backpressure, deadlines,
cancellation, and max-wait prefill batching.

The port's own copy of ``bpe_transformer_tpu/serving/scheduler.py`` (the
two packages share no module).

The scheduler is deliberately transport- and model-agnostic: it queues
opaque items (the serving layer's request entries) with arrival metadata
and answers one question per engine-loop iteration — *which queued items
should be admitted right now?* — under three policies:

* **backpressure**: a full queue REJECTS new work (`QueueFullError`) instead
  of letting submissions pile up unboundedly or block the transport thread;
  callers surface it as HTTP 503 / an immediate error result;
* **deadlines**: an item whose deadline expires while still queued is never
  admitted — it is returned to the caller as expired so the request can be
  failed fast (admitting it would burn prefill+decode on an answer nobody
  is waiting for);
* **max-wait batching**: when the engine is fully idle, admission can hold
  back up to ``max_wait_s`` after the oldest arrival so several prefills
  batch into the same engine cycle — bounded added latency, better chip
  utilization under bursty arrivals.  With the engine already running,
  items are admitted immediately (decode ticks amortize them for free).

Thread-safe: transports submit/cancel from their own threads; the single
worker loop calls :meth:`pop_ready` / :meth:`wait_for_work`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable


class QueueFullError(RuntimeError):
    """The admission queue is at capacity — reject, don't hang."""


class PrefillBudget:
    """Per-tick prefill-token budget: the chunked-prefill fairness policy.

    With paged chunked prefill, the worker loop runs prefill CHUNKS and
    decode ticks from the same thread; without a budget a burst of long
    prompts would run chunk after chunk while every decoding request
    stalls — exactly the prefill/decode interference that blows decode
    p99.  The budget caps prefill tokens between consecutive decode
    ticks: the worker calls :meth:`start_tick` each loop iteration, asks
    :meth:`admits` before every chunk, and :meth:`spend`s what it ran.

    The FIRST chunk of an iteration is always admitted (a chunk larger
    than the whole budget must still make progress); ``tokens_per_tick
    = None`` disables the policy (prefills run to completion before the
    next tick, the dense engine's behavior).
    """

    def __init__(self, tokens_per_tick: int | None, recorder=None):
        if tokens_per_tick is not None and tokens_per_tick < 1:
            raise ValueError(
                f"tokens_per_tick must be >= 1 or None, got {tokens_per_tick}"
            )
        self.tokens_per_tick = tokens_per_tick
        #: Optional flight recorder (telemetry/flightrecorder.py): budget
        #: DENIALS are scheduling decisions worth forensics — a prefill
        #: chunk deferred to the next tick explains a decode-p99 spike.
        self._recorder = recorder
        self._spent = 0

    def start_tick(self) -> None:
        self._spent = 0

    def admits(self, chunk_tokens: int) -> bool:
        if self.tokens_per_tick is None or self._spent == 0:
            return True
        verdict = self._spent + chunk_tokens <= self.tokens_per_tick
        if not verdict and self._recorder is not None:
            # Coalesced: a long prompt defers every tick until it fits —
            # one ring entry with a count, not one per tick.
            self._recorder.record(
                "budget_defer",
                coalesce=True,
                chunk_tokens=chunk_tokens,
                spent=self._spent,
                tokens_per_tick=self.tokens_per_tick,
            )
        return verdict

    def spend(self, chunk_tokens: int) -> None:
        self._spent += chunk_tokens


@dataclass
class QueuedItem:
    """One queued request entry plus its arrival metadata."""

    item: Any
    request_id: str
    enqueued_at: float
    deadline_at: float | None = None
    cancelled: bool = False

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now >= self.deadline_at


@dataclass
class PopResult:
    """`pop_ready`'s verdict for one loop iteration."""

    admit: list[QueuedItem] = field(default_factory=list)
    expired: list[QueuedItem] = field(default_factory=list)
    cancelled: list[QueuedItem] = field(default_factory=list)


class FifoScheduler:
    """Bounded FIFO queue with deadline/cancellation pruning and max-wait
    batching (see module docstring)."""

    def __init__(
        self,
        max_queue: int = 64,
        max_wait_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.max_wait_s = max_wait_s
        self._clock = clock
        self._q: deque[QueuedItem] = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)

    # ------------------------------------------------------- transport side

    def submit(
        self,
        item: Any,
        *,
        request_id: str,
        deadline_s: float | None = None,
    ) -> QueuedItem:
        """Enqueue ``item``; raises :class:`QueueFullError` at capacity."""
        now = self._clock()
        entry = QueuedItem(
            item=item,
            request_id=request_id,
            enqueued_at=now,
            deadline_at=None if deadline_s is None else now + deadline_s,
        )
        with self._lock:
            if len(self._q) >= self.max_queue:
                raise QueueFullError(
                    f"admission queue full ({self.max_queue} requests)"
                )
            self._q.append(entry)
            self._work.notify_all()
        return entry

    def cancel(self, request_id: str) -> bool:
        """Cancel a STILL-QUEUED request; returns whether one was found.
        (In-flight requests are the serving layer's to cancel.)"""
        with self._lock:
            for entry in self._q:
                if entry.request_id == request_id and not entry.cancelled:
                    entry.cancelled = True
                    return True
        return False

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def notify(self) -> None:
        """Wake the worker for work that lives OUTSIDE this queue (a KV
        import landing in the serving layer's graft queue) — without it an
        idle worker would sleep out its poll interval first."""
        with self._lock:
            self._work.notify_all()

    # ---------------------------------------------------------- worker side

    def pop_ready(self, n_free: int, engine_idle: bool = False) -> PopResult:
        """Admit up to ``n_free`` queued items, pruning cancelled/expired
        entries first.  When ``engine_idle`` and a ``max_wait_s`` batching
        window is configured, admission holds until the window elapses or
        the batch would fill every free slot."""
        now = self._clock()
        result = PopResult()
        with self._lock:
            pruned: deque[QueuedItem] = deque()
            for entry in self._q:
                if entry.cancelled:
                    result.cancelled.append(entry)
                elif entry.expired(now):
                    result.expired.append(entry)
                else:
                    pruned.append(entry)
            self._q = pruned
            if not self._q or n_free <= 0:
                return result
            if (
                engine_idle
                and self.max_wait_s > 0.0
                and len(self._q) < n_free
                and now - self._q[0].enqueued_at < self.max_wait_s
            ):
                return result  # keep batching: window still open
            while self._q and len(result.admit) < n_free:
                result.admit.append(self._q.popleft())
        return result

    def wait_for_work(self, timeout: float) -> bool:
        """Block up to ``timeout`` for a NEW submission; True when one
        arrived.  Deliberately waits even when the queue is non-empty: the
        caller polls after doing no work, which happens exactly when
        admission is holding inside a max-wait batching window — returning
        immediately there would busy-spin the worker at 100% CPU for the
        whole window.  A fresh arrival still wakes the worker instantly
        (it may fill the batch and flush the window early)."""
        with self._lock:
            return self._work.wait(timeout)
