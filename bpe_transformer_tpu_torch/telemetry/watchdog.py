"""Watchdog: hung-step detection and a non-finite-state policy (the port's
copy of ``bpe_transformer_tpu/telemetry/watchdog.py``; threading only).

Two failure modes kill long training runs silently: a hung kernel/dispatch
(the loop blocks forever, the queue window burns with no output) and a
NaN/Inf that poisons the state steps before anyone reads a loss.  The
watchdog covers both:

- **Hang detection.**  The training loop calls :meth:`Watchdog.beat` at
  every metric sync with the measured per-step wall time; a background
  thread flags when no beat arrives within ``factor`` x the trailing
  MEDIAN step time (median, not mean: one slow checkpoint step must not
  stretch the deadline) x the steps-per-beat cadence.  On a trip it emits a
  ``watchdog_hang`` event through the shared telemetry stream (so the
  evidence reaches the JSONL even while the main thread is stuck) and calls
  an optional ``on_hang`` callback.  Detection is flag-and-log — the thread
  never kills the run (the stuck dispatch may still complete; the operator
  or the launching script decides).
- **Non-finite policy.**  :meth:`on_nonfinite` implements "dump state +
  act": the offending record is emitted as a ``nonfinite`` event
  (the dump — sinks flush per record, so it survives the crash), then
  policy ``"raise"`` raises :class:`NonFiniteError` (default: stop before
  the corrupted state trains further or gets checkpointed), ``"skip"``
  records and continues (branch for runs that prefer losing a window of
  steps over losing the job), and ``"rollback"`` records and returns —
  the training loop then reloads the last valid checkpoint, skips the
  offending data window, and retries under the crash-loop budget of
  ``resilience.rollback.RollbackBudget`` (the watchdog only owns the
  evidence dump; the recovery action lives where the state does).

All timing logic is pure and clock-injectable (:meth:`check`), so tests
drive it without threads or sleeps; the thread is opt-in via
:meth:`start`/:meth:`stop`.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import deque


class NonFiniteError(FloatingPointError):
    """Raised by the ``"raise"`` policy when a non-finite state is detected.

    Carries the offending (already-emitted) record as ``.record``.
    """

    def __init__(self, message: str, record: dict | None = None):
        super().__init__(message)
        self.record = record or {}


class Watchdog:
    POLICIES = ("raise", "skip", "rollback")

    def __init__(
        self,
        factor: float = 10.0,
        steps_per_beat: int = 1,
        policy: str = "raise",
        min_history: int = 3,
        history_window: int = 50,
        min_timeout_s: float = 5.0,
        poll_interval_s: float = 0.5,
        telemetry=None,
        on_hang=None,
        recorder=None,
        clock=time.monotonic,
    ):
        """``factor``: multiple of the trailing median step time that counts
        as hung.  ``steps_per_beat``: how many steps elapse between beats
        (the loop beats once per ``log_every``).  ``min_timeout_s`` floors
        the deadline so microsecond CPU steps don't make the watchdog
        hair-triggered."""
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, got {policy!r}")
        self.factor = factor
        self.steps_per_beat = max(steps_per_beat, 1)
        self.policy = policy
        self.min_history = min_history
        self.min_timeout_s = min_timeout_s
        self.poll_interval_s = poll_interval_s
        self._telemetry = telemetry
        self._on_hang = on_hang
        #: Optional flight recorder (telemetry/flightrecorder.py): hang
        #: trips and non-finite verdicts are decision events, and both
        #: flush the ring as a black-box dump — a hang's dump may be the
        #: last evidence out before the operator kills the process.
        self._recorder = recorder
        self._clock = clock
        self._step_times: deque[float] = deque(maxlen=history_window)
        self._last_beat = clock()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        #: Trips observed (a new beat re-arms detection for the next gap).
        self.hang_events = 0
        self.nonfinite_events = 0
        self._tripped_this_gap = False
        self._suspended = 0

    # ---------------------------------------------------------------- beats

    def beat(self, step_time_s: float | None = None) -> None:
        """Mark a completed sync; ``step_time_s`` is the measured per-step
        wall time over the window since the previous beat."""
        with self._lock:
            self._last_beat = self._clock()
            self._tripped_this_gap = False
            if step_time_s is not None and step_time_s > 0:
                self._step_times.append(step_time_s)

    @contextlib.contextmanager
    def pause(self):
        """Suspend hang detection for a legitimately long phase the loop
        knows about (the first eval's jit compile, a synchronous multi-GB
        checkpoint save) — the deadline is step-time-calibrated and would
        otherwise trip mid-phase.  Re-arms on exit.  Reentrant."""
        with self._lock:
            self._suspended += 1
        try:
            yield
        finally:
            with self._lock:
                self._suspended -= 1
                self._last_beat = self._clock()
                self._tripped_this_gap = False

    def median_step_s(self) -> float | None:
        with self._lock:
            if len(self._step_times) < self.min_history:
                return None
            return statistics.median(self._step_times)

    def hang_timeout_s(self) -> float | None:
        """Seconds of beat silence that count as hung, or None while the
        step-time history is too short to judge."""
        median = self.median_step_s()
        if median is None:
            return None
        return max(self.factor * median * self.steps_per_beat, self.min_timeout_s)

    def check(self, now: float | None = None) -> bool:
        """True (once per silent gap) when the run looks hung.  Pure — the
        poll thread calls this, and tests can drive it with a fake clock."""
        timeout = self.hang_timeout_s()
        if timeout is None:
            return False
        if now is None:
            now = self._clock()
        with self._lock:
            if (
                self._suspended
                or self._tripped_this_gap
                or now - self._last_beat <= timeout
            ):
                return False
            self._tripped_this_gap = True
            self.hang_events += 1
            silent_s = now - self._last_beat
        if self._recorder is not None:
            self._recorder.record(
                "watchdog_hang",
                silent_s=round(silent_s, 3),
                timeout_s=round(timeout, 3),
            )
            dump = self._recorder.blackbox("watchdog_hang")
            if dump is not None and self._telemetry is not None:
                self._telemetry.emit(dump)
        if self._telemetry is not None:
            self._telemetry.event(
                "watchdog_hang",
                silent_s=round(silent_s, 3),
                timeout_s=round(timeout, 3),
                median_step_s=round(self.median_step_s() or 0.0, 6),
            )
        if self._on_hang is not None:
            self._on_hang(silent_s)
        return True

    # --------------------------------------------------------------- thread

    def start(self) -> None:
        """Begin background polling (daemon thread; never blocks exit)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._poll, name="telemetry-watchdog", daemon=True
        )
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.check()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------- non-finite

    def on_nonfinite(self, record: dict, fields: list[str] | None = None) -> None:
        """Apply the non-finite policy to an offending step record.

        Always dumps the evidence first (a ``nonfinite`` telemetry event
        with the record inlined — sinks flush per record, so it reaches the
        JSONL even when ``"raise"`` tears the loop down next).
        """
        self.nonfinite_events += 1
        # Dynamics localization (telemetry.dynamics): when the loop stamped
        # the offending tensor path onto the record, the event and the
        # raised error name it — "NaN in params/layers.3.ffn.w1", not just
        # "loss is NaN".
        path = record.get("nonfinite_path")
        if self._recorder is not None:
            self._recorder.record(
                "nonfinite",
                step=record.get("step"),
                policy=self.policy,
                path=path,
            )
            # Dump BEFORE the "raise" policy tears the loop down — forced:
            # a terminal path must never lose its dump to the cooldown.
            dump = self._recorder.blackbox(
                "nonfinite", force=self.policy == "raise"
            )
            if dump is not None and self._telemetry is not None:
                self._telemetry.emit(dump)
        if self._telemetry is not None:
            self._telemetry.event(
                "nonfinite",
                step=record.get("step"),
                fields=fields or [],
                policy=self.policy,
                record=record,
                **({"path": path} if path else {}),
            )
        if self.policy == "raise":
            detail = ", ".join(fields) if fields else (
                "dynamics localization" if path else "loss"
            )
            raise NonFiniteError(
                f"non-finite training state at step {record.get('step')}"
                f" ({detail})"
                + (f", localized to {path}" if path else "")
                + "; state dumped to the telemetry stream",
                record=record,
            )
