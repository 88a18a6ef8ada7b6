"""Graceful preemption: SIGTERM/SIGINT -> a stop flag the loop polls (the
port's copy of ``bpe_transformer_tpu/resilience/signals.py``).

On shared clusters, preemption is an operating condition, not an exception:
the scheduler SIGTERMs the job and reclaims the card seconds later.  The naive
outcome is losing up to ``checkpoint_every`` steps of work.  This module
turns the signal into a *cooperative* shutdown: a handler sets a flag, the
training loop notices at the next step boundary, writes an emergency
checkpoint, flushes the telemetry footer, and exits with a DISTINCT exit
code (:data:`EXIT_PREEMPTED`) so a supervisor (`resilience.supervisor`, a
container runtime, a batch scheduler) knows to respawn-with-resume rather
than treat it as a crash.

Stdlib-only and torch-free: the supervisor parent imports this without ever
touching the card.
"""

from __future__ import annotations

import signal
import threading

#: Exit code of a run stopped by SIGTERM/SIGINT after an emergency
#: checkpoint — BSD ``EX_TEMPFAIL`` ("temporary failure, retry"): distinct
#: from 0 (done) and 1 (crash), so ``train --supervise`` and shell
#: wrappers can branch on it.
EXIT_PREEMPTED = 75


class GracefulShutdown:
    """Install SIGTERM/SIGINT handlers that set a flag instead of killing.

    Usage (the training loop)::

        stop = GracefulShutdown()
        if stop.install():          # False in non-main threads — poll-less
            try:
                while training:
                    if stop.triggered:
                        ...emergency checkpoint, footer, exit...
            finally:
                stop.uninstall()

    The first signal sets the flag (cooperative: the loop finishes the
    in-flight step, then shuts down).  A SECOND signal means the operator
    wants out *now*: the original disposition is restored and
    ``KeyboardInterrupt`` is raised so the loop's ``finally`` still flushes
    sinks, but no further work happens.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, recorder=None):
        self._flag = threading.Event()
        self._prev: dict[int, object] = {}
        self.signum: int | None = None
        #: Optional flight recorder (telemetry/flightrecorder.py): signal
        #: receipt is the first event of every preemption timeline.  The
        #: handler uses the non-blocking ``try_record`` — a signal
        #: interrupting a thread mid-``record`` must not deadlock on the
        #: recorder's non-reentrant lock.
        self._recorder = recorder

    def install(self) -> bool:
        """Register the handlers; returns False (and stays inert) when not
        on the main thread — ``signal.signal`` only works there."""
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:  # not the main thread
            self.uninstall()
            return False
        return True

    def uninstall(self) -> None:
        """Restore the previous dispositions (idempotent)."""
        for sig, prev in list(self._prev.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
            del self._prev[sig]

    def _handle(self, signum, frame) -> None:
        if self._flag.is_set():
            # Second signal: the cooperative window is over.
            self.uninstall()
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during graceful "
                "shutdown"
            )
        self.signum = signum
        self._flag.set()
        if self._recorder is not None:
            self._recorder.try_record(
                "signal_received", signal=signal.Signals(signum).name
            )

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    @property
    def signame(self) -> str | None:
        """``"SIGTERM"`` / ``"SIGINT"`` once triggered, else None."""
        if self.signum is None:
            return None
        return signal.Signals(self.signum).name

    def __enter__(self) -> "GracefulShutdown":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()
