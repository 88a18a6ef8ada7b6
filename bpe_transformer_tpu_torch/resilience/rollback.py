"""Crash-loop accounting for NaN rollback recovery (the port's copy of
``bpe_transformer_tpu/resilience/rollback.py``).

``on_nonfinite="rollback"`` reloads the last valid checkpoint and retries
with the offending data window skipped.  Without a budget that is a crash
loop generator: a systematically-diverging run (bad LR, corrupted optimizer
state) would roll back forever, burning the card while reporting
"recovering".  :class:`RollbackBudget` is the breaker: rollbacks are only
free while the run keeps making *progress* — once ``max_rollbacks``
consecutive rollbacks happen without at least ``min_progress_steps`` of
training between them, the budget trips and the loop escalates to a hard
failure.

Pure and clock-free, so tests drive it directly.
"""

from __future__ import annotations


class RollbackExhausted(RuntimeError):
    """Raised by :meth:`RollbackBudget.note` when the crash-loop breaker
    trips — the loop converts it into a terminal ``NonFiniteError``."""


class RollbackBudget:
    """Counts rollbacks, forgiving those separated by real progress.

    ``note(step)`` registers a rollback detected at ``step``.  If at least
    ``min_progress_steps`` of training happened since the previous rollback
    was detected, the consecutive-failure counter resets (the run is
    limping, not stuck).  More than ``max_rollbacks`` rollbacks without such
    progress raises :class:`RollbackExhausted`.
    """

    def __init__(self, max_rollbacks: int = 3, min_progress_steps: int = 1):
        if max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, got {max_rollbacks}")
        if min_progress_steps < 1:
            raise ValueError(
                f"min_progress_steps must be >= 1, got {min_progress_steps}"
            )
        self.max_rollbacks = max_rollbacks
        self.min_progress_steps = min_progress_steps
        #: Total rollbacks over the run (telemetry, not the breaker).
        self.total = 0
        #: Consecutive rollbacks without min_progress_steps between them.
        self.consecutive = 0
        self._last_detect_step: int | None = None

    def note(self, detect_step: int) -> int:
        """Register a rollback detected at ``detect_step``; returns the
        total rollback count, or raises :class:`RollbackExhausted`."""
        progressed = (
            self._last_detect_step is None
            or detect_step - self._last_detect_step >= self.min_progress_steps
        )
        self.consecutive = 1 if progressed else self.consecutive + 1
        self._last_detect_step = detect_step
        self.total += 1
        if self.consecutive > self.max_rollbacks:
            raise RollbackExhausted(
                f"rollback budget exhausted: {self.consecutive} rollbacks "
                f"without {self.min_progress_steps} step(s) of progress "
                f"(max_rollbacks={self.max_rollbacks}) — the failure is not "
                "batch-local; aborting instead of crash-looping"
            )
        return self.total
