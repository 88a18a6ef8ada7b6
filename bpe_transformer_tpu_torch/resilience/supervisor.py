"""Supervised restarts (the part of ``bpe_transformer_tpu/resilience/
supervisor.py`` that the fleet controller needs): how a child process
ended, in words.  The training supervisor itself comes with the training
resilience slice.

Imports no torch: the controller that supervises serve replicas runs on a
front-end host.
"""

from __future__ import annotations

import signal

__all__ = ["EXIT_PREEMPTED"]

#: The exit code of a run that stopped on a preemption signal after its
#: emergency checkpoint (``bpe_transformer_tpu/resilience/signals.py``).
EXIT_PREEMPTED = 75


def _describe_exit(rc: int) -> str:
    if rc == EXIT_PREEMPTED:
        return f"preempted (exit {rc})"
    if rc < 0:
        try:
            return f"killed by {signal.Signals(-rc).name}"
        except ValueError:
            return f"killed by signal {-rc}"
    return f"crashed (exit {rc})"
