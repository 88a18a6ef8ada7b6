"""Host time of the step's forward (the loss function's call, the
program's ``bpt.forward`` range), median over the traced stretch recorded
with host operators, averaged over the ranks."""

from portbench import phases


def read(run):
    return phases.figure(run, ["forward"], "host_ms")
