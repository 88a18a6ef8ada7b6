"""Host time of the step's backward (``torch.autograd.grad``, the
program's ``bpt.backward`` range), median over the traced stretch recorded
with host operators, averaged over the ranks."""

from portbench import phases


def read(run):
    return phases.figure(run, ["backward"], "host_ms")
