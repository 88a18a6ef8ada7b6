"""Host time of one update inside the program's own ``bpt.train_step``
range, median over the traced stretch recorded with host operators,
averaged over the ranks: the in-program counterpart of
``dispatch_ms.train`` (which also holds the profiler's cost per operator
here)."""

from portbench import phases


def read(run):
    return phases.figure(run, ["train_step"], "host_ms")
