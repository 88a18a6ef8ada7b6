"""CUDA launch calls a step inside the program's ``bpt.clip`` and
``bpt.adamw`` ranges (a per-leaf loop launches a dozen kernels a leaf),
median over the traced stretch recorded with host operators, averaged over
the ranks."""

from portbench import phases


def read(run):
    return phases.figure(run, ["clip", "adamw"], "launches")
