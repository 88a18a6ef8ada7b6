"""Host time of the step's global-norm clip and AdamW update (the
program's ``bpt.clip`` and ``bpt.adamw`` ranges), median over the traced
stretch recorded with host operators, averaged over the ranks."""

from portbench import phases


def read(run):
    return phases.figure(run, ["clip", "adamw"], "host_ms")
