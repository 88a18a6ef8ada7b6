"""Host time a step of the MoE layers' four stages over every layer (the
program's ``bpt.moe.route``, ``bpt.moe.dispatch``, ``bpt.moe.experts`` and
``bpt.moe.combine`` ranges), median over the traced stretch recorded with
host operators."""

from portbench import phases

STAGES = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def read(run):
    return phases.figure(run, STAGES, "host_ms")
