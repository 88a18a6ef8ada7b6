"""Device time of the NCCL kernels a traced step, averaged over the ranks:
the collectives' share of the step, waiting on the ranks' skew included."""

import statistics

from portbench import readers, trace


def read(run):
    per_step = []
    for t in readers.traces(run):
        seconds, n = trace.kernel_seconds(t["kernels"], readers.KERNEL_PATTERNS["nccl"])
        if n:
            per_step.append(seconds / t["steps"] * 1e3)
    return statistics.fmean(per_step) if per_step else None
