"""The step's phases in a ``torch.profiler`` trace of the program.

The program marks each training update with host ranges named ``bpt.*``
(``telemetry/spans.py`` ``phase``): ``bpt.train_step`` around the update,
``bpt.forward``, ``bpt.backward``, ``bpt.grad_reduce``, ``bpt.clip``,
``bpt.adamw`` and ``bpt.param_gather`` under it, ``bpt.moe.*`` around the
stages of an MoE layer.  They are host events of ``FUNCTION`` scope, so no
union of device intervals counts them.  The spans are the program's; their
reading here is the benchmark's own (the program's
``telemetry/attribution.py`` ``phase_table`` does the same for its
attribution records, and a test holds the two together), so a change to the
program cannot move the yardstick.  ``read`` runs after the profiler has
stopped, over a stretch recorded with host operators.  A program without
the ranges gives an empty reading.
"""

from __future__ import annotations

import bisect
import re
import statistics

#: The CUDA runtime calls that launch work on the card, by name.
LAUNCH_CALL = re.compile(r"Launch(Cooperative)?Kernel|GraphLaunch")


def read(prof, steps: int) -> dict:
    """``{name: {"host_ms", "device_ms", "launches"}}`` for each ``bpt.*``
    range (the prefix left out), each figure the median over the stretch's
    ``steps`` updates of the update's sum: the ranges' host time (the
    profiler's cost per operator included), the device time of the kernels
    whose host operator starts inside them (by the profiler's
    launch-to-kernel link, on any thread) and the CUDA launch calls that
    start inside them.  Empty unless the trace holds ``steps`` updates."""
    events = prof.events()
    if sum(e.name == "bpt.train_step" for e in events) != steps:
        return {}
    return table(events)


def table(events) -> dict:
    """:func:`read` over a list of profiler events (each with ``name``,
    ``time_range.start``/``.end`` in microseconds and ``kernels``, the
    device activities linked to it).  A kernel or a launch counts in every
    range that holds its start, on any thread: the backward's kernels are
    launched by autograd's device thread while the step's thread waits
    inside ``bpt.backward``."""
    updates = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "bpt.train_step")
    if not updates:
        return {}
    starts = [a for a, _ in updates]

    def update_of(t: float):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= updates[i][1] else None

    ranges: dict[str, list] = {}
    for e in events:
        if e.name.startswith("bpt."):
            ranges.setdefault(e.name[4:], []).append((e.time_range.start, e.time_range.end))
    sums = {name: [[0.0, 0.0, 0] for _ in updates] for name in ranges}
    for name, spans in ranges.items():
        spans.sort()
        for a, b in spans:
            i = update_of(a)
            if i is not None:
                sums[name][i][0] += (b - a) / 1e3
    for e in events:
        kernel_us = sum(k.duration for k in e.kernels)
        launch = LAUNCH_CALL.search(e.name) is not None
        t = e.time_range.start
        i = update_of(t) if kernel_us or launch else None
        if i is None:
            continue
        for name, spans in ranges.items():
            j = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if j >= 0 and t <= spans[j][1]:
                sums[name][i][1] += kernel_us / 1e3
                sums[name][i][2] += launch
    return {name: {"host_ms": statistics.median(r[0] for r in rows),
                   "device_ms": statistics.median(r[1] for r in rows),
                   "launches": statistics.median(r[2] for r in rows)}
            for name, rows in sums.items()}


def figure(run: dict, names, key: str):
    """The sum over ``names`` of one figure of the traced stretch's phases,
    averaged over the ranks; None where no rank's trace holds them all (a
    program without the ranges, or a trace read without its phases)."""
    values = []
    for r in run.get("ranks") or [run]:
        phases = (r.get("trace") or {}).get("phases") or {}
        if all(n in phases for n in names):
            values.append(sum(phases[n][key] for n in names))
    return statistics.fmean(values) if values else None
