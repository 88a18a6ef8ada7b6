"""Reading a ``torch.profiler`` trace of a short steady stretch.

The stretch is profiled with CPU and CUDA activities; everything here runs
after the profiler has stopped, so the reading costs the stretch nothing.
Device time is the union of the kernel intervals (two kernels that overlap
count once), as ``telemetry/attribution.py`` ``device_busy_split`` of the
program takes it; the copy here is the benchmark's own.
"""

from __future__ import annotations

import heapq
import re


def device_events(prof) -> tuple[list, list]:
    """``(device, host)``: ``(name, start_us, end_us)`` of every device
    activity (kernels, copies, sets) and of every host operator."""
    device, host = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if str(e.device_type).split(".")[-1].lower() == "cuda":
            device.append(rng)
        else:
            host.append(rng)
    return device, host


def union_us(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """What the metrics and the result's ``breakdown`` read from a trace:
    ``busy_s`` (union of device intervals), ``window_s``, ``kernels``
    (``{name: [seconds, launches]}``), ``device_ops`` (the ``top`` names by
    device seconds) and ``idle_gaps`` (the device's idle time inside the
    busy span, grouped by the innermost host operator running at each gap's
    middle, the ``top`` largest)."""
    device, host = device_events(prof)
    kernels: dict[str, list] = {}
    for name, a, b in device:
        entry = kernels.setdefault(name, [0.0, 0])
        entry[0] += (b - a) * 1e-6
        entry[1] += 1
    busy = union_us((a, b) for _, a, b in device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: dict[str, float] = {}
    mids = [(0.5 * (end + start), start - end) for (_, end), (start, _) in zip(busy, busy[1:])]
    for name, width in zip(_innermost(host, [m for m, _ in mids]), (w for _, w in mids)):
        gaps[name] = gaps.get(name, 0.0) + width * 1e-6
    ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": kernels,
        "device_ops": [[n[:160], s] for n, s in ops[:top]],
        "idle_gaps": [[n[:160], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def _innermost(host: list, points: list) -> list[str]:
    """For each of the sorted ``points``, the name of the shortest host
    interval that covers it (a sweep over the intervals by start, with the
    live ones in a heap by width and expired ones dropped lazily)."""
    events = sorted(host, key=lambda h: h[1])
    live: list = []
    names, i = [], 0
    for p in points:
        while i < len(events) and events[i][1] <= p:
            name, a, b = events[i]
            heapq.heappush(live, (b - a, b, name))
            i += 1
        while live and live[0][1] < p:
            heapq.heappop(live)
        names.append(live[0][2] if live else "(no host operator)")
    return names


def kernel_seconds(kernels: dict, pattern: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name matches
    ``pattern`` (a regular expression searched in the name)."""
    rx = re.compile(pattern)
    seconds, launches = 0.0, 0
    for name, (s, n) in kernels.items():
        if rx.search(name):
            seconds += s
            launches += n
    return seconds, launches
