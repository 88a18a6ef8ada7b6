"""Median host time of one step call in the window, from call to return
(the benchmark's own span, no sync): how long the host takes to queue a
step."""

import statistics


def read(run):
    spans = run["ranks"][0]["dispatch_s"]
    return statistics.median(spans) * 1e3 if spans else None
