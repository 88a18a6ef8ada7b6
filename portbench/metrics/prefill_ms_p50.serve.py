"""Median of the engine's prefill span (``Result.prefill_s``) of the
requests submitted in the window."""

from portbench import readers


def read(run):
    spans = [r.result.prefill_s for r in readers.window_requests(run)
             if r.result is not None and r.t_first is not None]
    p = readers.percentile(spans, 50)
    return None if p is None else p * 1e3
