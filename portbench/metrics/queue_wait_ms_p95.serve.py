"""95th percentile of the engine's queue-wait span (``Result.queue_wait_s``)
of the requests submitted in the window."""

from portbench import readers


def read(run):
    waits = [r.result.queue_wait_s for r in readers.window_requests(run)
             if r.result is not None and r.t_first is not None]
    p = readers.percentile(waits, 95)
    return None if p is None else p * 1e3
