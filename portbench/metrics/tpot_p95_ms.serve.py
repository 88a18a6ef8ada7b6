"""95th percentile of the gaps between consecutive tokens of one request,
over every token after a request's first that the engine emitted in the
window (the worker's clock as each tick returned; ``TokenLog``): a stall
of a tick, such as the admissions before it, shows in every live
request's gap."""

from portbench import readers


def read(run):
    gaps = [gap for _, _, k, gap in run["emitted"] if k > 0]
    p = readers.percentile(gaps, 95)
    return None if p is None else p * 1e3
