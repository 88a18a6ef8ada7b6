"""95th percentile, over every request submitted in the window, of the
time from its submission to its first streamed token (the clients' clock)."""

from portbench import readers


def read(run):
    ttft = [r.t_first - r.t_submit for r in readers.window_requests(run) if r.t_first is not None]
    p = readers.percentile(ttft, 95)
    return None if p is None else p * 1e3
