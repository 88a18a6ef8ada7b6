"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in GiB, on the fullest rank."""


def read(run):
    return max(r["peak_window_bytes"] for r in run["ranks"]) / 2**30
