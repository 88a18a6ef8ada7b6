"""Device calls that the benchmark's own CPU tests also reach: on the CPU
they do nothing (there is no asynchronous queue and no device memory
statistic)."""

from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def to_device(a, device):
    """A host array on the device without a host wait: through pinned
    memory on the card (the copy is queued behind the work before it)."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def activities(host_ops: bool) -> list:
    """The profiler's activities: the device's (kernels, copies and the
    CUDA runtime calls that launch them) and, with ``host_ops``, every
    PyTorch operator on the host, which costs the host several
    microseconds an operator.  Without a card, the host's only."""
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
