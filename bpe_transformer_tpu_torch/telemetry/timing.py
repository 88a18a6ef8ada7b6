"""Tracing and timing harness (the port's counterpart of
``bpe_transformer_tpu/telemetry/timing.py``): profiler traces, fenced
timing, throughput.

- :func:`profile_trace` — a ``torch.profiler`` trace context that writes a
  Chrome trace (host ops and, on the card, every kernel launch) under
  ``logdir`` as ``trace.json``; the ``train --profile-trace DIR`` flag.
  It takes the place of the JAX package's ``jax.profiler`` trace.
- :func:`time_fn` — wall-clock a callable with a warmup and a
  ``torch.cuda.synchronize`` fence around every call.
- :class:`StepTimer` — windowed tokens/sec(/card) and MFU accounting for
  the training loop, MFU against ``utils/flops.py``'s H100 peak table.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import torch


@contextlib.contextmanager
def profile_trace(logdir: str, device: str | torch.device = "cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block and write it
    to ``<logdir>/trace.json`` (open it in https://ui.perfetto.dev or
    chrome://tracing).  Records host ops, and the card's kernels when
    ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs) -> dict:
    """Time ``fn(*args, **kwargs)`` with a warmup and a device fence around
    every call.  Returns ``{"mean_s", "best_s", "iters"}``."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(iters):
        _sync()
        start = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - start)
    return {"mean_s": sum(times) / len(times), "best_s": min(times), "iters": iters}


class StepTimer:
    """Windowed throughput counter: tokens/sec, tokens/sec/card, and MFU.

    ``update(n_tokens)`` after every step; ``snapshot()`` returns the rates
    over the window since the last snapshot and resets it.  The training
    loop reads a device metric (its own sync point) before calling
    ``snapshot``, so the rates include the card's time, not just dispatch.

    With ``flops_per_token`` and a ``device_kind`` the peak table knows
    (``utils/flops.py``: the H100 rows), the snapshot carries ``mfu``;
    without a peak (the CPU) it has no ``mfu`` key, as in the JAX package.
    """

    def __init__(self, n_chips: int = 1, flops_per_token: float | None = None,
                 device_kind: str | None = None):
        self.n_chips = max(n_chips, 1)
        self.flops_per_token = flops_per_token
        self._peak_flops: float | None = None
        if flops_per_token is not None:
            from bpe_transformer_tpu_torch.utils.flops import peak_flops_per_chip

            self._peak_flops = peak_flops_per_chip(device_kind)
        self._window_start = time.perf_counter()
        self._window_tokens = 0
        self._window_excluded = 0.0
        self.total_tokens = 0

    def update(self, n_tokens: int) -> None:
        self._window_tokens += n_tokens
        self.total_tokens += n_tokens

    def exclude(self, seconds: float) -> None:
        """Discount non-step time (the first step's kernel loads, eval, a
        synchronous checkpoint save) from the current window."""
        self._window_excluded += max(seconds, 0.0)

    def snapshot(self) -> dict:
        now = time.perf_counter()
        elapsed = max(now - self._window_start - self._window_excluded, 1e-9)
        tok_per_sec = self._window_tokens / elapsed
        out = {
            "tokens_per_sec": tok_per_sec,
            "tokens_per_sec_per_chip": tok_per_sec / self.n_chips,
            "window_seconds": elapsed,
            "window_tokens": self._window_tokens,
        }
        if self.flops_per_token is not None and self._peak_flops is not None:
            achieved = tok_per_sec * self.flops_per_token / self.n_chips
            out["mfu"] = achieved / self._peak_flops
        self._window_start = now
        self._window_tokens = 0
        self._window_excluded = 0.0
        return out
