"""Arithmetic the per-layer metric readers (``metrics/*.py``) share: each
reader is a few lines over the run's readings and these helpers.  A helper
returns None where there is nothing to read (no trace, no launch, no peak
row for the card), and the metric is then left out of the result."""

from __future__ import annotations

import statistics

import numpy as np

from portbench import counts, trace

#: Name patterns of the profiler's kernel names, by the program's launch
#: name (``kernels/_build.py``).  B5 is the flash forward with RoPE and the
#: causal mask (its template's last two flags); B3's tensor-core design
#: runs two GEMMs of ``csrc/swiglu.cu``'s ``tc`` namespace, its CUDA-core
#: design a partial and a reduce kernel.
KERNEL_PATTERNS = {
    "flash_attention_rope": r"flash_fwd\w*_kernel<[^>]*\b\d+, true, true>",
    "swiglu": r"tc::gemm_kernel<|swiglu_partial_kernel|swiglu_reduce_kernel",
    "decode_attention": r"\bdecode_attention_kernel\b",
    "nccl": r"(?i)nccl",
}


def itemsize(model: dict) -> int:
    return 2 if model.get("activation_dtype") == "bfloat16" else 4


def traces(run: dict) -> list[dict]:
    """The traced stretch of every rank (one on one card)."""
    ranks = run.get("ranks") or [run]
    return [r["trace"] for r in ranks if r.get("trace")]


def roofline(run: dict, launch: str, least_per_call, pattern: str | None = None
             ) -> float | None:
    """Percent of the roofline over the traced stretch, averaged over the
    ranks: the least time of the calls the stretch made (the program's
    launch counter for ``launch``, in the trace's ``calls``;
    ``least_per_call(run, t)`` gives the sum over them) over the device time
    of the kernels of ``launch``.  Those are named by
    :data:`KERNEL_PATTERNS`, or where it has no entry for ``launch`` by
    ``pattern``, which the metric's own file gives."""
    rx = KERNEL_PATTERNS.get(launch, pattern)
    if rx is None:
        raise KeyError(f"no kernel-name pattern for launch {launch!r}: the metric gives none")
    shares = []
    for t in traces(run):
        seconds, n = trace.kernel_seconds(t["kernels"], rx)
        least = least_per_call(run, t)
        if not seconds or not n or least is None or least <= 0:
            continue
        shares.append(100.0 * least / seconds)
    return statistics.fmean(shares) if shares else None


def least(run: dict, flops: float, nbytes: float) -> float | None:
    return counts.least_seconds(flops, nbytes, run["device_kind"])


def peak_flops(run: dict) -> float | None:
    row = counts.peaks(run["device_kind"])
    return row[0] if row else None


def idle_share(run: dict) -> float | None:
    """Percent of the traced stretch in which no device operation ran,
    averaged over the ranks."""
    shares = [100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in traces(run)
              if t["window_s"] > 0 and t["busy_s"] > 0]
    return statistics.fmean(shares) if shares else None


def window_requests(run: dict) -> list:
    """The serving records submitted inside the window."""
    return [r for r in run["records"] if run["t0"] <= r.t_submit < run["t1"]]


def percentile(values, q: float) -> float | None:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
