"""Resource accounting for ``kind="resources"`` records (the port's rewrite of
``bpe_transformer_tpu/telemetry/resources.py``).

The record keeps the JAX package's fields, so its ``report``, ``monitor``
and the serving ``/metrics`` read the port's streams unchanged; what feeds
each field differs:

- **Device memory** (``hbm_bytes_in_use``, ``hbm_peak_bytes_in_use``,
  ``hbm_bytes_limit``): ``torch.cuda.memory_stats()`` (the caching
  allocator's current and peak allocated bytes) and
  ``torch.cuda.mem_get_info()`` (the card's total memory), summed over the
  cards the process allocates on.  ``None`` where it allocates on none (a
  CPU run), never absent.  The peak is the process's whole run: code that
  reads a peak of its own (the attribution probe) resets the allocator's
  counter through :func:`reset_device_peak`, which keeps the peak before
  the reset, so that peak also covers the probe's clone of the state.
- **Live buffers** (``live_buffer_bytes``): ``torch.cuda.memory_allocated()``
  over the visible cards, the bytes held by live tensors; ``None`` without
  CUDA.
- **Host RSS**: ``/proc/self/status`` VmRSS, with a ``getrusage`` peak
  fallback.
- **Compile events**: the port compiles no XLA programs.  What it builds and
  loads are its kernel libraries (``kernels/_build.py``): ``compile_events``
  counts the sources this process compiled with ``nvcc`` plus the libraries
  it loaded, ``compile_time_s`` is the wall time of those builds, and
  ``compile_cache_hits`` counts the libraries it loaded without building
  them (a warm build root).  A server's count settles once every kernel of
  its path is loaded.  :func:`record_compile_events` adds events of builds
  outside ``_build``.

Everything here reads host-side allocator state or the process table and
never synchronises the card.
"""

from __future__ import annotations

import sys
import threading
import time

import torch

from bpe_transformer_tpu_torch.kernels import _build


#: Each card's allocated-bytes peak as it stood at its last
#: :func:`reset_device_peak`, by device index.
_peak_before_reset: dict[int, int] = {}


def reset_device_peak(device: torch.device) -> None:
    """``torch.cuda.reset_peak_memory_stats(device)``, keeping the peak it
    clears: :func:`device_memory_stats` reports the larger of the kept
    peak and the allocator's peak since, so a caller that measures its own
    peak never shortens the run's."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    peak = int(torch.cuda.memory_stats(index).get("allocated_bytes.all.peak", 0))
    _peak_before_reset[index] = max(_peak_before_reset.get(index, 0), peak)
    torch.cuda.reset_peak_memory_stats(index)


#: Compile events added by :func:`record_compile_events`: ``[events,
#: seconds]``, under ``_recorded_lock``.
_recorded = [0, 0.0]
_recorded_lock = threading.Lock()


def record_compile_events(n: int = 1, duration_s: float = 0.0) -> int:
    """Add ``n`` compile events and their wall seconds to what
    :func:`compile_events` and :func:`compile_time_s` report (for builds
    that ``kernels/_build.py`` does not count); returns the new event
    total."""
    with _recorded_lock:
        _recorded[0] += n
        _recorded[1] += max(duration_s, 0.0)
    return compile_events()


def install_compile_counter() -> bool:
    """True: the counters need no hook here.  ``kernels/_build.py`` counts
    every kernel library this process builds or loads as it does so (the
    JAX package registers a ``jax.monitoring`` listener instead)."""
    return True


def compile_events() -> int:
    """Kernel-library builds plus loads in this process so far, plus the
    events :func:`record_compile_events` added."""
    stats = _build.build_stats()
    with _recorded_lock:
        return int(stats["built"] + stats["loaded"]) + _recorded[0]


def compile_time_s() -> float:
    """Cumulative wall seconds of this process's kernel-library builds,
    plus those :func:`record_compile_events` added."""
    with _recorded_lock:
        return float(_build.build_stats()["build_s"]) + _recorded[1]


def compile_cache_hits() -> int:
    """Kernel libraries this process loaded without compiling them: found
    built in the build root (``--compile-cache DIR``, filled by ``warmup``
    or an earlier run)."""
    stats = _build.build_stats()
    return max(int(stats["loaded"] - stats["built"]), 0)


def kernel_libraries_loaded() -> int:
    """Kernel libraries loaded in this process (the port's count of
    compiled programs: one library per ``csrc/*.cu`` source)."""
    return int(_build.build_stats()["loaded"])


def kernel_launches() -> dict[str, int]:
    """This process's launches per kernel so far (``kernels/_build.py``
    ``launches``; the plain versions the CPU runs count none)."""
    return dict(sorted(dict(_build.launches).items()))


def host_rss_bytes() -> int | None:
    """Current resident set size of this process in bytes (Linux
    ``/proc/self/status`` VmRSS; ``getrusage`` *peak* RSS as a portable
    fallback), or None when neither source exists."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS.
        return peak_kb if sys.platform == "darwin" else peak_kb * 1024
    except (ImportError, OSError):
        return None


def _cuda_ready() -> bool:
    # is_initialized: a process that never touched the card reports None
    # rather than creating a CUDA context as a side effect of sampling.
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_stats() -> dict | None:
    """Allocator stats summed over the cards this process allocates on:
    ``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit", "n_devices"}``,
    or None when it allocates on none.  Cards it never used are skipped, so
    that sampling creates no CUDA context on them."""
    if not _cuda_ready():
        return None
    totals = {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    n = 0
    for device in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(device)
        if not stats.get("reserved_bytes.all.peak", 0):
            continue
        n += 1
        totals["bytes_in_use"] += int(stats.get("allocated_bytes.all.current", 0))
        totals["peak_bytes_in_use"] += max(int(stats.get("allocated_bytes.all.peak", 0)),
                                           _peak_before_reset.get(device, 0))
        totals["bytes_limit"] += int(torch.cuda.mem_get_info(device)[1])
    if n == 0:
        return None
    totals["n_devices"] = n
    return totals


def live_buffer_bytes() -> int | None:
    """Bytes held by live tensors on the visible cards
    (``torch.cuda.memory_allocated``), or None without CUDA."""
    if not _cuda_ready():
        return None
    return int(sum(torch.cuda.memory_allocated(d) for d in range(torch.cuda.device_count())))


def tree_bytes_per_device(tree) -> int:
    """Bytes of every tensor in a tree (an ``AdamWState`` included): on one
    device, the JAX package's per-device byte count."""
    from bpe_transformer_tpu_torch.tree import tree_leaves

    return int(sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree)
                   if isinstance(leaf, torch.Tensor)))


def sample_resources(**extra) -> dict:
    """One ``kind="resources"`` record: host RSS, live-tensor bytes, summed
    device-memory stats (None fields without CUDA), and the kernel-library
    counters.  ``extra`` attrs (``step``, ``t``) merge into the record."""
    record: dict = {
        "kind": "resources",
        "time_unix": round(time.time(), 3),
        "host_rss_bytes": host_rss_bytes(),
        "live_buffer_bytes": live_buffer_bytes(),
        "compile_events": compile_events(),
        "compile_time_s": round(compile_time_s(), 3),
        "compile_cache_hits": compile_cache_hits(),
    }
    mem = device_memory_stats()
    record["hbm_bytes_in_use"] = mem["bytes_in_use"] if mem else None
    record["hbm_peak_bytes_in_use"] = mem["peak_bytes_in_use"] if mem else None
    record["hbm_bytes_limit"] = mem["bytes_limit"] if mem else None
    record.update(extra)
    return record
