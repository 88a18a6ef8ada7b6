"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<hash>/lib<name>.so`` through one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
call; all missing libraries are compiled at once, one ``nvcc`` process per
source, started together.  ``<hash>`` covers every file in ``csrc/`` and the
flags, so an edited source builds anew and an unchanged one is reused.

Each library exposes plain C entry points that take pointers as
``c_void_p``, sizes as ``c_int``, the CUDA stream last, and return
``cudaGetLastError()`` after the launch; :func:`check` raises on a non-zero
code, and the wrapper then adds one to its kernel's entry in
:data:`launches`.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: Sources compiled by this process and the wall seconds of those builds
#: (``telemetry/resources.py`` reports them as the compile counters).
_builds = {"count": 0, "seconds": 0.0}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built on this host"
    )


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: seconds}`` for the sources compiled by this call
    (empty when everything was built already).  The ptxas report of each
    build (registers, shared memory, spills) is kept beside its library
    as ``<name>.log``."""
    with _lock:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in kernel_names():
            lib = out / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
            log = open(out / f"{name}.log", "w")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            )
            procs[name] = (proc, tmp, lib, log)
        times: dict[str, float] = {}
        failed = []
        for name, (proc, tmp, lib, log) in procs.items():
            rc = proc.wait()
            log.close()
            times[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)
        if procs:
            _builds["count"] += len(procs) - len(failed)
            _builds["seconds"] += time.perf_counter() - t0
        if failed:
            details = "\n".join(
                f"--- {n} ---\n" + (out / f"{n}.log").read_text()[-4000:]
                for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{details}")
        return times


def build_stats() -> dict[str, float]:
    """Kernel-library accounting of this process: ``built`` sources
    compiled, ``build_s`` their wall seconds, ``loaded`` libraries loaded.
    Reads without the build lock, so a reader never waits out a build."""
    return {"built": _builds["count"], "build_s": _builds["seconds"], "loaded": len(_libs)}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build_dir() / f"lib{name}.so"
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C function ``symbol`` of library ``name`` with its ctypes
    signature set: ``n_ptrs`` pointers, ``n_ints`` ints, then the stream."""
    fn = getattr(library(name), symbol)
    fn.argtypes = (
        [ctypes.c_int]  # dtype code
        + [ctypes.c_void_p] * n_ptrs
        + [ctypes.c_int] * n_ints
        + [ctypes.c_void_p]  # cudaStream_t
    )
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


#: The dtype codes the C entry points take (``csrc/common.cuh``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: The code of int8 storage (KV pools, quantized weights), passed beside
#: the activation dtype's code.
INT8_CODE = 2


def kernel_args(what: str, *tensors, f32=(), others=()) -> tuple[int, int]:
    """Validate the tensors handed to a kernel: all on one CUDA device,
    contiguous, with 16-byte aligned storage; ``tensors`` of one dtype the
    kernels take (float32 or bfloat16), ``f32`` (row statistics, tables)
    float32 whatever that dtype; ``others`` (int8 storage, int32 tables)
    of a dtype the caller has checked.  Returns ``(dtype_code, stream)``."""
    first = tensors[0]
    for t in (*tensors, *f32, *others):
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and 16-byte aligned")
    for t in tensors:
        if t.dtype != first.dtype:
            raise ValueError(f"{what}: mixed dtypes {first.dtype} / {t.dtype}")
    for t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: statistics and tables must be float32, got {t.dtype}")
    code = DTYPE_CODES.get(first.dtype)
    if code is None:
        raise ValueError(f"{what}: dtype {first.dtype} unsupported (float32, bfloat16)")
    return code, torch.cuda.current_stream(first.device).cuda_stream


#: Kernel launches per kernel name, counted by each wrapper right after a
#: launch succeeded (CPU calls, which run the plain versions, count nothing).
launches: dict[str, int] = {}


def count(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    launches.clear()


def read_launches(names) -> dict[str, int]:
    return {name: launches.get(name, 0) for name in names}
