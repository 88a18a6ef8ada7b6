"""Int8-weight matrix product with the dequantization in registers (port of
``bpe_transformer_tpu/kernels/pallas/quant_matmul.py::quant_matmul``).

``x (..., d_in)`` float32 or bfloat16, ``q (d_out, d_in)`` int8, ``scale
(d_out,)`` float32 -> ``(..., d_out)`` float32, ``y = (x q^T) * scale``.  The
scale is one per output channel, so the product factors exactly and the
scale multiplies each output once, after the float32 reduction; a
dequantized copy of the weight never exists.

:func:`quant_matmul` launches ``csrc/quant_matmul.cu`` for CUDA tensors and
runs :func:`quant_matmul_plain` for CPU tensors.  Launches are counted in
``kernels/_build.py`` under ``quant_matmul``.
"""

from __future__ import annotations

import functools

import torch

from bpe_transformer_tpu_torch.kernels import _build

_BM, _BN, _BK = 8, 256, 16  # block tile and staged depth (csrc/quant_matmul.cu)
_MIN_SPLIT_STEPS = 4  # a split of the reduction axis covers at least 64 columns


def quant_matmul_plain(x, q, scale) -> torch.Tensor:
    """The JAX package's ``quant_linear_xla`` before its final cast: a
    float32 product of ``x`` and the int8 values, then one ``* scale`` per
    output."""
    return torch.matmul(x.float(), q.float().t()) * scale


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(m: int, n: int, k: int, device: torch.device) -> tuple[int, int]:
    """``(nsplit, k_per_split)``: the reduction axis cut so that about two
    blocks per SM run in all, each slice at least 64 columns long."""
    steps = -(-k // _BK)
    tiles = -(-n // _BN) * -(-m // _BM)
    want = -(-2 * _sm_count(device) // tiles)
    nsplit = max(1, min(want, steps // _MIN_SPLIT_STEPS))
    per = -(-steps // nsplit)
    return -(-steps // per), per * _BK


def quant_matmul(x, q, scale) -> torch.Tensor:
    """``(x q^T) * scale`` in float32 (see module docstring): the CUDA
    kernel for CUDA tensors, :func:`quant_matmul_plain` for CPU tensors."""
    *lead, d_in = x.shape
    n, d_in2 = q.shape
    if d_in2 != d_in or scale.shape != (n,):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, q {tuple(q.shape)}, "
            f"scale {tuple(scale.shape)}"
        )
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"q must be int8 and scale float32, got {q.dtype} / {scale.dtype}")
    x2 = x.reshape(-1, d_in).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # a row view of a larger tensor may start unaligned
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    nsplit, k_per_split = _splits(m, n, d_in, x.device)
    ws = (torch.empty((nsplit, m, n), dtype=torch.float32, device=x.device)
          if nsplit > 1 else None)
    code, stream = _build.kernel_args(
        "quant_matmul", x2, f32=(scale, out) + ((ws,) if ws is not None else ()), others=(q,)
    )
    fn = _build.entry("quant_matmul", "quant_matmul_launch", 5, 5)
    rc = fn(
        code, x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        ws.data_ptr() if ws is not None else None, out.data_ptr(), m, n, d_in, nsplit,
        k_per_split, stream,
    )
    _build.check(rc, "quant_matmul")
    _build.count("quant_matmul")
    return out.reshape(*lead, n)
