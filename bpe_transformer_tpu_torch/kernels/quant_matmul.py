"""Int8-weight matrix product with the dequantization in registers (port of
``bpe_transformer_tpu/kernels/pallas/quant_matmul.py::quant_matmul``).

``x (..., d_in)`` float32 or bfloat16, ``q (d_out, d_in)`` int8, ``scale
(d_out,)`` float32 -> ``(..., d_out)`` float32, ``y = (x q^T) * scale``.  The
scale is one per output channel, so the product factors exactly and the
scale multiplies each output once, after the float32 reduction; a
dequantized copy of the weight never exists.

:func:`quant_matmul` launches ``csrc/quant_matmul.cu`` for CUDA tensors and
runs :func:`quant_matmul_plain` for CPU tensors.  Launches are counted in
``kernels/_build.py`` under ``quant_matmul``, one a call whichever design
runs (the split reduction's second kernel included).

:func:`quant_path` picks the design before the launch: bf16 ``x`` with
``d_in`` a multiple of 16 runs on the tensor cores (``wgmma`` on the
transposed product, the int8 weight widened exactly to bf16 in registers;
every int8 value is exact in bf16 and every product of the two exact in
float32, so only the summation order moves); float32 ``x`` (which must keep
float32 accuracy: no TF32) and weight rows TMA cannot describe (``d_in %
16``: an int8 row must be a multiple of 16 bytes long, e.g. d_ff 683 or
1365) run the CUDA-core kernel.
"""

from __future__ import annotations

import functools

import torch

from bpe_transformer_tpu_torch.kernels import _build

_BM, _BN, _BK = 8, 256, 16  # block tile and staged depth (csrc/quant_matmul.cu)
_MIN_SPLIT_STEPS = 4  # a split of the reduction axis covers at least 64 columns
_TC_BW, _TC_KS = 64, 128  # tensor-core block: weight rows, K columns a stage
_TC_BN = (8, 16, 32, 64)  # activation rows a tensor-core block takes


def quant_path(m: int, k: int, dtype) -> str:
    """The design a call with ``m`` rows of ``x`` over ``d_in = k`` runs:
    ``"tensor_cores"`` for bf16 ``x`` when ``k`` is a multiple of 16 (int8
    weight rows of whole 16-byte units, which TMA needs), else
    ``"cuda_cores"``.  ``m`` does not enter: ``chip_smoke.py``'s sweep finds
    the tensor cores faster from one row up."""
    if dtype == torch.bfloat16 and k % 16 == 0:
        return "tensor_cores"
    return "cuda_cores"


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


def tc_geometry(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """``(bn, nsplit, per)`` of a tensor-core launch on a card of ``sms``
    SMs: ``bn`` activation rows a block (the fewest of :data:`_TC_BN` that
    hold ``m``, else 64), and the K axis's 128-column slices cut into
    ``nsplit`` splits of ``per`` slices (none empty) so that about two
    blocks per SM run in all; no split above ``m`` 64, where the float32
    partials would outweigh the weight bytes."""
    bn = next((b for b in _TC_BN if m <= b), _TC_BN[-1])
    steps = -(-k // _TC_KS)
    if m > _TC_BN[-1]:
        return bn, 1, steps
    tiles = -(-n // _TC_BW)
    nsplit = max(1, min(-(-2 * sms // tiles), steps))
    per = -(-steps // nsplit)
    return bn, -(-steps // per), per


def quant_matmul(x, q, scale, path: str | None = None) -> torch.Tensor:
    """``(x q^T) * scale`` in float32 (see module docstring): the CUDA
    kernel for CUDA tensors (the design :func:`quant_path` picks, unless
    ``path`` names one), :func:`quant_matmul_plain` for CPU tensors."""
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
    tensor_cores = (path or quant_path(m, d_in, x.dtype)) == "tensor_cores"
    if tensor_cores:
        bn, nsplit, per = tc_geometry(m, n, d_in, _sm_count(x.device))
        ints = (m, n, d_in, nsplit, per, bn)
    else:
        nsplit, k_per_split = _splits(m, n, d_in, x.device)
        ints = (m, n, d_in, nsplit, k_per_split)
    ws = (torch.empty((nsplit, m, n), dtype=torch.float32, device=x.device)
          if nsplit > 1 else None)
    code, stream = _build.kernel_args(
        "quant_matmul", x2, f32=(scale, out) + ((ws,) if ws is not None else ()), others=(q,)
    )
    symbol = "quant_matmul_tc_launch" if tensor_cores else "quant_matmul_launch"
    fn = _build.entry("quant_matmul", symbol, 5, len(ints))
    rc = fn(
        code, x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
        ws.data_ptr() if ws is not None else None, out.data_ptr(), *ints, stream,
    )
    _build.check(rc, "quant_matmul")
    _build.count("quant_matmul")
    return out.reshape(*lead, n)
