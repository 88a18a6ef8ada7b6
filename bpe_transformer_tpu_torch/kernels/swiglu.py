"""Fused SwiGLU FFN (port of
``bpe_transformer_tpu/kernels/pallas/swiglu.py::swiglu_fused`` and its
custom VJP).

``x (..., d_model)``, ``w1/w3 (d_ff, d_model)``, ``w2 (d_model, d_ff)`` ->
``(..., d_model)``, the argument order of ``ops.core.swiglu``.  The gated
hidden ``h = silu(x w1^T) * (x w3^T)`` is computed in float32 and rounded to
``x``'s dtype before the down projection, as the TPU kernel does; the down
projection accumulates in float32 (the TPU kernel accumulates in ``x``'s
dtype across its ff slices).

:func:`swiglu_fused` is :class:`SwiGLUFused`: its forward launches
``csrc/swiglu.cu`` for CUDA tensors and runs :func:`swiglu_plain` for CPU
tensors; its backward is the JAX package's ``_swiglu_bwd``, float32 matmuls
that recompute the two up projections, which the JAX package runs in XLA
outside any Pallas kernel.  Launches are counted in ``kernels/_build.py``
under ``swiglu``, one per forward whichever design runs.

The forward is bound by operations from a few dozen rows up and by the
weight bytes at a decode tick.  :func:`swiglu_path` picks the design: bf16
runs on the tensor cores (two ``wgmma`` GEMM kernels, the up and gate
products with the SiLU-gate epilogue writing h in bf16, then the down
product) at every m, since they beat the CUDA-core kernel from one row up
on the card (``chip_smoke.py`` measures the crossover, ``PERF.md``);
float32 (which must keep float32 accuracy: no TF32) and bf16 at widths
TMA cannot describe run the CUDA-core kernel, which keeps h on chip and
splits d_ff over blocks for parallelism at small m.
"""

from __future__ import annotations

import functools

import torch

from bpe_transformer_tpu_torch.kernels import _build

_BM, _BF = 16, 32  # row tile, ff slice of the CUDA-core kernel (csrc/swiglu.cu)


def swiglu_path(d: int, ff: int, dtype) -> str:
    """The design a forward runs: ``"tensor_cores"`` for bf16 when ``d``
    and ``d_ff`` are multiples of 8 (16-byte rows, which TMA needs), else
    ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and d % 8 == 0 and ff % 8 == 0:
        return "tensor_cores"
    return "cuda_cores"


def swiglu_plain(x, w1, w2, w3) -> torch.Tensor:
    """The kernel's arithmetic as float32 matmuls: ``h`` rounded to ``x``'s
    dtype, ``y`` accumulated in float32 and rounded once."""
    x32 = x.float()
    up = torch.matmul(x32, w1.float().t())
    gate = torch.matmul(x32, w3.float().t())
    h = (up * torch.sigmoid(up) * gate).to(x.dtype)
    return torch.matmul(h.float(), w2.float().t()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nsplit(m: int, ff: int, device: torch.device) -> int:
    """ff slices spread over blocks: about two blocks per SM in all."""
    m_tiles = -(-m // _BM)
    slices = -(-ff // _BF)
    sms = _sm_count(device)
    return max(1, min(slices, -(-2 * sms // m_tiles)))


def _swiglu_forward(x, w1, w2, w3, path: str | None = None) -> torch.Tensor:
    """The CUDA kernels for CUDA tensors (the design :func:`swiglu_path`
    picks, unless ``path`` names one), :func:`swiglu_plain` for CPU
    tensors."""
    if x.device.type == "cpu":
        return swiglu_plain(x, w1, w2, w3)
    orig_shape = x.shape
    d = orig_shape[-1]
    ff = w1.shape[0]
    if w1.shape != (ff, d) or w3.shape != (ff, d) or w2.shape != (d, ff):
        raise ValueError(
            f"weight shapes {tuple(w1.shape)} {tuple(w2.shape)} {tuple(w3.shape)} "
            f"do not fit d_model={d}"
        )
    x2d = x.reshape(-1, d).contiguous()
    m = x2d.shape[0]
    out = torch.empty_like(x2d)
    if (path or swiglu_path(d, ff, x.dtype)) == "tensor_cores":
        h = torch.empty((m, ff), dtype=x.dtype, device=x.device)
        code, stream = _build.kernel_args("swiglu", x2d, w1, w3, w2, h, out)
        fn = _build.entry("swiglu", "swiglu_tc_launch", 6, 3)
        rc = fn(
            code, x2d.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            h.data_ptr(), out.data_ptr(), m, d, ff, stream,
        )
        _build.check(rc, "swiglu")
        _build.count("swiglu")
        return out.reshape(orig_shape)
    nsplit = _nsplit(m, ff, x.device)
    ws = torch.empty((nsplit, m, d), dtype=torch.float32, device=x.device)
    code, stream = _build.kernel_args("swiglu", x2d, w1, w3, w2, out)
    fn = _build.entry("swiglu", "swiglu_launch", 6, 4)
    rc = fn(
        code, x2d.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        ws.data_ptr(), out.data_ptr(), m, d, ff, nsplit, stream,
    )
    _build.check(rc, "swiglu")
    _build.count("swiglu")
    return out.reshape(orig_shape)


class SwiGLUFused(torch.autograd.Function):
    """Fused SwiGLU forward (kernel) with the closed-form float32 backward."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3):
        ctx.save_for_backward(x, w1, w2, w3)
        return _swiglu_forward(x, w1, w2, w3)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, w3 = ctx.saved_tensors
        d = x.shape[-1]
        x2d = x.reshape(-1, d).float()
        g2d = g.reshape(-1, d).float()
        w1f, w2f, w3f = w1.float(), w2.float(), w3.float()
        up = x2d @ w1f.t()
        lin = x2d @ w3f.t()
        sig = torch.sigmoid(up)
        silu = up * sig
        h = silu * lin
        gh = g2d @ w2f
        d_lin = gh * silu
        d_up = gh * lin * (sig + silu * (1.0 - sig))  # silu' = sig + silu (1 - sig)
        dx = (d_up @ w1f + d_lin @ w3f).to(x.dtype).reshape(x.shape)
        dw1 = (d_up.t() @ x2d).to(w1.dtype)
        dw3 = (d_lin.t() @ x2d).to(w3.dtype)
        dw2 = (g2d.t() @ h).to(w2.dtype)
        return dx, dw1, dw2, dw3


def swiglu_fused(x, w1, w2, w3) -> torch.Tensor:
    """Fused SwiGLU, differentiable (:class:`SwiGLUFused`)."""
    return SwiGLUFused.apply(x, w1, w2, w3)
