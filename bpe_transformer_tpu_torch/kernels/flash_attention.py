"""Causal flash-attention forward (port of
``bpe_transformer_tpu/kernels/pallas/flash_attention.py::flash_attention``
as prefill calls it).

``q, k, v`` are ``(..., seq, d_head)`` with any leading dims (batch, heads);
the result has ``q``'s shape and dtype.  Only ``causal=True`` is ported (the
only form the serving path calls); the backward and the RoPE-in-kernel and
lse variants belong to the training slices.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs :func:`flash_attention_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.ops.core import MASK_VALUE

#: Kernel launches made by :func:`flash_attention` (CPU calls not counted).
launches = 0


def flash_attention_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """Materialized-scores reference in float32 (the JAX package's
    ``_xla_attention`` oracle), cast to ``q``'s dtype."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    scores = torch.matmul(q32, k32.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if causal:
        s = q.shape[-2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, MASK_VALUE)
    return torch.matmul(torch.softmax(scores, dim=-1), v32).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Causal attention over the last two axes: the CUDA kernel for CUDA
    tensors, :func:`flash_attention_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if not causal:
        raise NotImplementedError("the flash kernel is ported for causal=True only")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    *batch, s, d = q.shape
    if d not in (16, 32, 64, 128):
        raise ValueError(f"d_head={d} unsupported by the kernel (16, 32, 64, 128)")
    bh = 1
    for dim in batch:
        bh *= dim
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    code, stream = _build.kernel_args("flash_attention", q, k, v, out)
    fn = _build.entry("flash_attention", "flash_attention_launch", 4, 3)
    rc = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d, stream)
    _build.check(rc, "flash_attention")
    global launches
    launches += 1
    return out
