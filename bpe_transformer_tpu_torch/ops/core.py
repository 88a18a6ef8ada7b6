"""Core tensor ops (port of ``bpe_transformer_tpu/ops/core.py``).

Weights keep the ``(d_out, d_in)`` row-major layout, so state dicts map 1:1
between the packages; normalization accumulates in float32 whatever the
activation dtype.
"""

from __future__ import annotations

import torch

#: Large negative filler for masked attention scores.  Finite (not -inf) so
#: fully-masked rows give a uniform distribution instead of NaNs.
MASK_VALUE = -1e30


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``y = x @ W.T`` with ``W: (d_out, d_in)``; no bias."""
    return torch.matmul(x, weight.t())


def head_logits(hidden: torch.Tensor, head_w: torch.Tensor) -> torch.Tensor:
    """Vocab projection ``hidden (..., d) @ head_w (vocab, d).T``: inputs at
    the hidden's dtype, float32 accumulation and float32 output.

    Both operands are rounded to the hidden's dtype and then upcast, so the
    float32 product sees exactly the bf16 values on the bf16 path without a
    bf16 GEMM rounding its output.
    """
    w = head_w.to(hidden.dtype)
    return torch.matmul(hidden.float(), w.float().t())


def embedding(weight: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Row gather from ``(vocab_size, d_model)``."""
    return weight[token_ids]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Root-mean-square norm with affine scale; accumulates in float32 and
    casts back before the weight multiply."""
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def swiglu(x, w1, w2, w3) -> torch.Tensor:
    """SwiGLU FFN ``w2(silu(w1 x) * (w3 x))`` as plain matmuls at the input
    dtype (``w1, w3: (d_ff, d_model)``, ``w2: (d_model, d_ff)``)."""
    return linear(silu(linear(x, w1)) * linear(x, w3), w2)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(..., S, H*dh) -> (..., H, S, dh)``, head-major projection rows."""
    *batch, seq, dm = x.shape
    x = x.reshape(*batch, seq, num_heads, dm // num_heads)
    return x.movedim(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``(..., H, S, dh) -> (..., S, H*dh)``."""
    x = x.movedim(-3, -2)
    *batch, seq, h, dh = x.shape
    return x.reshape(*batch, seq, h * dh)
