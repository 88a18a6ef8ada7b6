"""Core tensor ops (port of ``bpe_transformer_tpu/ops/core.py``).

Weights keep the ``(d_out, d_in)`` row-major layout, so state dicts map 1:1
between the packages; normalization and softmax accumulate in float32
whatever the activation dtype; masks are boolean with True = keep.
"""

from __future__ import annotations

import math

import torch

from bpe_transformer_tpu_torch.ops.rope import apply_rope, rope_tables

#: Large negative filler for masked attention scores.  Finite (not -inf) so
#: fully-masked rows give a uniform distribution instead of NaNs.
MASK_VALUE = -1e30


def linear(x: torch.Tensor, weight) -> torch.Tensor:
    """``y = x @ W.T`` with ``W: (d_out, d_in)``; no bias.  An int8
    quantized weight dict (``ops/quant.py``, serving only) goes to the int8
    matmul kernel."""
    if isinstance(weight, dict):
        from bpe_transformer_tpu_torch.ops.quant import quant_linear

        return quant_linear(x, weight)
    return torch.matmul(x, weight.t())


def head_logits(hidden: torch.Tensor, head_w) -> torch.Tensor:
    """Vocab projection ``hidden (..., d) @ head_w (vocab, d).T``: inputs at
    the hidden's dtype, float32 accumulation and float32 output.

    Both operands are rounded to the hidden's dtype and then upcast, so the
    float32 product sees exactly the bf16 values on the bf16 path without a
    bf16 GEMM rounding its output.  An int8 quantized head dict goes to the
    int8 matmul kernel, whose float32 accumulator is the output.
    """
    if isinstance(head_w, dict):
        from bpe_transformer_tpu_torch.ops.quant import quant_linear

        return quant_linear(hidden, head_w, preserve_f32=True)
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


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shift-stabilized softmax along ``dim``; float32 accumulation, the
    result in ``x``'s dtype."""
    x32 = x.float()
    shifted = x32 - x32.amax(dim=dim, keepdim=True).detach()
    exp = torch.exp(shifted)
    return (exp / exp.sum(dim=dim, keepdim=True)).to(x.dtype)


def scaled_dot_product_attention(q, k, v, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over the last two axes; boolean ``mask`` keeps True entries.
    ``q (..., Sq, d)``, ``k (..., Sk, d)``, ``v (..., Sk, dv)``, ``mask``
    broadcastable to ``(..., Sq, Sk)``."""
    scale = torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device))
    scores = torch.matmul(q, k.transpose(-1, -2)) / scale
    if mask is not None:
        scores = scores.masked_fill(~mask, MASK_VALUE)
    return torch.matmul(softmax(scores, dim=-1), v)


def causal_mask(seq_len: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Lower-triangular ``(seq, seq)`` keep-mask."""
    return torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()


def attention_entropy(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Mean Shannon entropy (nats) of the softmax attention distribution.

    ``q (..., Sq, d)``, ``k (..., Sk, d)``, the tensors an ``attention_fn``
    receives; scores and the log-softmax accumulate in float32, averaged
    over every leading axis and query position (~0: heads collapsed onto
    single keys; ~log(Sk): uniform).  The dynamics tap calls it on one batch
    element: it materializes the (Sq, Sk) score matrix the flash kernels
    exist to avoid.  No graph is built."""
    with torch.no_grad():
        q32, k32 = q.detach().float(), k.detach().float()
        # A Python scale: a tensor made from a host scalar on the card would
        # be a synchronising copy.
        scores = torch.matmul(q32, k32.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if causal:
            keep = causal_mask(scores.shape[-1], scores.device)[: scores.shape[-2]]
            scores = scores.masked_fill(~keep, MASK_VALUE)
        logp = torch.log_softmax(scores, dim=-1)
        # exp(logp) is exactly 0 at masked entries: they add -0.0, never NaN.
        return -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


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


def multihead_self_attention(
    x: torch.Tensor,
    q_w: torch.Tensor,
    k_w: torch.Tensor,
    v_w: torch.Tensor,
    o_w: torch.Tensor,
    num_heads: int,
    *,
    num_kv_heads: int | None = None,
    positions: torch.Tensor | None = None,
    rope_theta: float | None = None,
    max_seq_len: int | None = None,
    rope_cos_sin: tuple[torch.Tensor, torch.Tensor] | None = None,
    causal: bool = True,
    attention_fn=None,
) -> torch.Tensor:
    """Causal multi-head self-attention, optionally with RoPE on Q/K.

    ``attention_fn(q, k, v)`` replaces the materialized-scores attention
    (e.g. the flash kernel) and owns its own causal masking.  RoPE, when
    enabled, is applied here, before ``attention_fn``.  ``num_kv_heads <
    num_heads`` is grouped-query attention: K/V project to fewer heads and
    each is repeated over its consecutive group of query heads before the
    attention call, so every ``attention_fn`` works unchanged.
    """
    seq_len = x.shape[-2]
    kv_heads = num_kv_heads or num_heads
    q = split_heads(linear(x, q_w), num_heads)
    k = split_heads(linear(x, k_w), kv_heads)
    v = split_heads(linear(x, v_w), kv_heads)

    if rope_cos_sin is not None or rope_theta is not None:
        if positions is None:
            positions = torch.arange(seq_len, device=x.device)
        if rope_cos_sin is None:
            rope_cos_sin = rope_tables(
                q.shape[-1], max_seq_len or seq_len, rope_theta, device=x.device
            )
        cos, sin = rope_cos_sin
        pos = positions.unsqueeze(-2)  # broadcast over the head axis
        q = apply_rope(q, pos, cos, sin)
        k = apply_rope(k, pos, cos, sin)

    if kv_heads != num_heads:
        group = num_heads // kv_heads
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)

    if attention_fn is not None:
        attended = attention_fn(q, k, v)
    else:
        mask = causal_mask(seq_len, x.device) if causal else None
        attended = scaled_dot_product_attention(q, k, v, mask)
    return linear(merge_heads(attended), o_w)
