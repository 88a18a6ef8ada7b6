"""Rotary position embeddings, interleaved-pair convention (port of
``bpe_transformer_tpu/ops/rope.py``).

For each adjacent feature pair ``(x[2k], x[2k+1])`` at position ``p``, rotate
by angle ``p * theta^(-2k/d)``.  This is not torch's usual half-split
layout: the pairs are neighbours, as in the JAX package and the reference
checkpoints.
"""

from __future__ import annotations

import functools

import torch


def rope_tables(
    d_k: int,
    max_seq_len: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` tables of shape ``(max_seq_len, d_k // 2)``, computed
    in float32 and cast to ``dtype``."""
    if d_k % 2:
        raise ValueError(f"RoPE feature dim must be even, got {d_k}")
    inv_freq = theta ** (
        -torch.arange(0, d_k, 2, dtype=torch.float32, device=device) / d_k
    )
    angles = (
        torch.arange(max_seq_len, dtype=torch.float32, device=device)[:, None]
        * inv_freq[None, :]
    )
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


@functools.lru_cache(maxsize=16)
def cached_rope_tables(
    d_k: int, max_seq_len: int, theta: float, dtype: torch.dtype,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_tables` built once per shape, dtype and device: the
    eager decode path asks for the same tables in every layer of every
    step (the JAX package folds them into a compiled constant)."""
    return rope_tables(d_k, max_seq_len, theta, dtype, device)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> torch.Tensor:
    """Rotate ``x`` (``..., seq, d_k``) by the table rows at ``positions``
    (``..., seq``, broadcasting against ``x``'s leading dims)."""
    cos_p = cos[positions]  # (..., seq, d_k // 2)
    sin_p = sin[positions]
    x_even = x[..., 0::2]
    x_odd = x[..., 1::2]
    rot_even = x_even * cos_p - x_odd * sin_p
    rot_odd = x_even * sin_p + x_odd * cos_p
    return torch.stack([rot_even, rot_odd], dim=-1).reshape(x.shape)


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10000.0,
    max_seq_len: int | None = None,
) -> torch.Tensor:
    """Build the tables on ``x``'s device at its dtype and rotate ``x`` by
    them (the JAX package's one-shot form); ``max_seq_len`` defaults to the
    largest position + 1."""
    if max_seq_len is None:
        max_seq_len = int(positions.max()) + 1
    cos, sin = rope_tables(x.shape[-1], max_seq_len, theta, dtype=x.dtype, device=x.device)
    return apply_rope(x, positions, cos, sin)
