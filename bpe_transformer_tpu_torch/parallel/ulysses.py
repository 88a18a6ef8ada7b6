"""Ulysses sequence parallelism: an all-to-all head scatter (port of
``bpe_transformer_tpu/parallel/ulysses.py``).

Where the ring (:mod:`parallel.ring_attention`) rotates K/V shards round
the ranks, Ulysses re-partitions Q/K/V once, from sequence-sharded to
head-sharded, with an all-to-all: every rank then attends over the FULL
sequence for ``H/n`` of the heads, and a second all-to-all restores the
sequence sharding for the token-local rest of the block.  The head count
must be a multiple of the ring size.

The tensors carry the ring's ranks as a leading dim, as the ring schedules'
do (:mod:`parallel.mesh`): q/k/v are ``(local, B, H, S_local, D)`` and the
transport's ``all_to_all`` moves them, a permutation of the stacked ranks on
one device (:class:`~parallel.mesh.StackedRing`) or one
``all_to_all_single`` over the ``seq`` group
(:class:`~parallel.mesh.ProcessGroupRing`).  The gradient of an all-to-all
is the inverse all-to-all, so autograd derives the backward schedule.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.ops.core import causal_mask, scaled_dot_product_attention


def _heads_to_seq(x: torch.Tensor, ring) -> torch.Tensor:
    """``(local, B, H, S_local, d)`` seq-sharded -> ``(local, B, H/n, S, d)``
    head-sharded.  The ranks' order along ``seq`` is the global token order
    of the contiguous layout, so the gathered sequence is in token order and
    the causal mask stays the plain triangle."""
    return ring.all_to_all(x, 1, 2)


def _seq_to_heads(x: torch.Tensor, ring) -> torch.Tensor:
    """The inverse of :func:`_heads_to_seq`."""
    return ring.all_to_all(x, 2, 1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, ring,
                      config: ModelConfig | None = None) -> torch.Tensor:
    """Causal attention over sequence shards by head scattering.

    ``q/k/v``: ``(local, B, H, S_local, d_head)`` rank-stacked shards, RoPE
    already applied at the global positions, the kv heads already expanded
    (``ops.core.multihead_self_attention`` repeats them before any
    ``attention_fn``).  Returns the attended values in the same layout.

    GQA: when ``config.num_kv_heads`` also divides the ring, K and V ship
    compact (``k[:, :, ::group]``) and are re-expanded after the exchange
    with ``repeat_interleave(group)``, ``jnp.repeat``'s order: rank i's query
    heads ``[i H/n, (i+1) H/n)`` meet its kv heads ``[i KV/n, (i+1) KV/n)``.
    The re-expansion's backward sums each group, and the sliced-away copies
    get zero gradients, which the model's own expansion sums away.

    ``config.attention_impl == "flash"`` runs the full-sequence attention
    through the flash kernels (the forward with lse and the FA-2 backward);
    anything else, ``"flash_fused"`` included, the materialized attention in
    float32."""
    n = ring.size
    heads = q.shape[-3]
    if heads % n:
        raise ValueError(
            f"Ulysses scatters heads over the mesh axis: num_heads={heads} "
            f"must be a multiple of the 'seq' axis size {n} (use "
            "the ring schedule for head counts that aren't)"
        )
    kv_heads = (config.num_kv_heads or heads) if config is not None else heads
    group = heads // kv_heads
    compact_kv = group > 1 and kv_heads % n == 0
    if compact_kv:
        k = k[:, :, ::group]
        v = v[:, :, ::group]
    qh = _heads_to_seq(q, ring)
    kh = _heads_to_seq(k, ring)
    vh = _heads_to_seq(v, ring)
    if compact_kv:
        kh = kh.repeat_interleave(group, dim=2)
        vh = vh.repeat_interleave(group, dim=2)
    local, b, h, s, d = qh.shape
    if config is not None and config.attention_impl == "flash":
        from bpe_transformer_tpu_torch.kernels.flash_attention import flash_attention

        out = flash_attention(*(t.reshape(local * b, h, s, d) for t in (qh, kh, vh)))
        out = out.reshape(local, b, h, s, d)
    else:
        mask = causal_mask(s, q.device)
        out = scaled_dot_product_attention(qh.float(), kh.float(), vh.float(), mask).to(q.dtype)
    return _seq_to_heads(out, ring)
