"""Ring attention: exact causal attention over sequence shards (port of
``bpe_transformer_tpu/parallel/ring_attention.py``).

Every rank holds a shard of Q, K and V.  K/V blocks travel around the ring
(``ring.shift``, JAX's ``ppermute``) and each rank folds every visiting
block into its queries' attention; after ``n`` steps every query has seen
every key.  The schedules are written against a ring transport
(:mod:`parallel.mesh`): every tensor carries the ranks a process holds as
its leading dim, ``(local, ..., S_local, D)``, and the JAX package's
predicated selects on ``axis_index`` become ``torch.where`` on rank masks
that broadcast over that dim.  Under :class:`~parallel.mesh.StackedRing`
(all n ranks on one device) one ring step of a flash schedule is one kernel
launch over all n ranks' blocks, with ``bh = n * batch * heads``.

* :func:`ring_self_attention` and :func:`zigzag_ring_self_attention`: the
  plain-torch online-softmax rings (the XLA rings of the JAX package), which
  the sp step runs for ``attention_impl != "flash"``, and the oracle of the
  flash rings.
* :func:`make_ring_attention`: :func:`ring_self_attention` over whole
  ``(B, H, S, D)`` tensors on a stacked ring, for callers outside a step.
* :func:`ring_flash_attention` and :func:`zigzag_ring_flash_attention`: the
  rings with the flash kernel inside each shard (``kernels/flash_attention.py``
  ``flash_attention_with_lse`` forward, merged by log-sum-exp in float32;
  ``flash_attention_block_bwd`` backward against the GLOBAL output and
  logsumexp, each shard's dK/dV travelling home with its K/V block).

Contiguous shards give rank ``i`` the ``i``-th slice of the sequence; under
causal masking rank ``i`` needs ``i + 1`` of the ``n`` blocks, yet every rank
computes every step.  Zig-zag shards (:func:`zigzag_indices`) give rank ``i``
chunks ``(i, 2n-1-i)`` of ``2n``, so every rank does the same work: each step
is two half-size products (three on the diagonal step).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bpe_transformer_tpu_torch.kernels.flash_attention import (
    flash_attention_block_bwd,
    flash_attention_with_lse,
)
from bpe_transformer_tpu_torch.ops.core import MASK_VALUE as NEG_INF
from bpe_transformer_tpu_torch.parallel.mesh import StackedRing


def _per_rank(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-rank ``(local,)`` tensor shaped to broadcast against ``like``."""
    return mask.reshape(-1, *([1] * (like.ndim - 1)))


def _where(mask, a, b):
    """``a`` on the ranks where ``mask`` holds, ``b`` elsewhere."""
    return torch.where(_per_rank(mask, a), a, b)


def _scores(q, k, scale):
    """float32 scores of compute-dtype inputs (exact products, float32 sums),
    the JAX rings' ``preferred_element_type=float32`` einsum."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _fold(state, scores, v_blk):
    """Fold one block of float32 scores into the online-softmax state
    ``(m, l, acc)``; the probabilities meet V at V's dtype, as in JAX."""
    m, l, acc = state
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc_new


def _fold_visiting_block(q, k_blk, v_blk, state, row_base, col_base, causal, kv_chunk, scale):
    """Fold one visiting K/V block into ``state``; ``row_base``/``col_base``
    are per-rank global offsets of the query and key shards.  ``kv_chunk``
    (dividing the block's key length) folds the block in sub-chunks, each
    under ``torch.utils.checkpoint`` (JAX's rematerialized scan), so score
    memory is O(S_local * kv_chunk)."""
    s_q, s_kv = q.shape[-2], k_blk.shape[-2]
    rows = torch.arange(s_q, device=q.device)[:, None]

    def fold(m, l, acc, k_c, v_c, col0):
        scores = _scores(q, k_c, scale)
        if causal:
            cols = torch.arange(k_c.shape[-2], device=q.device)[None, :] + col0
            keep = _per_rank(row_base, scores) + rows >= _per_rank(col_base, scores) + cols
            scores = scores.masked_fill(~keep, NEG_INF)
        return _fold((m, l, acc), scores, v_c)

    if not kv_chunk or kv_chunk >= s_kv:
        return fold(*state, k_blk, v_blk, 0)
    if s_kv % kv_chunk:
        raise ValueError(f"kv_chunk {kv_chunk} must divide the shard length {s_kv}")
    for col0 in range(0, s_kv, kv_chunk):
        chunk = slice(col0, col0 + kv_chunk)
        state = checkpoint(fold, *state, k_blk[..., chunk, :], v_blk[..., chunk, :], col0,
                           use_reentrant=False)
    return state


def ring_self_attention(q, k, v, ring, causal: bool = True, kv_chunk: int | None = None):
    """Attention over contiguous sequence shards ``(local, ..., S_local, D)``;
    the global sequence is the shards in rank order.  ``kv_chunk`` bounds
    score memory at O(S_local * kv_chunk) (rematerialized on the
    backward); None folds one full block per ring step."""
    n = ring.size
    me = ring.index(q.device)
    s_local = q.shape[-2]
    scale = 1.0 / q.shape[-1] ** 0.5
    stat_shape = (*q.shape[:-1], 1)
    m = torch.full(stat_shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(stat_shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    k_cur, v_cur = k, v
    for step in range(n):
        src = (me - step) % n  # whose K/V each rank holds this step
        m_new, l_new, acc_new = _fold_visiting_block(
            q, k_cur, v_cur, (m, l, acc), me * s_local, src * s_local, causal, kv_chunk, scale
        )
        if causal:
            # Blocks wholly above a rank's diagonal fold in as no-ops; step
            # 0 is the diagonal block, so the state is always seeded.
            visible = src <= me
            m = _where(visible, m_new, m)
            l = _where(visible, l_new, l)
            acc = _where(visible, acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
        if step < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def zigzag_ring_self_attention(q, k, v, ring):
    """Causal attention over zig-zag shards ``(local, ..., S_local, D)``: the
    first ``S_local/2`` rows of rank ``i`` are global chunk ``i``, the rest
    chunk ``2n-1-i`` (lay data out with :func:`zigzag_indices`).  Step 0
    folds ``qa@ka`` and ``qb@kb`` (triangular) and ``qb@ka``; a later step
    from shard ``src`` folds ``(qa, qb) @ ka`` when ``src < me``, else
    ``qb @ (ka, kb)``: two half-size products selected by operand."""
    n = ring.size
    me = ring.index(q.device)
    s_local = q.shape[-2]
    if s_local % 2:
        raise ValueError(f"zig-zag local length must be even, got {s_local}")
    c = s_local // 2
    scale = 1.0 / q.shape[-1] ** 0.5

    def split(x):
        return x[..., :c, :], x[..., c:, :]

    def stat():
        shape = (*qa.shape[:-1], 1)
        return (torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device),
                torch.zeros(shape, dtype=torch.float32, device=q.device),
                torch.zeros(qa.shape, dtype=torch.float32, device=q.device))

    qa, qb = split(q)
    state_a, state_b = stat(), stat()
    tri = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()

    ka, kb = split(k)
    va, vb = split(v)
    state_a = _fold(state_a, _scores(qa, ka, scale).masked_fill(~tri, NEG_INF), va)
    state_b = _fold(state_b, _scores(qb, ka, scale), va)
    state_b = _fold(state_b, _scores(qb, kb, scale).masked_fill(~tri, NEG_INF), vb)

    k_cur, v_cur = k, v
    for step in range(1, n):
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        src = (me - step) % n
        early = src < me  # the visiting shard's low chunk precedes ours
        ka, kb = split(k_cur)
        va, vb = split(v_cur)

        # Product 1: (early ? qa : qb) @ ka, the state routed in and out.
        q_sel = _where(early, qa, qb)
        st_in = tuple(_where(early, a, b) for a, b in zip(state_a, state_b))
        folded = _fold(st_in, _scores(q_sel, ka, scale), va)
        state_a = tuple(_where(early, f, a) for f, a in zip(folded, state_a))
        state_b = tuple(_where(early, b, f) for f, b in zip(folded, state_b))

        # Product 2: qb @ (early ? ka : kb).
        state_b = _fold(state_b, _scores(qb, _where(early, ka, kb), scale),
                        _where(early, va, vb))

    def finish(st):
        return st[2] / torch.clamp(st[1], min=1e-30)

    return torch.cat([finish(state_a), finish(state_b)], dim=-2).to(q.dtype)


# ------------------------------------------------- ring + flash kernels


def _merge_partials(out_acc, lse_acc, out_blk, lse_blk):
    """Log-sum-exp combine of two partial attention results (float32)."""
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    w_acc = torch.exp(lse_acc - lse_new)[..., None]
    w_blk = torch.exp(lse_blk - lse_new)[..., None]
    return out_acc * w_acc + out_blk * w_blk, lse_new


def _ring_flash_fwd(q, k, v, ring, block_q, block_k):
    n = ring.size
    me = ring.index(q.device)
    # Step 0, the diagonal block, is the only causal one.
    out, lse = flash_attention_with_lse(q, k, v, True, block_q, block_k)
    out = out.float()
    k_cur, v_cur = k, v
    for step in range(1, n):
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        src = (me - step) % n
        o_blk, l_blk = flash_attention_with_lse(q, k_cur, v_cur, False, block_q, block_k)
        m_out, m_lse = _merge_partials(out, lse, o_blk.float(), l_blk)
        # Shards after a rank's own are masked whole under causality.
        visible = src < me
        out, lse = _where(visible, m_out, out), _where(visible, m_lse, lse)
    return out.to(q.dtype), lse


def _ring_flash_bwd(q, k, v, out, lse, g, ring, block_q, block_k):
    n = ring.size
    me = ring.index(q.device)
    dq, dk_acc, dv_acc = (t.float() for t in flash_attention_block_bwd(
        q, k, v, out, lse, g, True, block_q, block_k))
    k_cur, v_cur = k, v
    for step in range(1, n):
        # The dK/dV accumulators travel with the K/V shard they belong to;
        # the shift after the loop brings each home with every rank's part.
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        dk_acc, dv_acc = ring.shift(dk_acc), ring.shift(dv_acc)
        src = (me - step) % n
        dq_blk, dk_blk, dv_blk = flash_attention_block_bwd(
            q, k_cur, v_cur, out, lse, g, False, block_q, block_k)
        visible = src < me
        dq = dq + _where(visible, dq_blk.float(), torch.zeros_like(dq))
        dk_acc = dk_acc + _where(visible, dk_blk.float(), torch.zeros_like(dk_acc))
        dv_acc = dv_acc + _where(visible, dv_blk.float(), torch.zeros_like(dv_acc))
    dk_acc, dv_acc = ring.shift(dk_acc), ring.shift(dv_acc)
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, block_q, block_k):
        out, lse = _ring_flash_fwd(q, k, v, ring, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_ring_flash_bwd(*ctx.saved_tensors, g, *ctx.args), None, None, None)


def ring_flash_attention(q, k, v, ring, block_q: int = 256, block_k: int = 256):
    """Causal ring attention over contiguous shards ``(local, ..., S_local,
    D)`` with the flash kernel inside each shard: partial outputs merge by
    log-sum-exp; the backward re-runs the block backward per visiting shard
    against the GLOBAL output and logsumexp and routes each shard's dK/dV
    home around the ring.  A shard's ``S_local`` must divide by the block
    sizes (the non-causal kernel calls' check)."""
    return _RingFlash.apply(q, k, v, ring, block_q, block_k)


def _zz_split(x, c):
    return x[..., :c, :], x[..., c:, :]


def _zz_flash_fwd(q, k, v, ring, block_q, block_k):
    if q.shape[-2] % 2:
        raise ValueError(f"zig-zag local length must be even, got {q.shape[-2]}")
    n = ring.size
    me = ring.index(q.device)
    c = q.shape[-2] // 2
    qa, qb = _zz_split(q, c)

    def call(qq, kk, vv, causal):
        o, lse = flash_attention_with_lse(qq, kk, vv, causal, block_q, block_k)
        return o.float(), lse

    # Step 0, own K/V: the only causal calls (both diagonal sub-blocks).
    ka, kb = _zz_split(k, c)
    va, vb = _zz_split(v, c)
    out_a, lse_a = call(qa, ka, va, True)
    o2, l2 = call(qb, ka, va, False)
    o3, l3 = call(qb, kb, vb, True)
    out_b, lse_b = _merge_partials(o2, l2, o3, l3)

    k_cur, v_cur = k, v
    for step in range(1, n):
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        src = (me - step) % n
        early = src < me
        ka, kb = _zz_split(k_cur, c)
        va, vb = _zz_split(v_cur, c)

        # Product 1: (early ? qa : qb) @ ka, one kernel call.
        o1, l1 = call(_where(early, qa, qb), ka, va, False)
        m_out, m_lse = _merge_partials(_where(early, out_a, out_b), _where(early, lse_a, lse_b),
                                       o1, l1)
        out_a, lse_a = _where(early, m_out, out_a), _where(early, m_lse, lse_a)
        out_b, lse_b = _where(early, out_b, m_out), _where(early, lse_b, m_lse)

        # Product 2: qb @ (early ? ka : kb).
        o2, l2 = call(qb, _where(early, ka, kb), _where(early, va, vb), False)
        out_b, lse_b = _merge_partials(out_b, lse_b, o2, l2)

    out = torch.cat([out_a, out_b], dim=-2).to(q.dtype)
    return out, torch.cat([lse_a, lse_b], dim=-1)


def _zz_flash_bwd(q, k, v, out, lse, g, ring, block_q, block_k):
    n = ring.size
    me = ring.index(q.device)
    c = q.shape[-2] // 2
    qa, qb = _zz_split(q, c)
    ga, gb = _zz_split(g, c)
    out_a, out_b = _zz_split(out, c)
    lse_a, lse_b = lse[..., :c], lse[..., c:]

    def bwd(qq, kk, vv, oo, ll, gg, causal):
        return tuple(t.float() for t in flash_attention_block_bwd(
            qq, kk, vv, oo, ll, gg, causal, block_q, block_k))

    # Step 0: the forward's three sub-blocks.
    ka, kb = _zz_split(k, c)
    va, vb = _zz_split(v, c)
    dq_a, dka1, dva1 = bwd(qa, ka, va, out_a, lse_a, ga, True)
    dq2, dka2, dva2 = bwd(qb, ka, va, out_b, lse_b, gb, False)
    dq3, dkb3, dvb3 = bwd(qb, kb, vb, out_b, lse_b, gb, True)
    dq_b = dq2 + dq3
    # dK/dV accumulators travel with the visiting K/V shard (see
    # ring_flash_attention); one shift after the loop delivers them home.
    dk_acc = torch.cat([dka1 + dka2, dkb3], dim=-2)
    dv_acc = torch.cat([dva1 + dva2, dvb3], dim=-2)

    k_cur, v_cur = k, v
    for step in range(1, n):
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        dk_acc, dv_acc = ring.shift(dk_acc), ring.shift(dv_acc)
        src = (me - step) % n
        early = src < me
        ka, kb = _zz_split(k_cur, c)
        va, vb = _zz_split(v_cur, c)

        dq1, dk1, dv1 = bwd(_where(early, qa, qb), ka, va, _where(early, out_a, out_b),
                            _where(early, lse_a, lse_b), _where(early, ga, gb), False)
        zero = torch.zeros_like(dq1)
        dq_a = dq_a + _where(early, dq1, zero)
        dq_b = dq_b + _where(early, zero, dq1)

        dq2, dk2, dv2 = bwd(qb, _where(early, ka, kb), _where(early, va, vb), out_b, lse_b, gb,
                            False)
        dq_b = dq_b + dq2
        zero = torch.zeros_like(dk2)
        dk_acc = dk_acc + torch.cat([dk1 + _where(early, dk2, zero), _where(early, zero, dk2)],
                                    dim=-2)
        dv_acc = dv_acc + torch.cat([dv1 + _where(early, dv2, zero), _where(early, zero, dv2)],
                                    dim=-2)

    dk_acc, dv_acc = ring.shift(dk_acc), ring.shift(dv_acc)
    dq = torch.cat([dq_a, dq_b], dim=-2)
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _ZigzagRingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, block_q, block_k):
        out, lse = _zz_flash_fwd(q, k, v, ring, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_zz_flash_bwd(*ctx.saved_tensors, g, *ctx.args), None, None, None)


def zigzag_ring_flash_attention(q, k, v, ring, block_q: int = 256, block_k: int = 256):
    """The zig-zag ring with the flash kernel per sub-block: two half-size
    kernel calls per step (three on the diagonal step), merged by log-sum-exp;
    the backward re-runs the block backward per sub-block against the GLOBAL
    per-chunk output and logsumexp and routes dK/dV home around the ring.
    Use the zig-zag layout (:func:`zigzag_indices`, :func:`zigzag_positions`);
    the chunk length ``S_local/2`` must divide by the block sizes."""
    return _ZigzagRingFlash.apply(q, k, v, ring, block_q, block_k)


# ----------------------------------------------------- zig-zag schedule


def make_ring_attention(ring, causal: bool = True):
    """:func:`ring_self_attention` for callers outside a step: returns
    ``fn(q, k, v)`` over whole ``(B, H, S, D)`` tensors, whose S is cut into
    ``ring.size`` contiguous shards stacked on a leading rank dim, attended
    around ``ring`` (a :class:`~parallel.mesh.StackedRing`: every shard on
    the tensors' device) and put back in order.  Differentiable.  The JAX
    function's ``(mesh, axis)`` is the ring here."""
    if not isinstance(ring, StackedRing):
        raise TypeError(f"make_ring_attention needs a StackedRing, got {type(ring).__name__}")
    n = ring.size

    def shards(x):
        b, h, s, d = x.shape
        if s % n:
            raise ValueError(f"sequence length {s} is not divisible by the ring size {n}")
        return x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4)

    def fn(q, k, v):
        out = ring_self_attention(shards(q), shards(k), shards(v), ring, causal=causal)
        return out.permute(1, 2, 0, 3, 4).reshape(q.shape)

    return fn


def zigzag_indices(seq_len: int, n_shards: int) -> torch.Tensor:
    """Global token order for zig-zag sharding: ``x[..., perm]`` cut into
    ``n_shards`` contiguous shards gives shard ``i`` the chunks
    ``(i, 2n-1-i)`` of the original sequence.  ``seq_len`` must divide by
    ``2 * n_shards``."""
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"zig-zag needs seq_len ({seq_len}) divisible by 2*n_shards ({2 * n_shards})"
        )
    c = seq_len // (2 * n_shards)
    parts = []
    for i in range(n_shards):
        parts.append(torch.arange(i * c, (i + 1) * c))
        parts.append(torch.arange((2 * n_shards - 1 - i) * c, (2 * n_shards - i) * c))
    return torch.cat(parts)


def zigzag_inverse_indices(seq_len: int, n_shards: int) -> torch.Tensor:
    """Inverse permutation: maps the zig-zag layout back to global order."""
    return torch.argsort(zigzag_indices(seq_len, n_shards))


def zigzag_positions(axis_index, s_local: int, n_shards: int) -> torch.Tensor:
    """Global positions of the tokens of the zig-zag shards ``axis_index``
    (an int, or a tensor of rank ids such as ``ring.index()``): shape
    ``(*axis_index.shape, s_local)``."""
    idx = torch.as_tensor(axis_index)[..., None]
    c = s_local // 2
    offsets = torch.arange(c, device=idx.device)
    return torch.cat([idx * c + offsets, (2 * n_shards - 1 - idx) * c + offsets], dim=-1)
