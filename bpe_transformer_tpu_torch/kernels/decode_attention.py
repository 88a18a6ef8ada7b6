"""Decode-step attention against the dense KV cache and through the block
table of the paged KV pool (port of
``bpe_transformer_tpu/kernels/pallas/decode_attention.py::decode_attention``
and ``::paged_decode_attention``).

Shapes (GQA-native: the cache holds ``kv_heads`` heads and query head ``h``
reads kv head ``h // (num_heads // kv_heads)``):

* ``q``        (batch, num_heads, d_head), RoPE already applied
* ``k_cache``  (batch, kv_heads, ctx, d_head)
* ``v_cache``  (batch, kv_heads, ctx, d_head)
* ``pos``      int or (batch,) integer tensor: attend to cache rows 0..pos
* returns      (batch, num_heads, d_head) in ``q``'s dtype

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors and runs :func:`decode_attention_plain` for CPU tensors.

:func:`paged_decode_attention` takes the paged pool instead of the cache:

* ``k_pool``/``v_pool`` (num_blocks, kv_heads, block_size, d_head), at
  ``q``'s dtype or int8
* ``tables``   (batch, blocks_per_slot) integer: slot ``s``'s key ``j`` is
  row ``j % block_size`` of pool block ``tables[s, j // block_size]``
* ``k_scale``/``v_scale`` (num_blocks, kv_heads) float32, given exactly for
  int8 pools (one scale per block and kv head)

It launches ``csrc/paged_decode_attention.cu`` for CUDA tensors and runs
:func:`paged_decode_attention_plain` for CPU tensors.

Both kernels take any ``d_head`` and any group ``num_heads // kv_heads``,
as the JAX functions do (:func:`decode_geometry`: the head dim runs at the
next instantiated register width, or above 256 in output-column chunks of
256, the group in chunks of 1, 2, 4 or 8 heads).  Both split each slot's
keys into spans (:func:`decode_splits`; the paged kernel over the
``blocks_per_slot * block_size`` keys a slot can hold), one block each,
merged in the same launch through a float32 workspace and arrival counters
that the wrapper keeps per device and stream (:func:`_split_workspace`,
shared by the two kernels).  Both read the engines' int32 or int64 position
vectors and the paged engine's int32 table as they are (no conversion
launch).
Launches are counted in ``kernels/_build.py`` under ``decode_attention``
and ``paged_decode_attention``.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.kernels.flash_attention import col_chunks, padded_head_dim

#: Query-head chunks the kernels are instantiated for (at most 4 heads at the
#: 256-wide register tile, whose merge buffer would not fit shared memory).
GROUP_CHUNKS = (1, 2, 4, 8)


def decode_geometry(num_heads: int, kv_heads: int, d: int) -> tuple[int, int, int, int]:
    """``(width, chunk, n_chunks, col_chunks)`` of a decode kernel launch:
    the width the head dim ``d`` runs at (:func:`padded_head_dim`), the
    query group ``num_heads // kv_heads`` cut into ``n_chunks`` chunks of
    ``chunk`` heads, the smallest instantiated chunk that holds the group
    (or the largest, repeated), and the output-column chunks of the width
    (:func:`col_chunks`, one per block)."""
    if kv_heads < 1 or num_heads % kv_heads:
        raise ValueError(f"num_heads={num_heads} not divisible by kv_heads={kv_heads}")
    width = padded_head_dim(d)
    group = num_heads // kv_heads
    chunks = [c for c in GROUP_CHUNKS if width <= 128 or c <= 4]
    chunk = next((c for c in chunks if c >= group), chunks[-1])
    return width, chunk, -(-group // chunk), col_chunks(width)


#: Keys a decode block owns (one split of a slot's keys), the most splits a
#: slot is cut into before the span grows (in steps of SPLIT_KEYS), and the
#: most keys a span may have (csrc/decode_common.cuh MAX_SPAN: the kernels
#: keep a span's scores in shared memory).  Spans of 32 to 256 keys were
#: timed side by side at the GPT2_SMALL_32K tick: 64 was the fastest, for
#: the dense kernel and for the paged one at int8 and act width (PERF.md,
#: B1 and B7).
SPLIT_KEYS = 64
MAX_SPLITS = 32
MAX_SPAN = 256


def decode_splits(ctx: int) -> tuple[int, int]:
    """``(n_splits, span)`` of a decode launch over ``ctx`` keys a slot (a
    dense cache's rows, or a paged slot's ``blocks_per_slot * block_size``):
    spans of :data:`SPLIT_KEYS` keys, widened by multiples of it up to
    :data:`MAX_SPAN` where more than :data:`MAX_SPLITS` would be needed."""
    if ctx < 1:
        raise ValueError(f"ctx={ctx}: need ctx >= 1")
    span = min(MAX_SPAN, SPLIT_KEYS * -(-ctx // (SPLIT_KEYS * MAX_SPLITS)))
    return -(-ctx // span), span


#: (counters, workspace) of the decode kernels' split merge, per
#: (device, stream): the counters are zero between launches (the merging
#: block resets its own), the workspace holds no state between them.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
#: Outgrown workspaces, kept alive: a captured CUDA graph may still use them.
_retired: list[tuple[torch.Tensor, torch.Tensor]] = []


def _split_workspace(device, n_counters: int, n_floats: int):
    """The cached ``(counters, workspace)`` of ``device`` and its current
    stream, grown (never shrunk) to ``n_counters`` int32 and ``n_floats``
    float32.  Calls on one stream run in order, so they can share them;
    calls on two streams get one each.  Growing inside a CUDA graph capture
    allocates from the graph's pool and zeroes the counters at every
    replay."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device.index, stream.cuda_stream)
    counters, ws = _workspaces.get(key, (None, None))
    if counters is None or counters.numel() < n_counters or ws.numel() < n_floats:
        old_c, old_w = (0, 0) if counters is None else (counters.numel(), ws.numel())
        if counters is not None:
            _retired.append((counters, ws))
        counters = torch.zeros(max(n_counters, 2 * old_c), dtype=torch.int32, device=device)
        ws = torch.empty(max(n_floats, 2 * old_w), dtype=torch.float32, device=device)
        _workspaces[key] = (counters, ws)
    return counters, ws


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device).reshape(-1)
    if pos.numel() not in (1, batch):
        raise ValueError(f"pos has {pos.numel()} entries for a batch of {batch}")
    return pos.expand(batch)


def _pos_arg(pos, batch: int, device) -> tuple[torch.Tensor, int]:
    """``pos`` as the dense kernel reads it, with its code (0 int32, 1
    int64): an engine's contiguous int32/int64 position vector as it is (no
    conversion launch), anything else converted to int32."""
    pos_b = _pos_vector(pos, batch, device)
    if pos_b.dtype in (torch.int32, torch.int64) and pos_b.is_contiguous():
        return pos_b, int(pos_b.dtype == torch.int64)
    return pos_b.to(torch.int32).contiguous(), 0


def decode_attention_plain(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Materialized-scores reference: float32 scores, softmax and weighted
    sum over rows ``0..pos[b]``, cast to ``q``'s dtype at the end."""
    batch, num_heads, d = q.shape
    kv_heads, ctx = k_cache.shape[1], k_cache.shape[2]
    group = num_heads // kv_heads
    qg = q.float().reshape(batch, kv_heads, group, d)
    scores = torch.einsum("bkgd,bkcd->bkgc", qg, k_cache.float()) / d**0.5
    pos_b = _pos_vector(pos, batch, q.device)
    visible = torch.arange(ctx, device=q.device)[None, :] <= pos_b[:, None]
    scores = scores.masked_fill(~visible[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", probs, v_cache.float())
    return out.reshape(batch, num_heads, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One decode step of attention (see module docstring): the CUDA kernel
    for CUDA tensors, :func:`decode_attention_plain` for CPU tensors.

    The kernel merges its key spans through a workspace and arrival
    counters that every call on the same device and stream shares
    (:func:`_split_workspace`); the counters must be zero when a launch
    starts, and the launch leaves them so.  So two launches that share them
    must not overlap: replays of CUDA graphs captured on one stream must not
    run at once on two streams, and a launch that did not run to its end
    (a device fault) leaves them unusable, as it leaves the context."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    batch, num_heads, d = q.shape
    b2, kv_heads, ctx, d2 = k_cache.shape
    if (b2, d2) != (batch, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_cache {tuple(k_cache.shape)}, "
            f"v_cache {tuple(v_cache.shape)}"
        )
    width, chunk, n_chunks, n_cols = decode_geometry(num_heads, kv_heads, d)
    n_splits, span = decode_splits(ctx)
    q = q.contiguous()
    pos_b, pos_code = _pos_arg(pos, batch, q.device)
    out = torch.empty_like(q)
    code, stream = _build.kernel_args("decode_attention", q, k_cache, v_cache, out)
    n_groups = batch * kv_heads * n_chunks * n_cols
    counters, ws = _split_workspace(
        q.device, n_groups, n_groups * n_splits * chunk * (min(width, 256) + 2))
    fn = _build.entry("decode_attention", "decode_attention_launch", 7, 11)
    rc = fn(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_b.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), pos_code,
        batch, num_heads, kv_heads, ctx, width, d, chunk, n_chunks, n_splits, span, stream,
    )
    _build.check(rc, "decode_attention")
    _build.count("decode_attention")
    return out


def _check_paged(q, k_pool, v_pool, tables, k_scale, v_scale) -> None:
    """The JAX function's argument checks, with its ``ValueError`` texts."""
    slots, num_heads, d = q.shape
    num_blocks, kv_heads, _, d2 = k_pool.shape
    if d2 != d or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
            f"v_pool {tuple(v_pool.shape)}"
        )
    if tables.ndim != 2 or tables.shape[0] != slots:
        raise ValueError(
            f"tables {tuple(tables.shape)} must be (slots={slots}, blocks_per_slot)"
        )
    if num_heads % kv_heads:
        raise ValueError(f"num_heads={num_heads} not divisible by kv_heads={kv_heads}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None) or quantized != (k_pool.dtype == torch.int8):
        raise ValueError("k_scale/v_scale must both be given exactly for int8 pools")
    if quantized and (
        k_scale.shape != (num_blocks, kv_heads) or v_scale.shape != k_scale.shape
    ):
        raise ValueError(
            f"k_scale {tuple(k_scale.shape)} must be (num_blocks={num_blocks}, "
            f"kv_heads={kv_heads})"
        )


def paged_decode_attention_plain(
    q, k_pool, v_pool, tables, pos, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Reference: gather each slot's blocks through its table (dequantizing
    an int8 pool in float32 with each block's scale), attend over keys
    ``0..pos`` as :func:`decode_attention_plain`, cast to ``q``'s dtype."""
    from bpe_transformer_tpu_torch.models.decode import (
        gather_paged_kv,
        gather_paged_kv_dequant,
    )

    _check_paged(q, k_pool, v_pool, tables, k_scale, v_scale)
    if k_scale is None:
        k, v = gather_paged_kv(k_pool, tables), gather_paged_kv(v_pool, tables)
    else:
        k = gather_paged_kv_dequant(k_pool, k_scale, tables, torch.float32)
        v = gather_paged_kv_dequant(v_pool, v_scale, tables, torch.float32)
    return decode_attention_plain(q.float(), k.float(), v.float(), pos).to(q.dtype)


def paged_decode_attention(
    q, k_pool, v_pool, tables, pos, *, k_scale=None, v_scale=None
) -> torch.Tensor:
    """One decode step of attention read through the block table (see module
    docstring): the CUDA kernel for CUDA tensors,
    :func:`paged_decode_attention_plain` for CPU tensors.  The kernel shares
    :func:`decode_attention`'s split workspace and its rules for
    overlapping launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    _check_paged(q, k_pool, v_pool, tables, k_scale, v_scale)
    slots, num_heads, d = q.shape
    _, kv_heads, block_size, _ = k_pool.shape
    nbs = tables.shape[1]
    width, chunk, n_chunks, n_cols = decode_geometry(num_heads, kv_heads, d)
    quantized = k_pool.dtype == torch.int8
    if not quantized and k_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} must be q's ({q.dtype}) or int8")
    n_splits, span = decode_splits(nbs * block_size)
    q = q.contiguous()
    tables32 = tables.to(torch.int32).contiguous()  # the engine's own table: no copy
    pos_b, pos_code = _pos_arg(pos, slots, q.device)
    out = torch.empty_like(q)
    scales = (k_scale, v_scale) if quantized else ()
    for s in scales:
        if s.dtype != torch.float32:
            raise ValueError(f"k_scale/v_scale must be float32, got {s.dtype}")
    code, stream = _build.kernel_args(
        "paged_decode_attention", q, out, f32=scales,
        others=(k_pool, v_pool, tables32, pos_b),
    )
    n_groups = slots * kv_heads * n_chunks * n_cols
    counters, ws = _split_workspace(
        q.device, n_groups, n_groups * n_splits * chunk * (min(width, 256) + 2))
    kv_code = _build.INT8_CODE if quantized else code
    fn = _build.entry("paged_decode_attention", "paged_decode_attention_launch", 10, 13)
    rc = fn(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables32.data_ptr(),
        pos_b.data_ptr(), k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, out.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), kv_code, pos_code, slots, num_heads, kv_heads, block_size, nbs,
        width, d, chunk, n_chunks, n_splits, span, stream,
    )
    _build.check(rc, "paged_decode_attention")
    _build.count("paged_decode_attention")
    return out
