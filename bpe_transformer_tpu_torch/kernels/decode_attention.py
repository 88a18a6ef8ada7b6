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
256, the group in chunks of 1, 2, 4 or 8 heads).  Launches are counted
in ``kernels/_build.py`` under ``decode_attention`` and
``paged_decode_attention``.
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


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device).reshape(-1)
    if pos.numel() not in (1, batch):
        raise ValueError(f"pos has {pos.numel()} entries for a batch of {batch}")
    return pos.expand(batch)


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
    for CUDA tensors, :func:`decode_attention_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    batch, num_heads, d = q.shape
    b2, kv_heads, ctx, d2 = k_cache.shape
    if (b2, d2) != (batch, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_cache {tuple(k_cache.shape)}, "
            f"v_cache {tuple(v_cache.shape)}"
        )
    width, chunk, n_chunks, _ = decode_geometry(num_heads, kv_heads, d)
    q = q.contiguous()
    pos_b = _pos_vector(pos, batch, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    code, stream = _build.kernel_args("decode_attention", q, k_cache, v_cache, out)
    fn = _build.entry("decode_attention", "decode_attention_launch", 5, 8)
    rc = fn(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_b.data_ptr(), out.data_ptr(), batch, num_heads, kv_heads, ctx, width, d,
        chunk, n_chunks, stream,
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
    :func:`paged_decode_attention_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    _check_paged(q, k_pool, v_pool, tables, k_scale, v_scale)
    slots, num_heads, d = q.shape
    _, kv_heads, block_size, _ = k_pool.shape
    nbs = tables.shape[1]
    width, chunk, n_chunks, _ = decode_geometry(num_heads, kv_heads, d)
    if nbs > 4096:
        raise ValueError(f"blocks_per_slot={nbs} unsupported by the kernel (at most 4096)")
    quantized = k_pool.dtype == torch.int8
    if not quantized and k_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} must be q's ({q.dtype}) or int8")
    q = q.contiguous()
    tables32 = tables.to(torch.int32).contiguous()
    pos_b = _pos_vector(pos, slots, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scales = (k_scale, v_scale) if quantized else ()
    for s in scales:
        if s.dtype != torch.float32:
            raise ValueError(f"k_scale/v_scale must be float32, got {s.dtype}")
    code, stream = _build.kernel_args(
        "paged_decode_attention", q, out, f32=scales,
        others=(k_pool, v_pool, tables32, pos_b),
    )
    kv_code = _build.INT8_CODE if quantized else code
    fn = _build.entry("paged_decode_attention", "paged_decode_attention_launch", 8, 10)
    rc = fn(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables32.data_ptr(),
        pos_b.data_ptr(), k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, out.data_ptr(), kv_code, slots,
        num_heads, kv_heads, block_size, nbs, width, d, chunk, n_chunks, stream,
    )
    _build.check(rc, "paged_decode_attention")
    _build.count("paged_decode_attention")
    return out
