"""KV-cached decoding over the dense cache and over the paged block pool
(port of ``bpe_transformer_tpu/models/decode.py``).

The cache is a list, one dict per layer, of ``(batch, kv_heads,
context_length, d_head)`` K and V tensors.  Unlike the JAX package, which
returns a new cache, :func:`prefill` and :func:`decode_step` write the cache
tensors they are given IN PLACE (and also return the list, so a caller may
be written the JAX way).  The semantics are the JAX package's:

* prefill writes the K/V rows of the whole (bucket-padded) prompt from row 0;
* a decode step writes each sequence's K/V at its own ``pos`` before it
  attends, so the attention includes position ``pos``;
* sequences whose ``active`` flag is False keep their cache rows.

Kernels: ``attention_impl`` "flash"/"flash_fused" runs the flash kernel in
prefill, ``ffn_impl="pallas"`` the fused SwiGLU kernel in every FFN (a
``gelu`` FFN runs the GeLU kernel whatever ``ffn_impl`` says), and
``decode_attention_impl`` "pallas"/"paged" the flash-decoding kernel in
every step (the dense cache has no block table, so "paged" means "pallas"
here, as in the JAX package).  int8 quantized weights send every linear and
the head to the int8 matmul kernel.  An MoE FFN routes each call's tokens
with the capacity of :func:`_ffn_decode`, so a decode step drops no token.

The paged twins (:func:`init_kv_pool`, :func:`paged_decode_step`,
:func:`paged_chunk_prefill`, and the speculative verify pass
:func:`paged_verify_step`) read and write KV through a block table: the
pool holds per layer ``(num_blocks, kv_heads, block_size, d_head)`` K and V
blocks, block 0 is the trash block that masked writes go to, and a slot's
cache is its chain of block ids.  They too write the pool IN PLACE.  An
int8 pool (``kv_dtype="int8"``) stores one byte per value with one float32
scale per (block, kv head) in ``k_scale``/``v_scale`` ``(num_blocks,
kv_heads)``.  ``decode_attention_impl="paged"`` runs the paged
flash-decoding kernel straight against the pool; "pallas" gathers each
slot's cache and runs the dense kernel, "xla" gathers and runs the plain
attention.  Chunk prefill attends with materialized scores (the JAX
package runs no kernel there either).
"""

from __future__ import annotations

import math

import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.moe import expert_capacity
from bpe_transformer_tpu_torch.models.transformer import (
    Params,
    _ffn,
    _maybe_norm,
    lm_head_weight,
)
from bpe_transformer_tpu_torch.ops.core import (
    embedding,
    head_logits,
    linear,
    merge_heads,
    split_heads,
)
from bpe_transformer_tpu_torch.ops.rope import apply_rope, cached_rope_tables

KVCache = list  # [{"k": (B, KV, ctx, dh), "v": (B, KV, ctx, dh)} per layer]


def init_kv_cache(
    config: ModelConfig,
    batch: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> KVCache:
    """Zeroed per-layer K/V buffers; GQA stores only ``num_kv_heads``."""
    dev = resolve_device(device)
    kv_heads = config.num_kv_heads or config.num_heads
    shape = (batch, kv_heads, config.context_length, config.d_head)
    return [
        {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
        for _ in range(config.num_layers)
    ]


def _rope_qk(q, k, positions, config: ModelConfig):
    if config.remove_rope:
        return q, k
    # Tables at the compute dtype (bf16 decode must not promote to f32).
    cos, sin = cached_rope_tables(
        config.d_head, config.context_length, config.rope_theta, q.dtype, q.device
    )
    pos = positions.unsqueeze(-2)  # broadcast over heads
    return apply_rope(q, pos, cos, sin), apply_rope(k, pos, cos, sin)


def _ffn_decode(x, ffn, config: ModelConfig):
    """The training forward's FFN with the aux loss discarded.

    An MoE FFN gets the capacity the full forward at ``context_length``
    would use, ``expert_capacity(batch * context_length)``, floored at the
    batch (a one-token step of many experts over a tiny context) and clamped
    to this call's token count (a token fills at most one slot per expert,
    so that many slots drop nothing).  A per-call default (``batch`` tokens
    at a decode step, the prompt at prefill) would drop tokens the full
    forward keeps.  With this one a decode step never drops, and a prefill
    or chunk of more tokens than the capacity drops only what a full
    forward's capacity would.
    """
    moe_capacity = None
    if config.ffn_type == "moe":
        full_forward_cap = expert_capacity(
            x.shape[0] * config.context_length, config.n_experts, config.capacity_factor
        )
        moe_capacity = min(math.prod(x.shape[:-1]), max(full_forward_cap, x.shape[0]))
    return _ffn(x, ffn, config, moe_capacity=moe_capacity)[0]


def _block_apply(x, block_params, config: ModelConfig, attend):
    """One block around ``attend(h)``: pre-norm by default, post-norm under
    the ``use_post_norm`` ablation."""
    if config.use_post_norm:
        x = _maybe_norm(x + attend(x), block_params["ln1"], config)
        f = _ffn_decode(x, block_params["ffn"], config)
        return _maybe_norm(x + f, block_params["ln2"], config)
    h = _maybe_norm(x, block_params["ln1"], config)
    x = x + attend(h)
    h = _maybe_norm(x, block_params["ln2"], config)
    return x + _ffn_decode(h, block_params["ffn"], config)


def _project_qkv(h, attn, config: ModelConfig):
    kv_heads = config.num_kv_heads or config.num_heads
    q = split_heads(linear(h, attn["q_proj"]), config.num_heads)
    k = split_heads(linear(h, attn["k_proj"]), kv_heads)
    v = split_heads(linear(h, attn["v_proj"]), kv_heads)
    return q, k, v


def _expand_kv(x, config: ModelConfig):
    """Repeat each KV head over its consecutive query heads (no-op for MHA)."""
    kv_heads = config.num_kv_heads or config.num_heads
    if kv_heads == config.num_heads:
        return x
    return x.repeat_interleave(config.num_heads // kv_heads, dim=1)


def prefill(
    params: Params,
    token_ids: torch.Tensor,
    config: ModelConfig,
    cache: KVCache,
    lm_head: torch.Tensor | None = None,
    last_pos: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Run ``token_ids`` (batch, prompt_len) through the model, writing K/V
    rows ``0..prompt_len-1`` of ``cache`` in place.  Returns float32 logits
    ``(batch, vocab)`` of the last position, or of position ``last_pos[b]``
    per sequence (the serving engine pads prompts to a bucket; causal
    masking keeps positions ``<= last_pos`` clear of the padding)."""
    batch, plen = token_ids.shape
    positions = torch.arange(plen, device=token_ids.device)
    x = embedding(params["token_embeddings"], token_ids)
    use_flash = config.attention_impl in ("flash", "flash_fused")
    if use_flash:
        from bpe_transformer_tpu_torch.kernels.flash_attention import flash_attention
    else:
        scale = config.d_head**-0.5
        mask = torch.ones(plen, plen, dtype=torch.bool, device=x.device).tril()

    for block_params, layer_cache in zip(params["layers"], cache):

        def attend(h, block_params=block_params, layer_cache=layer_cache):
            q, k, v = _project_qkv(h, block_params["attn"], config)
            q, k = _rope_qk(q, k, positions, config)
            layer_cache["k"][:, :, :plen] = k
            layer_cache["v"][:, :, :plen] = v
            k, v = _expand_kv(k, config), _expand_kv(v, config)
            if use_flash:
                att = flash_attention(q, k, v, causal=True)
            else:
                scores = torch.matmul(q, k.transpose(-1, -2)) * scale
                scores = scores.masked_fill(~mask, float("-inf"))
                probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
                att = torch.matmul(probs, v)
            return linear(merge_heads(att), block_params["attn"]["output_proj"])

        x = _block_apply(x, block_params, config, attend)

    x = _maybe_norm(x, params["ln_final"], config)
    head = lm_head_weight(params, config) if lm_head is None else lm_head
    if last_pos is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(batch, device=x.device), last_pos.reshape(-1)]
    return head_logits(last, head), cache


def _cache_write(buf, new, pos, active):
    """Write ``new`` (B, KV, 1, dh) into ``buf`` at each sequence's ``pos``
    (B,), only where ``active`` (B,) bool is set; no host sync."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    pos = pos.clamp(max=buf.shape[2] - 1)
    value = new[:, :, 0]
    if active is not None:
        value = torch.where(active[:, None, None], value, buf[rows, :, pos])
    buf[rows, :, pos] = value


def decode_step(
    params: Params,
    token: torch.Tensor,
    pos,
    cache: KVCache,
    config: ModelConfig,
    lm_head: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """One cached decode step for ``token`` (batch,) at position ``pos`` (an
    int for the whole batch, or a (batch,) tensor, one per sequence).
    Writes the step's K/V into ``cache`` in place (only for ``active``
    sequences when given) and returns float32 logits ``(batch, vocab)``;
    inactive rows' logits are computed and meant to be discarded.

    ``return_hidden=True`` skips the head projection and returns the
    final-norm hidden state ``(batch, d_model)`` instead: the fused
    head + sample kernel (``kernels/sample.py``) projects it itself."""
    batch = token.shape[0]
    pos_b = torch.as_tensor(pos, device=token.device).reshape(-1).expand(batch)
    positions = pos_b[:, None]  # (B, 1)
    x = embedding(params["token_embeddings"], token[:, None])  # (B, 1, d)
    use_kernel = config.decode_attention_impl in ("pallas", "paged")
    if use_kernel:
        from bpe_transformer_tpu_torch.kernels.decode_attention import decode_attention
    else:
        from bpe_transformer_tpu_torch.kernels.decode_attention import (
            decode_attention_plain as decode_attention,
        )

    for block_params, layer_cache in zip(params["layers"], cache):

        def attend(h, block_params=block_params, layer_cache=layer_cache):
            q, k, v = _project_qkv(h, block_params["attn"], config)
            q, k = _rope_qk(q, k, positions, config)
            _cache_write(layer_cache["k"], k, pos_b, active)
            _cache_write(layer_cache["v"], v, pos_b, active)
            att = decode_attention(q[:, :, 0], layer_cache["k"], layer_cache["v"], pos_b)
            att = merge_heads(att[:, :, None, :])
            return linear(att, block_params["attn"]["output_proj"])

        x = _block_apply(x, block_params, config, attend)

    x = _maybe_norm(x, params["ln_final"], config)
    if return_hidden:
        return x[:, 0], cache
    head = lm_head_weight(params, config) if lm_head is None else lm_head
    return head_logits(x[:, 0], head), cache


# --------------------------------------------------------- paged KV memory


def init_kv_pool(
    config: ModelConfig,
    num_blocks: int,
    block_size: int,
    dtype: torch.dtype = torch.float32,
    kv_dtype: str | None = None,
    device: str | torch.device = "cuda",
) -> KVCache:
    """A zeroed paged KV pool: per layer ``(num_blocks, kv_heads,
    block_size, d_head)`` K and V blocks at ``dtype``, or int8 with zeroed
    float32 ``k_scale``/``v_scale`` ``(num_blocks, kv_heads)`` under
    ``kv_dtype="int8"``."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f'kv_dtype={kv_dtype!r} must be None or "int8"')
    dev = resolve_device(device)
    kv_heads = config.num_kv_heads or config.num_heads
    shape = (num_blocks, kv_heads, block_size, config.d_head)
    store = torch.int8 if kv_dtype == "int8" else dtype
    layers: KVCache = []
    for _ in range(config.num_layers):
        layer = {
            "k": torch.zeros(shape, dtype=store, device=dev),
            "v": torch.zeros(shape, dtype=store, device=dev),
        }
        if kv_dtype == "int8":
            layer["k_scale"] = torch.zeros((num_blocks, kv_heads), dtype=torch.float32, device=dev)
            layer["v_scale"] = torch.zeros((num_blocks, kv_heads), dtype=torch.float32, device=dev)
        layers.append(layer)
    return layers


def gather_paged_kv(buf: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Contiguous per-slot KV from the pool through the block table: ``buf``
    (num_blocks, kv_heads, block_size, d_head) gathered by ``tables``
    (slots, blocks_per_slot) -> (slots, kv_heads, blocks_per_slot *
    block_size, d_head), the dense cache's layout."""
    g = buf[tables.long()]  # (S, nb, kv, bs, dh)
    s, nb, kv, bs, dh = g.shape
    return g.transpose(1, 2).reshape(s, kv, nb * bs, dh)


def gather_paged_kv_dequant(buf, scale, tables, dtype) -> torch.Tensor:
    """:func:`gather_paged_kv` of an int8 pool, dequantized with each
    block's (block, kv head) scale and cast to ``dtype``."""
    bs = buf.shape[2]
    gathered = gather_paged_kv(buf, tables)  # (S, kv, nb*bs, dh)
    scales = scale[tables.long()].transpose(1, 2)  # (S, kv, nb)
    scales = scales.repeat_interleave(bs, dim=2)[..., None]
    return (gathered.float() * scales).to(dtype)


def _quantize_decode_row(pool_arr, scale_arr, new_row, write_ids, offsets) -> None:
    """Write one new KV row per slot into an int8 pool IN PLACE, keeping the
    per-block scale sound under incremental writes.

    ``new_row`` (slots, kv_heads, d_head) lands at ``(write_ids[s], :,
    offsets[s], :)``.  The block scale only grows within one occupancy:
    ``offset == 0`` starts a fresh block (blocks are recycled without
    zeroing) and resets the base scale to 0; otherwise the row's absmax is
    folded in and, when the scale grew, the block's int8 rows are rescaled by
    ``old / new`` (<= 1).  One block per slot is touched."""
    blk = pool_arr[write_ids].float()  # (S, kv, bs, d)
    s_old = scale_arr[write_ids]  # (S, kv)
    s_base = torch.where(offsets[:, None] == 0, torch.zeros_like(s_old), s_old)
    amax = new_row.float().abs().amax(dim=-1)  # (S, kv)
    s_new = torch.maximum(s_base, amax / 127.0)
    safe = s_new.clamp(min=1e-30)
    # Factor 0 on fresh blocks zeroes the recycled rows too.
    factor = s_base / safe
    blk = torch.round(blk * factor[:, :, None, None])
    row_q = torch.round(new_row.float() / safe[:, :, None]).clamp(-127, 127)
    sel = (
        torch.arange(blk.shape[2], device=blk.device)[None, None, :, None]
        == offsets[:, None, None, None]
    )
    blk = torch.where(sel, row_q[:, :, None, :], blk)
    pool_arr[write_ids] = blk.to(torch.int8)
    scale_arr[write_ids] = s_new


def paged_decode_step(
    params: Params,
    token: torch.Tensor,
    pos: torch.Tensor,
    pool: KVCache,
    tables: torch.Tensor,
    config: ModelConfig,
    lm_head=None,
    active: torch.Tensor | None = None,
    return_hidden: bool = False,
    *,
    block_size: int,
) -> tuple[torch.Tensor, KVCache]:
    """One cached decode step against the paged pool, the block-table twin
    of :func:`decode_step` (``return_hidden`` as there).
    ``token``/``pos``/``active`` are ``(slots,)``; ``tables`` (slots,
    blocks_per_slot) maps each slot's logical block to a
    pool block id (0 = trash).  The new K/V lands at ``(tables[s, pos //
    block_size], pos % block_size)``, inactive slots' at the trash block (an
    int8 pool quantizes the row as it writes, :func:`_quantize_decode_row`);
    then attention per ``config.decode_attention_impl`` (module
    docstring).  Writes the pool in place and returns float32 logits
    ``(slots, vocab)``."""
    x = embedding(params["token_embeddings"], token[:, None])  # (S, 1, d)
    positions = pos[:, None]
    offsets = pos % block_size
    write_ids = torch.gather(tables.long(), 1, (pos // block_size)[:, None].long())[:, 0]
    if active is not None:
        write_ids = torch.where(active, write_ids, torch.zeros_like(write_ids))
    quantized = "k_scale" in pool[0]
    impl = config.decode_attention_impl
    if impl == "paged":
        from bpe_transformer_tpu_torch.kernels.decode_attention import paged_decode_attention
    elif impl == "pallas":
        from bpe_transformer_tpu_torch.kernels.decode_attention import decode_attention
    else:
        from bpe_transformer_tpu_torch.kernels.decode_attention import (
            decode_attention_plain as decode_attention,
        )

    for block_params, layer_pool in zip(params["layers"], pool):

        def attend(h, block_params=block_params, layer_pool=layer_pool):
            q, k, v = _project_qkv(h, block_params["attn"], config)
            q, k = _rope_qk(q, k, positions, config)
            if quantized:
                _quantize_decode_row(
                    layer_pool["k"], layer_pool["k_scale"], k[:, :, 0], write_ids, offsets
                )
                _quantize_decode_row(
                    layer_pool["v"], layer_pool["v_scale"], v[:, :, 0], write_ids, offsets
                )
            else:
                layer_pool["k"][write_ids, :, offsets] = k[:, :, 0]
                layer_pool["v"][write_ids, :, offsets] = v[:, :, 0]
            if impl == "paged":
                att = paged_decode_attention(
                    q[:, :, 0], layer_pool["k"], layer_pool["v"], tables, pos,
                    k_scale=layer_pool.get("k_scale"), v_scale=layer_pool.get("v_scale"),
                )
            else:
                if quantized:
                    k_cache = gather_paged_kv_dequant(
                        layer_pool["k"], layer_pool["k_scale"], tables, h.dtype
                    )
                    v_cache = gather_paged_kv_dequant(
                        layer_pool["v"], layer_pool["v_scale"], tables, h.dtype
                    )
                else:
                    k_cache = gather_paged_kv(layer_pool["k"], tables)
                    v_cache = gather_paged_kv(layer_pool["v"], tables)
                att = decode_attention(q[:, :, 0], k_cache, v_cache, pos)
            att = merge_heads(att[:, :, None, :])
            return linear(att, block_params["attn"]["output_proj"])

        x = _block_apply(x, block_params, config, attend)

    x = _maybe_norm(x, params["ln_final"], config)
    if return_hidden:
        return x[:, 0], pool
    head = lm_head_weight(params, config) if lm_head is None else lm_head
    return head_logits(x[:, 0], head), pool


def paged_chunk_prefill(
    params: Params,
    chunk_tokens: torch.Tensor,
    start: int,
    chunk_len: int,
    table_row: torch.Tensor,
    pool: KVCache,
    config: ModelConfig,
    lm_head=None,
    *,
    block_size: int,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill ONE chunk of one slot's prompt into the paged pool.

    ``chunk_tokens`` (1, chunk_bucket) is the chunk padded to its bucket,
    ``start`` its first absolute position, ``chunk_len`` its real token
    count, ``table_row`` (blocks_per_slot,) the slot's block chain.  The
    chunk's K/V is written into the pool per position (padded rows go to the
    trash block), then the chunk's queries attend to the slot's whole
    gathered cache under the mask ``key_pos <= start + row``: materialized
    float32 scores, as the JAX package computes them (no flash kernel takes
    the chunk-vs-cache shape).  A chunk may so resume after a prefix-cache
    shared prefix or an earlier chunk.

    int8 pools: chunks start block-aligned, so every block the chunk touches
    is freshly owned; its scale is reset to the max over the chunk's rows in
    it, then the rows quantize against it.  Returns float32 logits ``(1,
    vocab)`` at the chunk's last real position (the pool is written in
    place)."""
    start, chunk_len = int(start), int(chunk_len)
    cb = chunk_tokens.shape[1]
    ctx = config.context_length
    nb = table_row.shape[0]
    dev = chunk_tokens.device
    table_row = table_row.long()
    rows = torch.arange(cb, device=dev)
    positions = start + rows
    # Padded tail rows may index past the RoPE tables: clamp them (their
    # outputs are discarded; their pool writes go to the trash block).
    safe_positions = positions.clamp(0, ctx - 1)
    in_chunk = rows < chunk_len
    idx_in_table = (safe_positions // block_size).clamp(0, nb - 1)
    write_ids = torch.where(in_chunk, table_row[idx_in_table], torch.zeros_like(idx_in_table))
    offsets = safe_positions % block_size
    quantized = "k_scale" in pool[0]

    x = embedding(params["token_embeddings"], chunk_tokens)
    scale = config.d_head**-0.5
    mask = torch.arange(nb * block_size, device=dev)[None, :] <= positions[:, None]

    def quant_chunk_rows(pool_arr, scale_arr, new_rows):
        """Reset the written blocks' scales to the max over the chunk's rows
        in each, then quantize every row against its block's scale."""
        amax = new_rows.float().abs().amax(dim=-1)  # (cb, kv)
        amax = torch.where(in_chunk[:, None], amax, torch.zeros_like(amax))
        scale_arr[write_ids] = 0.0
        scale_arr.scatter_reduce_(
            0, write_ids[:, None].expand_as(amax), amax / 127.0, reduce="amax"
        )
        per_row = scale_arr[write_ids].clamp(min=1e-30)  # (cb, kv)
        rows_q = torch.round(new_rows.float() / per_row[..., None]).clamp(-127, 127)
        pool_arr[write_ids, :, offsets] = rows_q.to(torch.int8)

    for block_params, layer_pool in zip(params["layers"], pool):

        def attend(h, block_params=block_params, layer_pool=layer_pool):
            q, k, v = _project_qkv(h, block_params["attn"], config)
            q, k = _rope_qk(q, k, safe_positions, config)
            k_rows, v_rows = k[0].transpose(0, 1), v[0].transpose(0, 1)  # (cb, kv, dh)
            if quantized:
                quant_chunk_rows(layer_pool["k"], layer_pool["k_scale"], k_rows)
                quant_chunk_rows(layer_pool["v"], layer_pool["v_scale"], v_rows)
                k_cache = gather_paged_kv_dequant(
                    layer_pool["k"], layer_pool["k_scale"], table_row[None], h.dtype
                )
                v_cache = gather_paged_kv_dequant(
                    layer_pool["v"], layer_pool["v_scale"], table_row[None], h.dtype
                )
            else:
                layer_pool["k"][write_ids, :, offsets] = k_rows
                layer_pool["v"][write_ids, :, offsets] = v_rows
                k_cache = gather_paged_kv(layer_pool["k"], table_row[None])
                v_cache = gather_paged_kv(layer_pool["v"], table_row[None])
            k_full, v_full = _expand_kv(k_cache, config), _expand_kv(v_cache, config)
            scores = torch.matmul(q, k_full.transpose(-1, -2)).float() * scale
            scores = scores.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(scores, dim=-1).to(h.dtype)
            att = merge_heads(torch.matmul(probs, v_full))
            return linear(att, block_params["attn"]["output_proj"])

        x = _block_apply(x, block_params, config, attend)

    x = _maybe_norm(x, params["ln_final"], config)
    head = lm_head_weight(params, config) if lm_head is None else lm_head
    last = x[:, min(max(chunk_len - 1, 0), cb - 1)]
    return head_logits(last, head), pool


def paged_verify_step(
    params: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    rooms: torch.Tensor,
    pool: KVCache,
    tables: torch.Tensor,
    config: ModelConfig,
    lm_head=None,
    active: torch.Tensor | None = None,
    return_hidden: bool = False,
    *,
    block_size: int,
) -> tuple[torch.Tensor, KVCache]:
    """The speculative-decoding verify forward: :func:`paged_decode_step`
    generalized from one token per slot to ``K+1``.

    ``tokens`` (slots, K+1) holds each slot's not-yet-written last token and
    its K draft proposals; ``positions`` (slots,) the absolute position of
    ``tokens[:, 0]``; ``rooms`` (slots,) how many proposal rows are real:
    rows ``0..rooms[s]`` are written, later rows, rows past the context and
    inactive slots write the trash block 0.  Every row's K/V scatters into
    the pool through the block table, then each row attends to its slot's
    gathered cache under the frontier ``key_pos <= positions + row``, with
    materialized float32 scores as :func:`paged_chunk_prefill` computes
    them (``decode_attention_impl`` governs the one-token tick only).
    Returns float32 logits ``(slots, K+1, vocab)``, row ``j`` the target
    distribution of position ``positions + j + 1`` (or the final-norm
    hidden states ``(slots, K+1, d_model)`` under ``return_hidden``); the
    pool is written in place.

    int8 pools quantize the K+1 rows one after another with
    :func:`_quantize_decode_row`, the order of K+1 plain ticks: rows land
    mid-block beside valid rows of earlier steps, which the chunk
    quantizer's scale reset would corrupt.  Readers then see each block's
    final scale, so int8 verify logits match K+1 plain ticks within the
    quantization error, not bit for bit (act width is exact)."""
    s, k1 = tokens.shape
    ctx = config.context_length
    nb = tables.shape[1]
    dev = tokens.device
    rows = torch.arange(k1, device=dev)
    pos_j = positions[:, None] + rows[None, :]  # (S, K+1)
    safe_pos = pos_j.clamp(0, ctx - 1)
    valid = (rows[None, :] <= rooms[:, None]) & (pos_j <= ctx - 1)
    if active is not None:
        valid = valid & active[:, None]
    idx = (safe_pos // block_size).clamp(0, nb - 1)
    write_ids = torch.where(valid, torch.gather(tables.long(), 1, idx), torch.zeros_like(idx))
    offsets = safe_pos % block_size
    quantized = "k_scale" in pool[0]

    x = embedding(params["token_embeddings"], tokens)  # (S, K+1, d)
    scale = config.d_head**-0.5
    # (S, 1, K+1, ctx): key j is visible to row i iff j <= pos_i.
    mask = (torch.arange(nb * block_size, device=dev)[None, None, :] <= pos_j[:, :, None])[:, None]

    for block_params, layer_pool in zip(params["layers"], pool):

        def attend(h, block_params=block_params, layer_pool=layer_pool):
            q, k, v = _project_qkv(h, block_params["attn"], config)
            q, k = _rope_qk(q, k, safe_pos, config)
            k_rows, v_rows = k.transpose(1, 2), v.transpose(1, 2)  # (S, K+1, kv, dh)
            if quantized:
                for j in range(k1):
                    _quantize_decode_row(layer_pool["k"], layer_pool["k_scale"], k_rows[:, j],
                                         write_ids[:, j], offsets[:, j])
                    _quantize_decode_row(layer_pool["v"], layer_pool["v_scale"], v_rows[:, j],
                                         write_ids[:, j], offsets[:, j])
                k_cache = gather_paged_kv_dequant(
                    layer_pool["k"], layer_pool["k_scale"], tables, h.dtype
                )
                v_cache = gather_paged_kv_dequant(
                    layer_pool["v"], layer_pool["v_scale"], tables, h.dtype
                )
            else:
                layer_pool["k"][write_ids, :, offsets] = k_rows
                layer_pool["v"][write_ids, :, offsets] = v_rows
                k_cache = gather_paged_kv(layer_pool["k"], tables)
                v_cache = gather_paged_kv(layer_pool["v"], tables)
            k_full, v_full = _expand_kv(k_cache, config), _expand_kv(v_cache, config)
            scores = torch.matmul(q, k_full.transpose(-1, -2)).float() * scale
            scores = scores.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(scores, dim=-1).to(h.dtype)
            att = merge_heads(torch.matmul(probs, v_full))
            return linear(att, block_params["attn"]["output_proj"])

        x = _block_apply(x, block_params, config, attend)

    x = _maybe_norm(x, params["ln_final"], config)
    if return_hidden:
        return x, pool
    head = lm_head_weight(params, config) if lm_head is None else lm_head
    return head_logits(x, head), pool
