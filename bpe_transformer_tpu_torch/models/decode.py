"""KV-cached decoding, dense cache (port of the dense path of
``bpe_transformer_tpu/models/decode.py``).

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
prefill, ``ffn_impl="pallas"`` the fused SwiGLU kernel in every FFN, and
``decode_attention_impl`` "pallas"/"paged" the flash-decoding kernel in
every step (the dense cache has no block table, so "paged" means "pallas"
here, as in the JAX package).
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import (
    Params,
    _check_dense,
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


def _block_apply(x, block_params, config: ModelConfig, attend):
    """One block around ``attend(h)``: pre-norm by default, post-norm under
    the ``use_post_norm`` ablation."""
    if config.use_post_norm:
        x = _maybe_norm(x + attend(x), block_params["ln1"], config)
        f = _ffn(x, block_params["ffn"], config)
        return _maybe_norm(x + f, block_params["ln2"], config)
    h = _maybe_norm(x, block_params["ln1"], config)
    x = x + attend(h)
    h = _maybe_norm(x, block_params["ln2"], config)
    return x + _ffn(h, block_params["ffn"], config)


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
    _check_dense(config)
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
) -> tuple[torch.Tensor, KVCache]:
    """One cached decode step for ``token`` (batch,) at position ``pos`` (an
    int for the whole batch, or a (batch,) tensor, one per sequence).
    Writes the step's K/V into ``cache`` in place (only for ``active``
    sequences when given) and returns float32 logits ``(batch, vocab)``;
    inactive rows' logits are computed and meant to be discarded."""
    _check_dense(config)
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
    head = lm_head_weight(params, config) if lm_head is None else lm_head
    return head_logits(x[:, 0], head), cache
