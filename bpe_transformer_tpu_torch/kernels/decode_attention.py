"""Decode-step attention against the dense KV cache (port of
``bpe_transformer_tpu/kernels/pallas/decode_attention.py::decode_attention``).

Shapes (GQA-native: the cache holds ``kv_heads`` heads and query head ``h``
reads kv head ``h // (num_heads // kv_heads)``):

* ``q``        (batch, num_heads, d_head), RoPE already applied
* ``k_cache``  (batch, kv_heads, ctx, d_head)
* ``v_cache``  (batch, kv_heads, ctx, d_head)
* ``pos``      int or (batch,) integer tensor: attend to cache rows 0..pos
* returns      (batch, num_heads, d_head) in ``q``'s dtype

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors and runs :func:`decode_attention_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import _build

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
    if num_heads % kv_heads or num_heads // kv_heads not in (1, 2, 4, 8):
        raise ValueError(
            f"num_heads={num_heads} / kv_heads={kv_heads}: the kernel takes "
            "query groups of 1, 2, 4 or 8 heads"
        )
    if d not in (16, 32, 64, 128):
        raise ValueError(f"d_head={d} unsupported by the kernel (16, 32, 64, 128)")
    q = q.contiguous()
    pos_b = _pos_vector(pos, batch, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    code, stream = _build.kernel_args("decode_attention", q, k_cache, v_cache, out)
    fn = _build.entry("decode_attention", "decode_attention_launch", 5, 5)
    rc = fn(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_b.data_ptr(), out.data_ptr(), batch, num_heads, kv_heads, ctx, d,
        stream,
    )
    _build.check(rc, "decode_attention")
    _build.count("decode_attention")
    return out
