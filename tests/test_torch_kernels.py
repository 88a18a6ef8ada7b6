"""The PyTorch port's kernel modules held against the JAX package's kernels.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run in Pallas interpret mode on the CPU, as
``tests/test_kernels.py`` runs them.  The port's wrappers, given CPU
tensors, run their plain PyTorch versions; the CUDA kernels themselves are
held against those plain versions on the card by ``chip_smoke.py``.
Tolerances are the JAX float32 kernel tests' atol: 2e-5 for the
attention forwards (and the lse; the paged decode attention too, act and
int8 pools), 3e-5 for the flash backward and the RoPE table gradients, 1e-5
for SwiGLU and its gradient and for the int8 matmul; bfloat16 inputs are
held to 3e-2, the JAX bf16 kernel tests' atol.  The int8 weight quantizer
must give JAX's int8 values and scales bit for bit.  The fused head + sample
and verify tails must give JAX's tokens exactly, with the verify's ``p_d``
within 2e-6 (``tests/test_quant.py``'s bound).  GeLU in float32: the
forward within 1e-6 of JAX's (the same operations; the two ``exp`` differ in
the last place), the backward within 3e-5 (XLA's CPU ``tanh`` returns
exactly +-1 from |u| ~ 7.9, where ``1 - t t`` ~ 5e-7 still weighs ~10 |g|);
in bfloat16 within one bf16 ulp of JAX's float32 GeLU rounded once, which
is what the TPU computes (the backward within one ulp or 3e-5, the float32
bound); JAX's interpret mode rounds a bf16 input after every operation
instead, and lands further off.

The ring-flash interface (``flash_attention_with_lse`` non-causal,
``flash_attention_block_bwd`` both ways) is held to the same 2e-5 forward
and lse, 3e-5 gradients; so are the port's stacked rings (contiguous and
zig-zag, flash and plain, ``kv_chunk`` too) against the JAX rings inside
``shard_map`` over the 8-device CPU mesh ``{"data": 2, "seq": 4}``, forward
and gradients through one seeded cotangent.  The kernels' geometry (head
dims padded to an instantiated width, decode query groups cut into chunks,
the decode kernels' key spans, the non-causal block check, the SwiGLU
forward's and the fused tails' projection's choice of design, the fused
tails' finalize clusters) is pinned as pure functions, and the shapes the
port once refused (head dims
96, 320 and 384, groups of 3 and 12) run through the plain versions against
JAX's.

The same test holds the port's 21 reference adapters (``compat``) against
the JAX package's on seeded torch inputs, with the tolerances stated in
``_adapters_match_jax``, and the JAX package's last public functions
(``make_ring_attention``, ``rope``, ``transformer_block``,
``state_dict_from_params``, ``mfu``, ``attach_manifest``, the
pre-tokenization entry points) with those of ``_public_functions_match_jax``.
It holds the clip + AdamW kernels' plain version (``kernels/adamw.py``)
against the JAX package's clip then AdamW, with the tolerances stated in
``_clip_adamw_matches_jax``, and the chunk table those kernels walk
(``_clip_adamw_chunk_table``).
"""

import importlib
import math
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bpe_transformer_tpu.kernels.pallas.decode_attention import (
    decode_attention as jax_decode_attention,
)
from bpe_transformer_tpu.kernels.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from bpe_transformer_tpu.kernels.pallas.flash_attention import (
    flash_attention_block_bwd as jax_flash_attention_block_bwd,
)
from bpe_transformer_tpu.kernels.pallas.flash_attention import (
    flash_attention_with_lse as jax_flash_attention_with_lse,
)
from bpe_transformer_tpu.kernels.pallas.decode_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from bpe_transformer_tpu.kernels.pallas.flash_attention import (
    flash_attention_with_rope as jax_flash_attention_with_rope,
)
from bpe_transformer_tpu.kernels.pallas.gelu import gelu as jax_gelu
from bpe_transformer_tpu.kernels.pallas.quant_matmul import quant_matmul as jax_quant_matmul
from bpe_transformer_tpu.kernels.pallas.sample import fused_head_sample as jax_fused_head_sample
from bpe_transformer_tpu.kernels.pallas.sample import fused_verify_head as jax_fused_verify_head
from bpe_transformer_tpu.kernels.pallas.swiglu import swiglu_fused as jax_swiglu
from bpe_transformer_tpu.ops.grad import clip_by_global_norm as jax_clip_by_global_norm
from bpe_transformer_tpu.ops.quant import quantize_weight as jax_quantize_weight
from bpe_transformer_tpu.optim.adamw import adamw_init as jax_adamw_init
from bpe_transformer_tpu.optim.adamw import adamw_update as jax_adamw_update
from bpe_transformer_tpu.ops.rope import rope_tables as jax_rope_tables
from bpe_transformer_tpu.parallel import make_mesh
from bpe_transformer_tpu.parallel import ring_attention as jax_ring
from bpe_transformer_tpu_torch import parallel
from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.kernels import adamw as aw
from bpe_transformer_tpu_torch.kernels import sample as smp
from bpe_transformer_tpu_torch.kernels import swiglu as sw
from bpe_transformer_tpu_torch.ops.quant import quantize_weight

# The modules: the package exports the functions of the same names.
da = importlib.import_module("bpe_transformer_tpu_torch.kernels.decode_attention")
fa = importlib.import_module("bpe_transformer_tpu_torch.kernels.flash_attention")
ge = importlib.import_module("bpe_transformer_tpu_torch.kernels.gelu")
qm = importlib.import_module("bpe_transformer_tpu_torch.kernels.quant_matmul")


def test_torch_kernel_plain_versions_match_jax_kernels(tmp_path):
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    counts_before = dict(_build.launches)

    # Decode attention: MHA, GQA and MQA; a scalar and ragged per-slot
    # frontiers (first and last row included); ctx not a multiple of the JAX
    # kernel's key block.
    for batch, heads, kv_heads, ctx, d, pos in [
        (2, 4, 4, 64, 16, 37),
        (3, 8, 2, 77, 32, np.array([0, 40, 76])),
        (2, 4, 1, 50, 64, np.array([49, 3])),
    ]:
        q = normal(batch, heads, d)
        k, v = normal(batch, kv_heads, ctx, d), normal(batch, kv_heads, ctx, d)
        want = jax_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            block_k=32, interpret=True,
        )
        got = da.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.as_tensor(pos),
        )
        assert got.shape == (batch, heads, d) and got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=2e-5,
            err_msg=f"decode_attention B={batch} H={heads} KV={kv_heads} ctx={ctx} d={d}",
        )

    # Causal flash attention: S not a multiple of the JAX block (128), d in
    # {16, 32, 64}, leading (batch, heads) dims.
    for shape in [(1, 2, 200, 16), (2, 1, 77, 32), (1, 2, 130, 64)]:
        q, k, v = normal(*shape), normal(*shape), normal(*shape)
        want = jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 128, 128, True
        )
        got = fa.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True
        )
        assert got.shape == shape
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=2e-5, err_msg=f"flash_attention {shape}"
        )

    # Fused SwiGLU: token count and d_ff not multiples of the JAX tiles
    # (block_m 16, block_f 32), 2-D and 3-D activations.
    for x_shape, ff in [((37, 64), 200), ((2, 5, 48), 96)]:
        d = x_shape[-1]
        x = normal(*x_shape)
        w1, w3 = normal(ff, d, scale=0.05), normal(ff, d, scale=0.05)
        w2 = normal(d, ff, scale=0.05)
        want = jax_swiglu(
            jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3), 16, 32, True
        )
        got = sw.swiglu_fused(*(torch.from_numpy(a) for a in (x, w1, w2, w3)))
        assert got.shape == x_shape
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=1e-5, err_msg=f"swiglu {x_shape} ff={ff}"
        )

    # Flash forward with the row logsumexp, and the FA-2 backward (jax.vjp
    # of the Pallas kernel) against autograd through the plain version: S
    # ragged against the JAX blocks, every head dim the kernels take.
    for shape, block in [((1, 2, 200, 16), 128), ((2, 1, 77, 32), 32), ((1, 2, 96, 64), 64),
                         ((1, 1, 40, 128), 32)]:
        q, k, v, ct = normal(*shape), normal(*shape), normal(*shape), normal(*shape)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        want_out, want_lse = jax_flash_attention_with_lse(jq, jk, jv, True, block, block, True)
        _, vjp = jax.vjp(
            lambda a, b, c: jax_flash_attention(a, b, c, True, block, block, True), jq, jk, jv
        )
        want_grads = vjp(jnp.asarray(ct))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out, lse = fa.flash_attention_plain(tq, tk, tv, True, return_lse=True)
        (out * torch.from_numpy(ct)).sum().backward()
        what = f"flash_attention {shape}"
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5,
                                   err_msg=what)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse), atol=2e-5,
                                   err_msg=f"{what} lse")
        # The backward kernels' plain arithmetic from the residuals.
        residuals = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     out.detach(), lse.detach(), torch.from_numpy(ct))
        plain = (fa.flash_attention_bwd_dq_plain(*residuals),
                 *fa.flash_attention_bwd_dkdv_plain(*residuals))
        for autograd_grad, plain_grad, want, name in zip((tq, tk, tv), plain, want_grads, "qkv"):
            for got in (autograd_grad.grad, plain_grad):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                                           err_msg=f"{what} d{name}")

    # RoPE in the kernel: forward, q/k/v gradients and the cos/sin table
    # gradients of flash_attention_with_rope, with tables gathered at
    # positions that are not 0..S-1.
    for shape, block in [((1, 2, 64, 32), 32), ((2, 1, 50, 16), 64), ((1, 1, 33, 64), 32)]:
        s, d = shape[-2], shape[-1]
        q, k, v, ct = normal(*shape), normal(*shape), normal(*shape), normal(*shape)
        cos_t, sin_t = (np.asarray(t) for t in jax_rope_tables(d, 2 * s + 7))
        pos = np.arange(s) * 2 + 3
        cos, sin = cos_t[pos], sin_t[pos]
        args = tuple(jnp.asarray(a) for a in (q, k, v, cos, sin))
        want_out, vjp = jax.vjp(
            lambda *a: jax_flash_attention_with_rope(*a, True, block, block, True), *args
        )
        want_grads = vjp(jnp.asarray(ct))
        targs = tuple(torch.from_numpy(a).requires_grad_() for a in (q, k, v, cos, sin))
        out = fa.flash_attention_rope(*targs)
        (out * torch.from_numpy(ct)).sum().backward()
        what = f"flash_attention_rope {shape}"
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5,
                                   err_msg=what)
        for got, want, name in zip(targs, want_grads, ("q", "k", "v", "cos", "sin")):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=3e-5,
                                       err_msg=f"{what} d{name}")

    # SwiGLUFused's backward against jax.vjp of the Pallas swiglu.
    for x_shape, ff in [((37, 64), 200), ((2, 5, 48), 96)]:
        d = x_shape[-1]
        arrays = (normal(*x_shape), normal(ff, d, scale=0.05), normal(d, ff, scale=0.05),
                  normal(ff, d, scale=0.05))
        ct = normal(*x_shape)
        _, vjp = jax.vjp(
            lambda *a: jax_swiglu(*a, 16, 32, True), *(jnp.asarray(a) for a in arrays)
        )
        want_grads = vjp(jnp.asarray(ct))
        targs = tuple(torch.from_numpy(a).requires_grad_() for a in arrays)
        (sw.swiglu_fused(*targs) * torch.from_numpy(ct)).sum().backward()
        for got, want, name in zip(targs, want_grads, ("x", "w1", "w2", "w3")):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=1e-5,
                                       err_msg=f"swiglu {x_shape} ff={ff} d{name}")

    # Paged decode attention: shuffled block tables, block sizes 8 to 64
    # (a warp's 32-key tile spans several blocks below 32), frontiers at 0,
    # bs - 1, bs and the last row, GQA groups 1, 2 and 4, and a last slot
    # parked on the trash block (an all-zero table row, as an idle slot has).
    for slots, heads, kv_heads, bs, nbs, d, kind in [
        (4, 4, 4, 8, 4, 16, "float32"),
        (4, 8, 4, 16, 3, 32, "float32"),
        (4, 8, 2, 32, 2, 16, "float32"),
        (4, 4, 1, 64, 2, 32, "float32"),
        (4, 8, 4, 8, 4, 16, "int8"),
        (4, 4, 2, 16, 3, 32, "int8"),
        (4, 8, 4, 16, 3, 32, "bfloat16"),
    ]:
        num_blocks = slots * nbs + 1
        ctx = nbs * bs
        tables = rng.permutation(np.arange(1, num_blocks)).reshape(slots, nbs).astype(np.int32)
        tables[-1] = 0
        pos = np.array([0, bs - 1, bs, ctx - 1][:slots], np.int32)
        q = normal(slots, heads, d)
        k_pool, v_pool = (normal(num_blocks, kv_heads, bs, d) for _ in range(2))
        scales, tol = {}, 2e-5
        if kind == "int8":
            k_scale, v_scale = (
                (np.abs(normal(num_blocks, kv_heads)) / 40 + 0.01).astype(np.float32)
                for _ in range(2)
            )
            k_pool = np.clip(np.round(k_pool / k_scale[:, :, None, None]), -127, 127).astype(np.int8)
            v_pool = np.clip(np.round(v_pool / v_scale[:, :, None, None]), -127, 127).astype(np.int8)
            scales = {"k_scale": k_scale, "v_scale": v_scale}
        want_args = [jnp.asarray(a) for a in (q, k_pool, v_pool, tables, pos)]
        got_args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, pos)]
        if kind == "bfloat16":
            tol = 3e-2
            want_args[:3] = [a.astype(jnp.bfloat16) for a in want_args[:3]]
            got_args[:3] = [a.to(torch.bfloat16) for a in got_args[:3]]
        want = jax_paged_decode_attention(
            *want_args, **{k: jnp.asarray(s) for k, s in scales.items()}, interpret=True
        )
        got = da.paged_decode_attention(
            *got_args, **{k: torch.from_numpy(s) for k, s in scales.items()}
        )
        assert got.shape == (slots, heads, d) and got.dtype == got_args[0].dtype
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=tol,
            err_msg=f"paged_decode_attention {kind} H={heads} KV={kv_heads} bs={bs} d={d}",
        )
    # The JAX function's argument errors (tests/test_kernels.py).
    q, pool = torch.zeros(2, 4, 16), torch.zeros(9, 2, 8, 16)
    tables, pos = torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    for match, args, kwargs in [
        ("tables", (q, pool, pool, torch.zeros(3, 4, dtype=torch.int32), pos), {}),
        ("shape mismatch", (q, pool, torch.zeros(9, 2, 8, 8), tables, pos), {}),
        ("int8", (q, pool, pool, tables, pos), {"k_scale": torch.zeros(9, 2)}),
        ("not divisible", (torch.zeros(2, 5, 16), pool, pool, tables, pos), {}),
    ]:
        with pytest.raises(ValueError, match=match):
            da.paged_decode_attention(*args, **kwargs)

    # int8 matmul: d_in 64 and 683 (rows not a multiple of 16 bytes), m 1,
    # 8 and 37, float32 and bfloat16 activations; float32 out.
    for m, d_in, d_out, kind in [(1, 64, 96, "float32"), (8, 683, 64, "float32"),
                                 (37, 64, 40, "float32"), (8, 683, 64, "bfloat16"),
                                 (37, 64, 40, "bfloat16")]:
        x = normal(m, d_in)
        wq = rng.integers(-127, 128, size=(d_out, d_in)).astype(np.int8)
        # Scales of std-0.02 weights (max |w| / 127): outputs of order 1.
        scale = (np.abs(normal(d_out)) * 5e-4).astype(np.float32)
        jx, tx, tol = jnp.asarray(x), torch.from_numpy(x), 1e-5
        if kind == "bfloat16":
            jx, tx, tol = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16), 3e-2
        want = jax_quant_matmul(jx, jnp.asarray(wq), jnp.asarray(scale), interpret=True)
        got = qm.quant_matmul(tx, torch.from_numpy(wq), torch.from_numpy(scale))
        assert got.shape == (m, d_out) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   err_msg=f"quant_matmul m={m} d_in={d_in} {kind}")
    with pytest.raises(ValueError, match="shape mismatch"):
        qm.quant_matmul(torch.zeros(2, 8), torch.zeros(4, 7, dtype=torch.int8), torch.zeros(4))

    # Weight quantization: JAX's int8 values and scales bit for bit, on
    # bf16-rounded weights (as the serving tree holds them) with an all-zero
    # row (scale 0, values 0).
    w = normal(48, 683, scale=0.02)
    w[5] = 0.0
    w_bf16 = torch.from_numpy(w).to(torch.bfloat16)
    want = jax_quantize_weight(jnp.asarray(w).astype(jnp.bfloat16))
    got = quantize_weight(w_bf16)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["scale"][5] == 0 and not got["q"][5].any()

    # Fused head + sample: test_quant.py's knob mix (greedy, temperature,
    # top-k of 1, 5 and 40, top-p 0.3 to 0.9, top-p 0) on a vocabulary of
    # 257 (no 128-multiple divisor), f32 and int8 heads, the same numpy
    # gumbel noise on both sides: identical tokens.
    s, d, v = 6, 64, 257
    hidden = normal(s, d)
    head = normal(v, d, scale=0.3)
    knobs = (np.array([0.0, 1.0, 0.7, 1.3, 1.0, 0.5], np.float32),
             np.array([0, 0, 5, 1, 40, 0], np.int32),
             np.array([2.0, 0.9, 2.0, 0.5, 0.3, 0.0], np.float32))
    gumbel = rng.gumbel(size=(s, v)).astype(np.float32)
    for quantized in (False, True):
        j_head = jnp.asarray(head)
        t_head = torch.from_numpy(head)
        if quantized:
            j_head, t_head = jax_quantize_weight(j_head), quantize_weight(t_head)
        want = jax_fused_head_sample(jnp.asarray(hidden), j_head, *map(jnp.asarray, knobs),
                                     jnp.asarray(gumbel), interpret=True)
        logits_out = torch.empty(s, v)
        got = smp.fused_head_sample(torch.from_numpy(hidden), t_head,
                                    *map(torch.from_numpy, knobs), torch.from_numpy(gumbel),
                                    logits_out=logits_out)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"int8={quantized}")
        np.testing.assert_array_equal(
            got.numpy(),
            smp.fused_head_sample_plain(torch.from_numpy(hidden), t_head,
                                        *map(torch.from_numpy, knobs),
                                        torch.from_numpy(gumbel)).numpy())
        assert not torch.equal(got, torch.argmax(logits_out, dim=-1))  # sampled rows moved

    # Fused verify tail: 3 slots x K+1 = 4 rows on a vocabulary of 101, a
    # greedy, a top-k 7 / top-p 0.8 and a temperature-only slot; a softmax
    # draft q and random judged tokens.
    s, k1, d, v = 3, 4, 32, 101
    hidden = normal(s * k1, d)
    head = normal(v, d, scale=0.3)
    knobs = (np.repeat(np.array([0.0, 1.0, 0.8], np.float32), k1),
             np.repeat(np.array([0, 7, 0], np.int32), k1),
             np.repeat(np.array([2.0, 0.8, 2.0], np.float32), k1))
    judge = rng.integers(0, v, size=s * k1).astype(np.int32)
    q = np.array(jax.nn.softmax(jnp.asarray(normal(s * k1, v)), axis=-1))
    gumbel = rng.gumbel(size=(s * k1, v)).astype(np.float32)
    args = (hidden, head, *knobs, judge, q, gumbel)
    want = jax_fused_verify_head(*map(jnp.asarray, args), interpret=True)
    got = smp.fused_verify_head(*map(torch.from_numpy, args))
    for name, g_out, w_out in zip(("greedy", "p_d", "bonus"), got, want):
        if name == "p_d":
            np.testing.assert_allclose(g_out.numpy(), np.asarray(w_out), rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out), err_msg=name)
    assert got[1][:k1].tolist() == [float(t == j) for t, j in zip(got[0][:k1].tolist(),
                                                                 judge[:k1].tolist())]
    with pytest.raises(ValueError, match="must be"):
        smp._head_operands(torch.zeros(v, d + 1), v, d)

    # GeLU and its backward (jax.vjp of the Pallas gelu): 3 N(0, 1) values of
    # a (64, 3072) FFN activation and the large magnitudes of
    # tests/test_kernels.py, in float32 and in bfloat16.
    x = np.concatenate([normal(64 * 3072, scale=3.0),
                        np.array([11.0, 50.0, 1000.0, -1000.0], np.float32)])
    ct = normal(*x.shape)
    want, vjp = jax.vjp(jax_gelu, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = ge.gelu(tx)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0,
                               err_msg="gelu float32")
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), atol=3e-5, rtol=0,
                               err_msg="gelu backward float32")
    assert got[-4:].tolist() == [11.0, 50.0, 1000.0, 0.0]

    def bf16_ulps(got, ref, floor=2.0**-126):
        """Max elementwise |got - ref| in bf16 ulps of ``ref`` (both bf16),
        an ulp counted as at least ``floor``."""
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0**-126))) - 7)
        return ((got.float() - ref.float()).abs() / ulp.clamp(min=floor)).max().item()

    xb = torch.from_numpy(x).to(torch.bfloat16)
    ctb = torch.from_numpy(ct).to(torch.bfloat16)
    x_wide, ct_wide = jnp.asarray(xb.float().numpy()), jnp.asarray(ctb.float().numpy())
    want, vjp = jax.vjp(jax_gelu, x_wide)
    ref = torch.from_numpy(np.array(want)).to(torch.bfloat16)
    ref_dx = torch.from_numpy(np.array(vjp(ct_wide)[0])).to(torch.bfloat16)
    txb = xb.clone().requires_grad_()
    got = ge.gelu(txb)
    (got.float() * ctb.float()).sum().backward()
    assert got.dtype == txb.grad.dtype == torch.bfloat16
    assert bf16_ulps(got.detach(), ref) <= 1
    # Where XLA's saturated tanh zeroes JAX's gradient, the float32 bound.
    assert bf16_ulps(txb.grad, ref_dx, floor=3e-5) <= 1
    assert bf16_ulps(ge.gelu_bwd_plain(xb, ctb), ref_dx, floor=3e-5) <= 1
    # The known difference: JAX's interpret mode, rounding after every op.
    per_op = torch.from_numpy(
        np.array(jax_gelu(x_wide.astype(jnp.bfloat16)).astype(jnp.float32))).to(torch.bfloat16)
    share = (per_op != ref).float().mean().item()
    assert share > 0.25 and bf16_ulps(per_op, ref) > 1, share

    # The ring-flash interface: the non-causal forward with its lse, and the
    # block backward of both masks given the global out and lse.
    for shape, block in [((1, 2, 64, 16), 16), ((2, 1, 32, 32), 32)]:
        q, k, v, ct = normal(*shape), normal(*shape), normal(*shape), normal(*shape)
        jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, ct))
        tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, ct))
        for causal in (False, True):
            what = f"ring-flash interface {shape} causal={causal}"
            want_out, want_lse = jax_flash_attention_with_lse(jq, jk, jv, causal, block, block,
                                                              True)
            out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal, block, block)
            assert lse.shape == shape[:-1] and lse.dtype == torch.float32
            np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5, err_msg=what)
            np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5,
                                       err_msg=f"{what} lse")
            want = jax_flash_attention_block_bwd(jq, jk, jv, want_out, want_lse, jg, causal,
                                                 block, block, True)
            got = fa.flash_attention_block_bwd(
                tq, tk, tv, torch.from_numpy(np.array(want_out)),
                torch.from_numpy(np.array(want_lse)), tg, causal, block, block)
            for g_, w_, name in zip(got, want, "qkv"):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=3e-5,
                                           err_msg=f"{what} block bwd d{name}")
    for call in (lambda: fa.flash_attention_with_lse(tq[..., :24, :], tk[..., :24, :],
                                                     tv[..., :24, :], False, 16, 16),
                 lambda: fa.flash_attention_block_bwd(*(t[..., :24, :] for t in (tq, tk, tv)),
                                                      tq[..., :24, :], tq[..., :24, 0],
                                                      tg[..., :24, :], True, 16, 16)):
        with pytest.raises(ValueError, match="divisible by the block"):
            call()

    # The stacked rings (n = 4 ranks on one device) against the JAX rings
    # inside shard_map over {"data": 2, "seq": 4}: the flash rings of both
    # layouts (interpret mode), and the plain rings against the same oracle.
    mesh = make_mesh({"data": 2, "seq": 4})
    spec = jax.sharding.PartitionSpec("data", None, "seq", None)
    ring = parallel.StackedRing(4)
    b, h, s, d = 2, 2, 64, 16
    q, k, v, ct = normal(b, h, s, d), normal(b, h, s, d), normal(b, h, s, d), normal(b, h, s, d)

    def stack(a):  # (B, H, S, D) -> (4, B, H, S/4, D)
        return torch.from_numpy(a).reshape(b, h, 4, s // 4, d).permute(2, 0, 1, 3, 4).contiguous()

    def unstack(t):
        return t.permute(1, 2, 0, 3, 4).reshape(b, h, s, d).numpy()

    for zigzag, block in ((False, 16), (True, 8)):
        jax_fn = jax_ring.zigzag_ring_flash_attention if zigzag else jax_ring.ring_flash_attention
        mapped = jax.shard_map(
            partial(jax_fn, axis_name="seq", block_q=block, block_k=block, interpret=True),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)

        def fwd_bwd(q_, k_, v_, g_):
            out, vjp = jax.vjp(mapped, q_, k_, v_)
            return out, vjp(g_)

        perm = np.asarray(parallel.zigzag_indices(s, 4)) if zigzag else np.arange(s)
        arrays = [a[..., perm, :] for a in (q, k, v, ct)]
        want_out, want_grads = jax.jit(fwd_bwd)(*(jnp.asarray(a) for a in arrays))
        if zigzag:
            ports = [partial(parallel.zigzag_ring_flash_attention, block_q=block, block_k=block),
                     parallel.zigzag_ring_self_attention]
        else:
            ports = [partial(parallel.ring_flash_attention, block_q=block, block_k=block),
                     parallel.ring_self_attention,
                     partial(parallel.ring_self_attention, kv_chunk=4)]
        for fn in ports:
            what = f"stacked ring {getattr(fn, 'func', fn).__name__} zigzag={zigzag}"
            args = [stack(a).requires_grad_() for a in arrays[:3]]
            out = fn(*args, ring)
            (out * stack(arrays[3])).sum().backward()
            np.testing.assert_allclose(unstack(out.detach()), np.asarray(want_out), atol=2e-5,
                                       err_msg=what)
            for got, want, name in zip(args, want_grads, "qkv"):
                np.testing.assert_allclose(unstack(got.grad), np.asarray(want), atol=3e-5,
                                           err_msg=f"{what} d{name}")
    inv = parallel.zigzag_inverse_indices(s, 4)
    assert torch.equal(parallel.zigzag_indices(s, 4)[inv], torch.arange(s))
    np.testing.assert_array_equal(
        parallel.zigzag_positions(ring.index(), s // 4, 4).numpy(),
        np.stack([np.asarray(jax_ring.zigzag_positions(i, s // 4, 4)) for i in range(4)]))

    # Kernel geometry: head dims run at the next instantiated width up to
    # 256 and above it at a multiple of 256 in output-column chunks of 256
    # (one block each), the bf16 forward at width 64 at least (the tensor
    # cores), decode query groups in chunks of 1, 2, 4 or 8 heads (4 from
    # width 256), and a non-causal call needs seq divisible by the JAX blocks.
    assert [fa.padded_head_dim(d) for d in (1, 16, 17, 40, 64, 96, 128, 129, 256)] == [
        16, 16, 32, 64, 64, 128, 128, 256, 256]
    for d, width, chunks in [(257, 512, 2), (320, 512, 2), (384, 512, 2), (512, 512, 2),
                             (1000, 1024, 4), (1024, 1024, 4)]:
        assert fa.padded_head_dim(d) == width and fa.col_chunks(width) == chunks, d
        t = torch.zeros(2, 3, 5, width)
        assert fa._geometry(t, t, t) == (6, 5, width, chunks), d
        assert da.decode_geometry(8, 2, d) == (width, 4, 1, chunks), d
        assert da.decode_geometry(12, 1, d) == (width, 4, 3, chunks), d
    for d, dtype, width in [(16, torch.float32, 16), (16, torch.bfloat16, 64),
                            (96, torch.bfloat16, 128), (320, torch.bfloat16, 512)]:
        assert fa.forward_width(d, dtype) == width, (d, dtype)
    with pytest.raises(ValueError, match="not a launch width"):
        t = torch.zeros(1, 4, 320)
        fa._geometry(t, t, t)
    with pytest.raises(ValueError, match="must be positive"):
        fa.padded_head_dim(0)
    for args, want in [((4, 4, 64), (64, 1, 1, 1)), ((8, 2, 32), (32, 4, 1, 1)),
                       ((12, 1, 64), (64, 8, 2, 1)), ((6, 2, 96), (128, 4, 1, 1)),
                       ((4, 4, 96), (128, 1, 1, 1)), ((16, 1, 256), (256, 4, 4, 1)),
                       ((40, 4, 16), (16, 8, 2, 1)), ((5, 1, 200), (256, 4, 2, 1))]:
        assert da.decode_geometry(*args) == want, args
    # The decode kernels' key splits (the paged kernel's over the
    # blocks_per_slot * block_size keys a slot can hold): spans of 64 keys
    # up to ctx 2048, then 32 spans of a multiple of 64 keys (up to 256 keys
    # a span).
    for ctx, want in [(1, (1, 64)), (16, (1, 64)), (1000, (16, 64)), (1024, (16, 64)),
                      (4096, (32, 128)), (8192, (32, 256))]:
        assert da.decode_splits(ctx) == want, ctx
        n_splits, span = want
        assert span % 32 == 0 and n_splits * span >= ctx > (n_splits - 1) * span, ctx
    # The SwiGLU forward's design by type and widths: bf16 on the tensor
    # cores (at every m: they win from one row up on the card) when d and
    # d_ff are multiples of 8; float32 and other widths on the CUDA cores.
    for d, ff, dtype, want in [
        (768, 2048, torch.bfloat16, "tensor_cores"),
        (64, 200, torch.bfloat16, "tensor_cores"),
        (768, 2048, torch.float32, "cuda_cores"),
        (256, 683, torch.bfloat16, "cuda_cores"),
        (2500, 200, torch.bfloat16, "cuda_cores"),
    ]:
        assert sw.swiglu_path(d, ff, dtype) == want, (d, ff, dtype)
    # The backward's width and design: bf16 as the forward (64 at least),
    # on the tensor cores at widths 64 and 128; float32 at its own width on
    # the CUDA cores, as bf16 from 256 up.
    for d in range(16, 1025, 8):
        for dtype in (torch.float32, torch.bfloat16):
            width = fa.backward_width(d, dtype)
            want = fa.forward_width(d, dtype) if dtype == torch.bfloat16 else fa.padded_head_dim(d)
            assert width == want, (d, dtype)
            tc = dtype == torch.bfloat16 and width in (64, 128)
            assert fa.backward_path(width, dtype) == ("tensor_cores" if tc else "cuda_cores")
    assert [fa.backward_width(d, torch.bfloat16) for d in (16, 64, 96, 128, 200)] == [
        64, 64, 128, 128, 256]
    # Its staged lse/delta rows: padded to whole 64-query tiles for the
    # tensor cores only, lse with a value whose exp(score - lse) is 0.
    gen = torch.Generator().manual_seed(8)
    lse_in, delta_in = torch.randn(6, 77, generator=gen), torch.randn(6, 77, generator=gen)
    lse_p, delta_p = fa._bwd_stats(lse_in, delta_in, 6, 77, 64, torch.bfloat16)
    assert lse_p.shape == delta_p.shape == (6, 128)
    assert torch.equal(lse_p[:, :77], lse_in) and torch.equal(delta_p[:, :77], delta_in)
    assert torch.exp(torch.tensor(30.0) - lse_p[:, 77:]).max() == 0 and not delta_p[:, 77:].any()
    for width, dtype in ((64, torch.float32), (256, torch.bfloat16)):
        assert fa._bwd_stats(lse_in, delta_in, 6, 77, width, dtype)[0].shape == (6, 77)
    # The int8 matmul's design: bf16 x on the tensor cores when d_in is a
    # multiple of 16 (int8 weight rows TMA can describe), at every m;
    # float32 x and rows of 683 or 1365 bytes on the CUDA cores.
    for m in (1, 2, 7, 8, 9, 40, 64, 65, 256, 1000):
        for k_in in (64, 683, 768, 1365, 2048):
            for dtype in (torch.float32, torch.bfloat16):
                tc = dtype == torch.bfloat16 and k_in % 16 == 0
                assert qm.quant_path(m, k_in, dtype) == ("tensor_cores" if tc else "cuda_cores")
            for n_out in (64, 768, 2048, 32000):
                bn, nsplit, per = qm.tc_geometry(m, n_out, k_in, 132)
                steps = -(-k_in // 128)
                assert bn == next((b for b in (8, 16, 32, 64) if m <= b), 64), m
                assert nsplit * per >= steps > (nsplit - 1) * per, (m, k_in, n_out)
                assert nsplit == 1 or m <= 64
    assert qm.tc_geometry(8, 2048, 768, 132) == (8, 6, 1)
    assert qm.tc_geometry(8, 32000, 768, 132) == (8, 1, 6)
    assert qm.tc_geometry(256, 2048, 768, 132) == (64, 1, 6)
    # The fused tails' projection: bf16 rows against a bf16 or int8 head
    # with d a multiple of 16 on the tensor cores, the rows rounded up to a
    # multiple of 8 (the wgmma's N, at most 64 a block); float32 rows, a
    # float32 head and other widths on the CUDA cores.
    bf, f32 = torch.bfloat16, torch.float32
    for x_dtype, h_dtype, d, want in [(bf, bf, 768, "tensor_cores"),
                                      (bf, torch.int8, 768, "tensor_cores"),
                                      (bf, bf, 64, "tensor_cores"), (bf, f32, 768, "cuda_cores"),
                                      (f32, f32, 768, "cuda_cores"),
                                      (f32, torch.int8, 768, "cuda_cores"),
                                      (bf, bf, 100, "cuda_cores"), (bf, torch.int8, 40, "cuda_cores")]:
        assert smp.head_path(x_dtype, h_dtype, d) == want, (x_dtype, h_dtype, d)
    assert [smp.head_tile_rows(r) for r in (1, 3, 8, 9, 33, 40, 64, 65, 200)] == [
        8, 8, 8, 16, 40, 40, 64, 64, 64]
    # The finalize: one cluster of up to 8 blocks a row, as many as keep
    # rows x cluster within two blocks an SM (8 rows x 8, 40 rows x 6 on
    # 132 SMs), each block one chunk of the row's columns.
    assert smp.finalize_geometry(8, 32000, 132) == (8, 4000)
    assert smp.finalize_geometry(40, 32000, 132) == (6, 5334)
    for rows in (1, 3, 8, 33, 40, 132, 200):
        for vocab in (5, 101, 257, 10000, 32000):
            cluster, chunk = smp.finalize_geometry(rows, vocab, 132)
            assert 1 <= cluster <= min(smp.MAX_CLUSTER, vocab), (rows, vocab)
            assert rows * cluster <= max(2 * 132, rows), (rows, vocab)
            assert cluster * chunk >= vocab > (cluster - 1) * chunk, (rows, vocab)
    # The premise of the tensor-core design: every int8 value is exact in
    # bf16, and a product of a bf16 and an int8 value is exact in float32.
    # And the kernel's widening, mirrored bit for bit: 0x4300 | (b & 0x7F)
    # minus 0x4300 | (b & 0x80), as bf16 values, is the int8 value of b.
    all_q = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(all_q.to(torch.bfloat16).float(), all_q.float())
    xs = torch.randn(4096, generator=gen).to(torch.bfloat16)
    prod = xs.float()[:, None] * all_q.float()[None, :]
    assert torch.equal(prod.double(), xs.double()[:, None] * all_q.double()[None, :])
    byte = all_q.numpy().view(np.uint8).astype(np.uint32)

    def bf16_bits(bits):
        return (bits << 16).astype(np.uint32).view(np.float32)

    lo, hi = bf16_bits(0x4300 | (byte & 0x7F)), bf16_bits(0x4300 | (byte & 0x80))
    widened = torch.from_numpy(lo - hi)
    assert torch.equal(widened, all_q.float())
    assert torch.equal(widened.to(torch.bfloat16).float(), widened)  # exact in bf16 too
    with pytest.raises(ValueError, match="not divisible"):
        da.decode_geometry(12, 5, 64)
    fa.check_blocks(24, True, 16, 16)  # causal calls pad
    fa.check_blocks(48, False, 16, 24)
    with pytest.raises(ValueError, match="divisible by the block size \\(48\\)"):
        fa.check_blocks(96 + 24, False, 16, 24)

    # Shapes the kernels once refused, through the plain versions against
    # JAX's: flash at head dim 96, decode at head dim 96 and at query groups
    # of 12 and 3.
    q, k, v = normal(2, 64, 96), normal(2, 64, 96), normal(2, 64, 96)
    want = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), True, 128, 128, True)
    np.testing.assert_allclose(
        fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy(),
        np.asarray(want), atol=2e-5, err_msg="flash d=96")
    for batch, heads, kv_heads, ctx, d, pos in [(2, 4, 4, 128, 96, np.array([5, 100])),
                                                (2, 12, 1, 64, 64, np.array([63, 7])),
                                                (2, 6, 2, 40, 32, np.array([0, 39]))]:
        q = normal(batch, heads, d)
        k, v = normal(batch, kv_heads, ctx, d), normal(batch, kv_heads, ctx, d)
        want = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)), block_k=32,
                                    interpret=True)
        got = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, pos)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   err_msg=f"decode H={heads} KV={kv_heads} d={d}")

    # Head dims above 256 (fault C2's repair): the plain versions of the
    # flash forward with its lse and its backward, the RoPE forward and its
    # gradients, and decode attention (dense and paged) against JAX's at
    # d 320 and 384, which the kernels run in output-column chunks.
    for d in (320, 384):
        shape = (1, 2, 24, d)
        q, k, v, ct = normal(*shape), normal(*shape), normal(*shape), normal(*shape)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        want_out, want_lse = jax_flash_attention_with_lse(jq, jk, jv, True, 8, 8, True)
        _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, True, 8, 8, True),
                         jq, jk, jv)
        want_grads = vjp(jnp.asarray(ct))
        tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, ct))
        out, lse = fa.flash_attention_with_lse(tq, tk, tv, True, 8, 8)
        what = f"flash_attention d={d}"
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5, err_msg=what)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5,
                                   err_msg=f"{what} lse")
        got = fa.flash_attention_block_bwd(tq, tk, tv, out, lse, tg, True, 8, 8)
        for g_, w_, name in zip(got, want_grads, "qkv"):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=3e-5,
                                       err_msg=f"{what} d{name}")
        cos_t, sin_t = (np.array(t) for t in jax_rope_tables(d, 24))
        args = tuple(jnp.asarray(a) for a in (q, k, v, cos_t, sin_t))
        want_out, vjp = jax.vjp(
            lambda *a: jax_flash_attention_with_rope(*a, True, 8, 8, True), *args)
        want_grads = vjp(jnp.asarray(ct))
        targs = tuple(torch.from_numpy(a).requires_grad_() for a in (q, k, v, cos_t, sin_t))
        out = fa.flash_attention_rope(*targs)
        (out * tg).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5,
                                   err_msg=f"flash_attention_rope d={d}")
        for got, want, name in zip(targs, want_grads, ("q", "k", "v", "cos", "sin")):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=3e-5,
                                       err_msg=f"flash_attention_rope d={d} d{name}")
        batch, heads, kv_heads, ctx = 2, 6, 2, 40
        pos = np.array([0, 39])
        q = normal(batch, heads, d)
        k, v = normal(batch, kv_heads, ctx, d), normal(batch, kv_heads, ctx, d)
        want = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)), block_k=32,
                                    interpret=True)
        got = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, pos)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   err_msg=f"decode_attention d={d}")
        slots, bs, nbs = 2, 8, 3
        tables = (rng.permutation(np.arange(1, slots * nbs + 1)).reshape(slots, nbs)
                  .astype(np.int32))
        pos = np.array([bs, nbs * bs - 1], np.int32)
        k_pool, v_pool = (normal(slots * nbs + 1, kv_heads, bs, d) for _ in range(2))
        want = jax_paged_decode_attention(
            *(jnp.asarray(a) for a in (q, k_pool, v_pool, tables, pos)), interpret=True)
        got = da.paged_decode_attention(
            *(torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, pos)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   err_msg=f"paged_decode_attention d={d}")

    # The reference adapter surface, on the port's ops and models.
    _adapters_match_jax(tmp_path)
    # The last public functions of the JAX package.
    _public_functions_match_jax(tmp_path)
    # The clip + AdamW kernels' plain version and their chunk table.
    _clip_adamw_matches_jax()
    _clip_adamw_chunk_table()

    # CPU tensors take the plain versions: no kernel launch is counted.
    assert _build.launches == counts_before


# ------------------------------------------------------------------------
# The clip + AdamW kernels (``kernels/adamw.py``): their plain version
# against the JAX package's clip then AdamW, and the chunk table the
# kernels walk.

#: (parameter dtype, gradient dtype, max_norm, delta_norms): float32 and
#: bf16 parameters, ``grads_dtype="bfloat16"`` gradients, the clip engaged
#: (max_norm 0.5 against norms of about 1.5) and not (1e4), the update
#: norms asked for.
CLIP_ADAMW_CASES = [
    ("float32", "float32", 0.5, True),
    ("float32", "float32", 1e4, False),
    ("float32", "bfloat16", 0.5, True),
    ("bfloat16", "float32", 0.5, False),
    ("bfloat16", "bfloat16", 1e4, True),
]


def _clip_adamw_matches_jax():
    """5 steps of ``aw.clip_adamw`` on CPU tensors (the plain clip and the
    plain per-leaf loop) against the JAX package's ``clip_by_global_norm``
    then ``adamw_update`` on the same numpy inputs: the norm, p, m and v
    after every step, and the update norms against JAX's ``||new - old||``.
    Tolerances in float32: the norm, m and v to 1e-5 relative (m and v
    plus 1e-7): the norm is summed in another order; parameters to 1e-5
    relative plus ``lr`` times 1e-4: JAX takes ``b2 ** step`` in float32,
    where the port takes it in double, and at step 2 ``1 - 0.999 ** 2`` so
    taken is 3e-5 off, which moves the update by half that.  In bfloat16
    one bf16 ulp (2^-7 relative, plus ``lr`` times 2^-6) a step for the
    parameters, and for m and v from bf16 gradients, which round the
    clipped gradient to bf16 from scales an ulp apart."""
    lr, betas, eps, wd = 1e-2, (0.9, 0.999), 1e-8, 0.01
    shapes = [(7, 5), (0,), (3,), (33, 17), (1000,)]
    for p_name, g_name, max_norm, deltas in CLIP_ADAMW_CASES:
        rng = np.random.default_rng(7)
        p_dt, g_dt = getattr(torch, p_name), getattr(torch, g_name)
        params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(p_dt)
                  for s in shapes]
        ms = [torch.zeros(p.shape) for p in params]
        vs = [torch.zeros(p.shape) for p in params]
        # Copies: JAX may alias a numpy buffer, and the port writes in place.
        j_params = [jnp.asarray(p.float().numpy().copy()).astype(p_name) for p in params]
        j_state = jax_adamw_init(j_params)
        what = f"clip_adamw {p_name} / {g_name} max_norm {max_norm}"
        bf16 = p_dt == torch.bfloat16 or g_dt == torch.bfloat16
        for step in range(1, 6):
            grads_np = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in shapes]
            grads = [torch.from_numpy(g).to(g_dt) for g in grads_np]
            j_grads = [jnp.asarray(g.float().numpy()).astype(g_name) for g in grads]
            delta_norms = [] if deltas else None
            norm = aw.clip_adamw(params, grads, ms, vs, step=step, lr=lr, max_norm=max_norm,
                                 betas=betas, eps=eps, weight_decay=wd, delta_norms=delta_norms)
            j_old = j_params
            j_clipped, j_norm = jax_clip_by_global_norm(j_grads, max_norm)
            j_params, j_state = jax_adamw_update(j_params, j_clipped, j_state, lr, betas=betas,
                                                 eps=eps, weight_decay=wd)
            np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-5,
                                       err_msg=f"{what} step {step} norm")
            assert (float(j_norm) > max_norm) == (max_norm < 1.0), what
            rtol = 2.0**-7 * step if bf16 else 1e-5
            for i, (p, jp) in enumerate(zip(params, j_params)):
                np.testing.assert_allclose(
                    p.float().numpy(), np.asarray(jp.astype(jnp.float32)),
                    rtol=2.0**-7 * step if p_dt == torch.bfloat16 else 1e-5,
                    atol=lr * 2.0**-6 * step if bf16 else lr * 1e-4,
                    err_msg=f"{what} step {step} p[{i}]")
            for name, ours, theirs in (("m", ms, j_state.m), ("v", vs, j_state.v)):
                for i, (a, b) in enumerate(zip(ours, theirs)):
                    np.testing.assert_allclose(
                        a.numpy(), np.asarray(b), rtol=rtol,
                        atol=rtol * float(np.abs(np.asarray(b)).max(initial=0.0)) if bf16
                        else 1e-7, err_msg=f"{what} step {step} {name}[{i}]")
            if deltas:
                want = [np.linalg.norm(np.asarray(n.astype(jnp.float32))
                                       - np.asarray(o.astype(jnp.float32)))
                        for n, o in zip(j_params, j_old)]
                assert len(delta_norms) == len(shapes), what
                np.testing.assert_allclose(
                    [float(d) for d in delta_norms], want, rtol=5e-2 if bf16 else 1e-4,
                    atol=1e-7, err_msg=f"{what} step {step} delta_norms")


def _clip_adamw_chunk_table():
    """The kernels' chunk table in pure Python: each chunk of a launch,
    found by ``csrc/adamw.cu``'s search (the last leaf whose first chunk is
    at or before it), covers ``CHUNK`` elements of one leaf, the last chunk
    of a leaf its ragged tail (a leaf whose gradient is transposed: a
    ``TILE`` x ``TILE`` square of one of its matrices, those on the edges
    ragged); together they cover every element of every leaf once, an
    empty leaf none, a leaf under one chunk in one chunk, and more than
    ``MAX_LEAVES`` leaves in several launches whose chunks number the
    step's partial sums in order.  The table's entries and flags."""

    def leaf_of(starts, n, c):
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if starts[mid] <= c:
                lo = mid
            else:
                hi = mid - 1
        return lo

    chunk, tile = aw.CHUNK, aw.TILE
    cases = [
        [((chunk,), False)],  # one whole chunk
        [((1,), False), ((chunk - 1,), False), ((chunk + 1,), False), ((3, chunk + 5), False)],
        [((0,), False), ((5,), False), ((0, 4), False), ((0,), False), ((2 * chunk,), False),
         ((0,), False)],  # empty leaves first, between and last
        [((7,), False)] * 300 + [((chunk + 3,), False)] * 300 + [((0,), False)] * 50,
        [((0,), False), ((0,), False)],
        # Transposed gradients: a matrix under one square, ragged edges both
        # ways (the MoE experts' 512 x 1365), a batch of matrices, one empty.
        [((3, 5), True), ((8, 512, 1365), True), ((2, tile, tile + 1), True),
         ((4, 0, 7), True), ((33,), False)],
    ]
    for leaves in cases:
        counts = [aw.leaf_chunks(shape, tiled) for shape, tiled in leaves]
        groups = aw.chunk_groups(counts)
        assert [g.first for g in groups] == list(range(0, len(leaves), aw.MAX_LEAVES))
        assert sum(g.count for g in groups) == len(leaves)
        seen = [[] for _ in leaves]
        chunk0 = 0
        for g in groups:
            assert g.chunk0 == chunk0 and g.count <= aw.MAX_LEAVES
            mine = leaves[g.first:g.first + g.count]
            params = [torch.zeros(shape) for shape, _ in mine]
            grads = [torch.zeros(shape[:-2] + shape[:-3:-1]).transpose(-1, -2) if tiled
                     else torch.zeros(shape) for shape, tiled in mine]
            trans = [aw.transposed(t) for t in grads]
            table = aw.leaf_table(g._replace(first=0), grads, params, params, params, trans)
            assert len(table) == aw.FIELDS * g.count
            entry = [table[k * aw.FIELDS:(k + 1) * aw.FIELDS] for k in range(g.count)]
            starts = [e[5] for e in entry] + [g.chunks]
            for (shape, tiled), e in zip(mine, entry):
                assert e[4] == math.prod(shape)
                trans = tiled and math.prod(shape) > 0
                assert bool(e[6] & aw.TRANS) == trans
                assert (e[7], e[8]) == (shape[-2:] if trans else (0, 0))
            for c in range(g.chunks):
                k = leaf_of(starts, g.count, c)
                shape, tiled = mine[k]
                local = c - starts[k]
                if entry[k][6] & aw.TRANS:
                    rows, cols = shape[-2:]
                    rb, cb = -(-rows // tile), -(-cols // tile)
                    b, sq = divmod(local, rb * cb)
                    r0, c0 = (sq // cb) * tile, (sq % cb) * tile
                    assert b < math.prod(shape[:-2]) and r0 < rows and c0 < cols
                    seen[g.first + k].append(
                        (b, r0, c0, (min(r0 + tile, rows) - r0) * (min(c0 + tile, cols) - c0)))
                else:
                    e0 = local * chunk
                    n = min(chunk, math.prod(shape) - e0)
                    assert 0 < n <= chunk
                    seen[g.first + k].append((e0, n))
            chunk0 += g.chunks
        for (shape, _), spans in zip(leaves, seen):
            # Distinct chunks whose sizes add up to the leaf: each element once.
            assert len(set(spans)) == len(spans), shape
            assert sum(span[-1] for span in spans) == math.prod(shape), (shape, spans[:4])
            if spans and len(spans[0]) == 2:
                assert sorted(spans) == [(a, min(chunk, math.prod(shape) - a))
                                         for a in range(0, math.prod(shape), chunk)]
        assert chunk0 == sum(counts)
    # Flags: bf16 parameter and gradient; vectors only where every pointer
    # allows four-element loads (an offset view does not); a gradient
    # transposed in its last two dims, and what the norm alone reads.
    p = torch.zeros(64, dtype=torch.bfloat16)
    g, m, v = torch.zeros(64), torch.zeros(64), torch.zeros(64)
    assert aw.leaf_flags(g, p, m, v) == aw.P_BF16 | aw.VEC | aw.G_VEC
    assert aw.leaf_flags(g[1:], p[1:], m[1:], v[1:]) == aw.P_BF16
    assert aw.leaf_flags(p) == aw.G_BF16 | aw.G_VEC
    w, gt = torch.zeros(8, 6), torch.zeros(6, 8).t()
    assert aw.transposed(gt) and not aw.transposed(w) and not aw.transposed(w[:, :3])
    assert aw.leaf_flags(gt, w, w, w, trans=True) == aw.TRANS | aw.G_VEC
    assert aw.leaf_flags(gt) == aw.G_VEC


# ------------------------------------------------------------------------
# The JAX package's last public functions: ``make_ring_attention``, ``rope``,
# ``transformer_block``, ``state_dict_from_params``, ``mfu``,
# ``attach_manifest`` and the reference's pre-tokenization entry points.


def _public_functions_match_jax(tmp_path):
    """``make_ring_attention`` on a stacked ring of 4 against the JAX one
    over a 4-device CPU mesh at ``tests/test_kernels.py``'s shape, causal
    and not, with the gradient of q (atol 2e-5); ``rope`` and
    ``transformer_block`` (the plain and the kernel knobs) within 1e-5;
    ``state_dict_from_params`` with JAX's keys and values, tied and
    two-matrix configs too, and back through ``params_from_state_dict``;
    ``mfu`` equal to JAX's formula over the H100 peak, None where JAX's is;
    ``attach_manifest`` keeping the payload when the manifest fails; and
    ``pretokenize``, ``serial_pretokenization`` and
    ``parallel_pretokenization`` (2 workers) giving JAX's counters."""
    import contextlib
    import dataclasses
    import io

    from bpe_transformer_tpu.models import TS_TEST_CONFIG as JAX_TS
    from bpe_transformer_tpu.models import init_params as jax_init_params
    from bpe_transformer_tpu.models import state_dict_from_params as jax_state_dict
    from bpe_transformer_tpu.models import transformer_block as jax_block
    from bpe_transformer_tpu.ops import rope as jax_rope
    from bpe_transformer_tpu.telemetry.manifest import attach_manifest as jax_attach
    from bpe_transformer_tpu.tokenization import pretokenization as jax_pretok
    from bpe_transformer_tpu.utils import flops as jax_flops
    from bpe_transformer_tpu_torch.models import (
        ModelConfig,
        params_from_state_dict,
        state_dict_from_params,
        transformer_block,
    )
    from bpe_transformer_tpu_torch.models.transformer import params_from_jax
    from bpe_transformer_tpu_torch.ops import rope, rope_tables
    from bpe_transformer_tpu_torch.telemetry.manifest import attach_manifest
    from bpe_transformer_tpu_torch.tokenization import (
        parallel_pretokenization,
        pretokenize,
        serial_pretokenization,
    )
    from bpe_transformer_tpu_torch.tree import tree_leaves
    from bpe_transformer_tpu_torch.utils.flops import mfu

    rng = np.random.default_rng(31)
    mesh = make_mesh({"data": 4}, devices=jax.devices()[:4])
    q, k, v = (rng.standard_normal((2, 2, 4 * 32, 32)).astype(np.float32) for _ in range(3))
    g = rng.standard_normal(q.shape).astype(np.float32)
    for causal in (True, False):
        jax_fn = jax_ring.make_ring_attention(mesh, "data", causal)
        want, vjp = jax.vjp(jax.jit(lambda q_: jax_fn(q_, jnp.asarray(k), jnp.asarray(v))),
                            jnp.asarray(q))
        fn = parallel.make_ring_attention(parallel.StackedRing(4), causal=causal)
        tq = torch.from_numpy(q).requires_grad_(True)
        got = fn(tq, torch.from_numpy(k), torch.from_numpy(v))
        got.backward(torch.from_numpy(g))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5,
                                   err_msg=f"make_ring_attention causal={causal}")
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   atol=2e-5, err_msg=f"make_ring_attention dq causal={causal}")
    with pytest.raises(ValueError, match="not divisible"):
        fn(*(torch.zeros(1, 1, 6, 4),) * 3)

    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    positions = rng.integers(0, 20, size=(2, 1, 8))
    for kw in ({}, {"theta": 500.0, "max_seq_len": 40}):
        np.testing.assert_allclose(
            rope(torch.from_numpy(x), torch.from_numpy(positions), **kw).numpy(),
            np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(positions), **kw)), atol=1e-5,
            err_msg=f"rope {kw}")

    for knobs in ({}, dict(attention_impl="flash", ffn_impl="pallas")):
        jax_cfg = dataclasses.replace(JAX_TS, num_kv_heads=2, **knobs)
        cfg = ModelConfig.from_dict(dataclasses.asdict(jax_cfg))
        jax_params = jax.tree_util.tree_map(
            lambda a: a * 8 if a.ndim == 2 else a, jax_init_params(jax.random.PRNGKey(2), jax_cfg))
        block = params_from_jax(jax.device_get(jax_params["layers"][0]), device="cpu")
        h = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
        cos, sin = rope_tables(cfg.d_head, cfg.context_length, cfg.rope_theta)
        want = jax_block(jnp.asarray(h), jax_params["layers"][0], jax_cfg,
                         (jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())), jnp.arange(8))
        got = transformer_block(torch.from_numpy(h), block, cfg, (cos, sin), torch.arange(8))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=f"transformer_block {knobs}")

    for extra in ({}, {"tie_embeddings": True}, {"ffn_type": "gelu"}):
        jax_cfg = dataclasses.replace(JAX_TS, **extra)
        jax_params = jax.device_get(jax_init_params(jax.random.PRNGKey(4), jax_cfg))
        want = jax_state_dict(jax_params)
        got = state_dict_from_params(params_from_jax(jax_params, device="cpu"))
        assert list(got) == list(want), (extra, set(got) ^ set(want))
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        back = params_from_state_dict(got, jax_cfg.num_layers,
                                      tied=bool(extra.get("tie_embeddings")), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(params_from_jax(jax_params, device="cpu")),
            strict=True)), extra

    h100 = "NVIDIA H100 80GB HBM3"
    for cfg_args in ((JAX_TS, 8, 0.25), (JAX_TS, 4, 0.5, h100, 4, 64)):
        jax_cfg, batch, step_s = cfg_args[:3]
        kind, chips, seq = (cfg_args[3:] + (h100, 1, None))[:3]
        cfg = ModelConfig.from_dict(dataclasses.asdict(jax_cfg))
        want = jax_flops.train_step_flops(jax_cfg, batch, seq) / step_s / (989e12 * chips)
        assert mfu(cfg, batch, step_s, kind, chips, seq) == pytest.approx(want, rel=1e-12)
    cfg = ModelConfig.from_dict(dataclasses.asdict(JAX_TS))
    for args in ((8, 0.0, h100), (8, -1.0, h100), (8, 0.25, "cpu")):
        assert mfu(cfg, *args) is None and jax_flops.mfu(JAX_TS, *args) is None, args

    for fn in (attach_manifest, jax_attach):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            payload = fn({"value": 1.5}, "bench", not_a_manifest_field=True)
        assert payload == {"value": 1.5}, payload
        assert "manifest attach failed" in err.getvalue(), err.getvalue()
    assert attach_manifest({"value": 1.5}, "bench")["manifest"]["run_kind"] == "bench"

    corpus = tmp_path / "pretok.txt"
    corpus.write_text("<|endoftext|>".join(
        f"Once upon a time {i}, there were {i * 7} cats' toys.\n  Über straße 2024!"
        for i in range(200)), encoding="utf-8")
    specials = ["<|endoftext|>"]
    for name, args, kw in (
        ("serial_pretokenization", (corpus,), {"special_tokens": specials}),
        ("parallel_pretokenization", (corpus, 2), {"special_tokens": specials}),
        ("pretokenize", (corpus,), {"n_workers": 2, "special_tokens": specials}),
        ("pretokenize", (corpus, False, False), {"special_tokens": specials}),
    ):
        want = getattr(jax_pretok, name)(*args, **kw)
        got = {"serial_pretokenization": serial_pretokenization,
               "parallel_pretokenization": parallel_pretokenization,
               "pretokenize": pretokenize}[name](*args, **kw)
        assert got == want and sum(got.values()) > 1000, (name, args)


# ------------------------------------------------------------------------
# The reference adapter surface (``compat/adapters.py``).

class _AdapterNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(20, 30)
        self.fc2 = torch.nn.Linear(30, 5)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _adamw_run(adapters, steps: int = 3):
    """``steps`` updates of the adapter AdamW on a seeded net: the net and
    its optimizer."""
    torch.manual_seed(0)
    model = _AdapterNet()
    opt = adapters.get_adamw_cls()(model.parameters(), lr=1e-2, weight_decay=0.01,
                                   betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        opt.zero_grad()
        x, y = torch.rand(4, 20, generator=gen), torch.rand(4, 5, generator=gen)
        ((model(x) - y) ** 2).sum().backward()
        opt.step()
    return model, opt


def _adapters_match_jax(tmp_path):
    """All 21 adapters of the port against the JAX package's on the same
    seeded torch inputs (CPU tensors), float32.  Tolerances: 1e-5 absolute
    for the ops, attention, norms and the block; the LM's logits 1e-4
    absolute (as JAX's own adapter test holds its LM); gradient clipping
    1e-6; the AdamW weights and moments 1e-6 absolute plus 1e-5 relative
    (the two updates round differently in the last place, and from step 2
    the gradients see it); a checkpoint read back exactly, and one step
    after it (the writer's optimizer against the reader's) as AdamW.  Three AdamW steps, state keys and dtypes as JAX's facade keeps
    them; checkpoint files cross between the packages both ways; a trained
    tokenizer is identical."""
    from bpe_transformer_tpu import compat as jax_adapters
    from bpe_transformer_tpu_torch import compat as adapters

    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    d, ff, heads, vocab, layers, ctx = 32, 64, 4, 64, 2, 16

    def same(name, got, want, atol=1e-5, rtol=0.0):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol,
                                   err_msg=name)

    def both(name, *args, atol=1e-5, **kw):
        same(name, getattr(adapters, name)(*args, **kw),
             getattr(jax_adapters, name)(*args, **kw), atol=atol)

    x = rand(2, 12, d)
    w = rand(d, d) * 0.1
    both("run_linear", d, d, w, x)
    both("run_embedding", vocab, d, rand(vocab, d), torch.randint(0, vocab, (2, 12), generator=g))
    w1, w2, w3 = rand(ff, d) * 0.1, rand(d, ff) * 0.1, rand(ff, d) * 0.1
    both("run_swiglu", d, ff, w1, w2, w3, x)
    q, k, v = rand(2, 3, 12, 8), rand(2, 3, 16, 8), rand(2, 3, 16, 8)
    both("run_scaled_dot_product_attention", q, k, v, rand(2, 3, 12, 16) > 0.5)
    both("run_scaled_dot_product_attention", q, k, v)
    projs = [rand(d, d) * 0.1 for _ in range(4)]
    both("run_multihead_self_attention", d, heads, *projs, x)
    positions = torch.arange(12).repeat(2, 1)
    both("run_multihead_self_attention_with_rope", d, heads, ctx, 10000.0, *projs, x, positions)
    both("run_rope", 8, 10000.0, ctx, rand(2, 12, 8), positions)
    both("run_rmsnorm", d, 1e-5, 1 + 0.1 * rand(d), x)
    both("run_silu", x)
    both("run_softmax", x + 100, 1)
    both("run_cross_entropy", rand(8, vocab) * 10, torch.randint(0, vocab, (8,), generator=g))
    sd = {"token_embeddings.weight": rand(vocab, d) * 0.05,
          "ln_final.weight": 1 + 0.1 * rand(d), "lm_head.weight": rand(vocab, d) * 0.05}
    for i in range(layers):
        p = f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "output_proj"):
            sd[p + f"attn.{name}.weight"] = rand(d, d) * 0.05
        sd[p + "ln1.weight"] = 1 + 0.1 * rand(d)
        sd[p + "ln2.weight"] = 1 + 0.1 * rand(d)
        sd[p + "ffn.w1.weight"] = rand(ff, d) * 0.05
        sd[p + "ffn.w2.weight"] = rand(d, ff) * 0.05
        sd[p + "ffn.w3.weight"] = rand(ff, d) * 0.05
    block = {k[len("layers.0."):]: v for k, v in sd.items() if k.startswith("layers.0.")}
    both("run_transformer_block", d, heads, ff, ctx, 10000.0, block, x)
    both("run_transformer_lm", vocab, ctx, d, layers, heads, ff, 10000.0, sd,
         torch.randint(0, vocab, (2, 12), generator=g), atol=1e-4)
    for it in (0, 3, 7, 12, 21, 24):
        assert adapters.run_get_lr_cosine_schedule(it, 1.0, 0.1, 7, 21) == (
            jax_adapters.run_get_lr_cosine_schedule(it, 1.0, 0.1, 7, 21)), it

    # Gradient clipping, in place, on the same gradients.
    grads = [rand(5, 5) for _ in range(3)]
    clipped = []
    for module in (adapters, jax_adapters):
        ps = [torch.nn.Parameter(t.clone()) for t in grads]
        for p, t in zip(ps, grads):
            p.grad = t.clone() * 10
        ps[-1].grad = None
        module.run_gradient_clipping(ps, 1e-2)
        clipped.append([p.grad for p in ps[:-1]])
    for a, b in zip(*clipped):
        same("run_gradient_clipping", a, b, atol=1e-6)

    # Three AdamW steps: the weights and the state keys, dtypes and values.
    (port_model, port_opt), (jax_model, jax_opt) = (
        _adamw_run(adapters), _adamw_run(jax_adapters))
    for key, value in port_model.state_dict().items():
        same(f"adamw {key}", value, jax_model.state_dict()[key], atol=1e-6, rtol=1e-5)
    port_state, jax_state = port_opt.state_dict()["state"], jax_opt.state_dict()["state"]
    assert port_state.keys() == jax_state.keys()
    for i in port_state:
        assert port_state[i].keys() == jax_state[i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for sub, val in port_state[i].items():
            assert val.dtype == jax_state[i][sub].dtype and val.device.type == "cpu", sub
            same(f"adamw state {i}.{sub}", val, jax_state[i][sub], atol=1e-6, rtol=1e-5)
    assert int(port_state[0]["step"]) == 3

    # Checkpoint files cross both ways; training then continues alike.
    writers = ((adapters, jax_adapters, "port.ckpt"), (jax_adapters, adapters, "jax.ckpt"))
    for saver, loader, name in writers:
        model, opt = _adamw_run(saver)
        saver.run_save_checkpoint(model, opt, iteration=3, out=tmp_path / name)
        fresh = _AdapterNet()
        fresh_opt = loader.get_adamw_cls()(fresh.parameters(), lr=1e-2, weight_decay=0.01,
                                           betas=(0.9, 0.999), eps=1e-8)
        assert loader.run_load_checkpoint(tmp_path / name, fresh, fresh_opt) == 3, name
        for key, value in model.state_dict().items():
            same(f"{name} {key}", fresh.state_dict()[key], value, atol=0.0)
        for i, st in opt.state_dict()["state"].items():
            for sub, val in st.items():
                same(f"{name} state {sub}", fresh_opt.state_dict()["state"][i][sub], val,
                     atol=0.0)
        x, y = torch.rand(4, 20), torch.rand(4, 5)
        for m, o in ((model, opt), (fresh, fresh_opt)):
            o.zero_grad()
            ((m(x) - y) ** 2).sum().backward()
            o.step()
        for key, value in model.state_dict().items():
            same(f"{name} resumed {key}", fresh.state_dict()[key], value, atol=1e-6,
                 rtol=1e-5)

    # run_get_batch on the device asked for; the JAX adapter's contract.
    dataset = np.arange(100)
    for module in (adapters, jax_adapters):
        bx, by = module.run_get_batch(dataset, 8, 7, "cpu")
        assert bx.dtype == by.dtype == torch.int64 and bx.shape == (8, 7), module
        assert bx.device.type == "cpu" and torch.equal(bx + 1, by), module
        with pytest.raises((RuntimeError, AssertionError)):
            module.run_get_batch(dataset, 8, 7, "cuda:99")

    # Tokenization: a trained vocabulary and its encoder.
    corpus = tmp_path / "adapters_corpus.txt"
    corpus.write_text("the cat sat on the mat. it's 42 中文!<|endoftext|>\n" * 40)
    got = adapters.run_train_bpe(corpus, 300, ["<|endoftext|>"])
    want = jax_adapters.run_train_bpe(corpus, 300, ["<|endoftext|>"])
    assert got == want and len(got[1]) > 10
    text = "the mat sat<|endoftext|> on 42"
    tok, jax_tok = (m.get_tokenizer(dict(got[0]), got[1], ["<|endoftext|>"])
                    for m in (adapters, jax_adapters))
    assert tok.encode(text) == jax_tok.encode(text) and tok.decode(tok.encode(text)) == text
    assert set(adapters.__all__) == set(jax_adapters.__all__) - {"ensure_shard_map"}
    assert len(adapters.__all__) == 21
