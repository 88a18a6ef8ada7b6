"""The PyTorch port's kernel modules held against the JAX package's kernels.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run in Pallas interpret mode on the CPU, as
``tests/test_kernels.py`` runs them.  The port's wrappers, given CPU
tensors, run their plain PyTorch versions; the CUDA kernels themselves are
held against those plain versions on the card by ``chip_smoke.py``.
Tolerances are the JAX float32 kernel tests' atol: 2e-5 for the
attention forwards (and the lse), 3e-5 for the flash backward and the RoPE
table gradients, 1e-5 for SwiGLU and its gradient.
"""

import numpy as np

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
    flash_attention_with_lse as jax_flash_attention_with_lse,
)
from bpe_transformer_tpu.kernels.pallas.flash_attention import (
    flash_attention_with_rope as jax_flash_attention_with_rope,
)
from bpe_transformer_tpu.kernels.pallas.swiglu import swiglu_fused as jax_swiglu
from bpe_transformer_tpu.ops.rope import rope_tables as jax_rope_tables
from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.kernels import decode_attention as da
from bpe_transformer_tpu_torch.kernels import flash_attention as fa
from bpe_transformer_tpu_torch.kernels import swiglu as sw


def test_torch_kernel_plain_versions_match_jax_kernels():
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

    # CPU tensors take the plain versions: no kernel launch is counted.
    assert _build.launches == counts_before
