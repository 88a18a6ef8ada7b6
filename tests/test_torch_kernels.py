"""The PyTorch port's kernel modules held against the JAX package's kernels.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run in Pallas interpret mode on the CPU, as
``tests/test_kernels.py`` runs them.  The port's wrappers, given CPU
tensors, run their plain PyTorch versions; the CUDA kernels themselves are
held against those plain versions on the card by ``chip_smoke.py``.
Tolerances are the JAX float32 kernel tests' atol: 2e-5 for both
attentions, 1e-5 for SwiGLU.
"""

import numpy as np

import jax.numpy as jnp
import torch

from bpe_transformer_tpu.kernels.pallas.decode_attention import (
    decode_attention as jax_decode_attention,
)
from bpe_transformer_tpu.kernels.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from bpe_transformer_tpu.kernels.pallas.swiglu import swiglu_fused as jax_swiglu
from bpe_transformer_tpu_torch.kernels import decode_attention as da
from bpe_transformer_tpu_torch.kernels import flash_attention as fa
from bpe_transformer_tpu_torch.kernels import swiglu as sw


def test_torch_kernel_plain_versions_match_jax_kernels():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    counts_before = (da.launches, fa.launches, sw.launches)

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

    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (da.launches, fa.launches, sw.launches) == counts_before
