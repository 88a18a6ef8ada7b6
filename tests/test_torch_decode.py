"""The PyTorch port's KV-cached prefill and decode step held against the JAX
package's, with the kernel knobs of the ported serving path
(``attention_impl="flash"``, ``ffn_impl="pallas"``,
``decode_attention_impl="pallas"``).

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs on the CPU (``device="cpu"``), where its kernel wrappers take their
plain versions.  Logits agree to 1e-4, the tolerance of the JAX package's
own trained-fixture test.
"""

import dataclasses
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
import torch

from bpe_transformer_tpu.models import TS_TEST_CONFIG as JAX_TS_TEST_CONFIG
from bpe_transformer_tpu.models import decode as jax_decode
from bpe_transformer_tpu.models import init_params as jax_init_params
from bpe_transformer_tpu.models.transformer import (
    params_from_state_dict as jax_params_from_state_dict,
)
from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG, ModelConfig
from bpe_transformer_tpu_torch.models.decode import decode_step, init_kv_cache, prefill
from bpe_transformer_tpu_torch.models.transformer import (
    params_from_jax,
    params_from_state_dict,
)

FIXTURE = Path(__file__).parent / "fixtures" / "trained_3l64d.npz"
KERNEL_KNOBS = dict(attention_impl="flash", ffn_impl="pallas", decode_attention_impl="pallas")


def _run_both(jax_params, torch_params, jax_cfg, cfg, ids, last_pos, steps):
    """Prefill ``ids`` at ragged ``last_pos`` in both packages, then take
    ``steps`` greedy decode steps at per-sequence positions with the third
    sequence inactive; assert logits and caches agree at every stage."""
    batch = ids.shape[0]
    active = np.array([i != 2 for i in range(batch)])
    j_prefill = jax.jit(
        lambda p, t, c, lp: jax_decode.prefill(p, t, jax_cfg, c, last_pos=lp)
    )
    j_step = jax.jit(
        lambda p, t, pos, c, a: jax_decode.decode_step(p, t, pos, c, jax_cfg, active=a)
    )
    j_cache = jax_decode.init_kv_cache(jax_cfg, batch)
    j_logits, j_cache = j_prefill(jax_params, jnp.asarray(ids), j_cache, jnp.asarray(last_pos))
    cache = init_kv_cache(cfg, batch, device="cpu")
    with torch.inference_mode():
        logits, _ = prefill(
            torch_params, torch.as_tensor(ids), cfg, cache,
            last_pos=torch.as_tensor(last_pos),
        )
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, err_msg="prefill")

    pos = np.asarray(last_pos) + 1
    token = np.argmax(np.asarray(j_logits), axis=-1).astype(np.int32)
    for step in range(steps):
        j_logits, j_cache = j_step(
            jax_params, jnp.asarray(token), jnp.asarray(pos, jnp.int32), j_cache,
            jnp.asarray(active),
        )
        with torch.inference_mode():
            logits, _ = decode_step(
                torch_params, torch.as_tensor(token, dtype=torch.int64),
                torch.as_tensor(pos), cache, cfg, active=torch.as_tensor(active),
            )
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(
            logits.numpy()[active], np.asarray(j_logits)[active], atol=1e-4,
            err_msg=f"decode step {step}",
        )
        for layer, (j_layer, t_layer) in enumerate(zip(j_cache, cache)):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    t_layer[name].numpy(), np.asarray(j_layer[name]), atol=1e-5,
                    err_msg=f"cache layer {layer} {name} after step {step}",
                )
        token = np.where(active, np.argmax(np.asarray(j_logits), axis=-1), token)
        pos = np.where(active, pos + 1, pos)


def test_torch_prefill_and_decode_match_jax():
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    state_dict = {k: v for k, v in arrays.items() if not k.startswith("pin/")}
    ids = arrays["pin/input_ids"]

    # The trained fixture: the port's prefill reproduces the pinned logits
    # of the last position, and prefill + decode agree with the JAX package.
    cfg = dataclasses.replace(TS_TEST_CONFIG, **KERNEL_KNOBS)
    jax_cfg = dataclasses.replace(JAX_TS_TEST_CONFIG, **KERNEL_KNOBS)
    torch_params = params_from_state_dict(state_dict, cfg.num_layers, device="cpu")
    with torch.inference_mode():
        logits, _ = prefill(
            torch_params, torch.as_tensor(ids), cfg, init_kv_cache(cfg, ids.shape[0], device="cpu")
        )
    np.testing.assert_allclose(logits.numpy(), arrays["pin/logits"][:, -1], atol=1e-4)
    jax_params = jax_params_from_state_dict(state_dict, cfg.num_layers)
    _run_both(
        jax_params, torch_params, jax_cfg, cfg, ids[:, :10],
        last_pos=np.array([9, 5, 7, 3], np.int32), steps=3,
    )

    # GQA with the post-norm and no-RMSNorm ablations, on random weights
    # carried across from JAX (8 times the init scale, so that the logits
    # are of order 1 and the tolerance bites); the config loads through its
    # dict in both packages.
    jax_cfg = dataclasses.replace(
        JAX_TS_TEST_CONFIG, vocab_size=96, context_length=24, num_kv_heads=2,
        use_post_norm=True, remove_rmsnorm=True, **KERNEL_KNOBS,
    )
    cfg = ModelConfig.from_dict(dataclasses.asdict(jax_cfg))
    jax_params = jax.tree_util.tree_map(
        lambda a: a * 8, jax_init_params(jax.random.PRNGKey(3), jax_cfg)
    )
    torch_params = params_from_jax(jax.device_get(jax_params), device="cpu")
    ids = np.random.default_rng(4).integers(0, 96, size=(3, 12)).astype(np.int32)
    _run_both(
        jax_params, torch_params, jax_cfg, cfg, ids,
        last_pos=np.array([11, 4, 8], np.int32), steps=2,
    )
