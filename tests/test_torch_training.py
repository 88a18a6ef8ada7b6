"""The PyTorch port's single-device training path held against the JAX
package's.

Inputs are made with numpy from a seed; JAX weights are carried to the port
with ``params_from_jax``.  The JAX side runs its Pallas kernels in interpret
mode on the CPU; the port runs on the CPU (``device="cpu"``), where its
kernel wrappers take their plain versions (the CUDA kernels are held against
those on the card by ``chip_smoke.py``).  Tolerances: 1e-4, the JAX
package's trained-fixture trajectory test; 1e-6 between the port's own
remat policies, which change where activations are recomputed, not the
arithmetic.
"""

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bpe_transformer_tpu.checkpointing import save_checkpoint as jax_save_checkpoint
from bpe_transformer_tpu.models import init_params as jax_init_params
from bpe_transformer_tpu.models.config import ModelConfig as JaxModelConfig
from bpe_transformer_tpu.optim import adamw_init as jax_adamw_init
from bpe_transformer_tpu.training.loop import LoopConfig as JaxLoopConfig
from bpe_transformer_tpu.training.loop import train as jax_train
from bpe_transformer_tpu.training.train_step import TrainHParams as JaxTrainHParams
from bpe_transformer_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from bpe_transformer_tpu_torch.checkpointing import load_checkpoint
from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG, ModelConfig
from bpe_transformer_tpu_torch.models.transformer import params_from_jax, params_from_state_dict
from bpe_transformer_tpu_torch.optim import adamw_init
from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    make_loss_fn,
    make_train_step,
    value_and_grad,
)
from bpe_transformer_tpu_torch.tree import tree_leaves

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "trained_3l64d.npz"
TOKENS = REPO / "benchmarks" / "northstar_tokens.npz"
KERNEL_KNOBS = dict(attention_impl="flash", ffn_impl="pallas")
FUSED_KNOBS = dict(attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas")


def _jax_config(cfg: ModelConfig) -> JaxModelConfig:
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0, err_msg=what)


def _pinned_trajectory():
    """(a) Five port train steps from the trained 3-layer state on the
    ``default_rng(2)`` batches of tests/test_trained_fixture.py reproduce the
    pinned losses and lm_head."""
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    state_dict = {k: v for k, v in arrays.items() if not k.startswith("pin/")}
    tokens = np.load(TOKENS)["tokens"]
    for knobs in ({}, KERNEL_KNOBS):
        cfg = dataclasses.replace(TS_TEST_CONFIG, **knobs)
        params = params_from_state_dict(state_dict, cfg.num_layers, device="cpu")
        opt_state = adamw_init(params)
        step = make_train_step(cfg, TrainHParams())
        rng = np.random.default_rng(2)
        losses = []
        for _ in range(5):
            starts = rng.integers(0, len(tokens) - cfg.context_length - 1, size=32)
            x = np.stack([tokens[s : s + cfg.context_length] for s in starts])
            y = np.stack([tokens[s + 1 : s + cfg.context_length + 1] for s in starts])
            params, opt_state, m = step(
                params, opt_state, torch.as_tensor(x.astype(np.int64)),
                torch.as_tensor(y.astype(np.int64)),
            )
            losses.append(float(m["loss"]))
        _close(losses, arrays["pin/traj_losses"], 1e-4, f"trajectory losses {knobs}")
        _close(params["lm_head"].detach(), arrays["pin/traj_lm_head"], 1e-4,
               f"trajectory lm_head {knobs}")


def _one_step_grads():
    """(b) One step's loss and gradients against ``jax.value_and_grad`` of
    the JAX ``make_loss_fn``, over the attention/FFN kernel knobs, GQA and
    the chunked loss; the four remat policies agree with each other."""
    base = ModelConfig(
        vocab_size=97, context_length=32, d_model=64, num_layers=2, num_heads=4, d_ff=96,
    )
    rng = np.random.default_rng(5)
    x = rng.integers(0, base.vocab_size, size=(2, 32))
    y = rng.integers(0, base.vocab_size, size=(2, 32))
    cases = [
        dict(),
        dict(loss_chunk_size=8, **KERNEL_KNOBS),
        dict(**FUSED_KNOBS),
        dict(num_kv_heads=2, loss_chunk_size=16, **KERNEL_KNOBS),
    ]
    for knobs in cases:
        cfg = dataclasses.replace(base, **knobs)
        jax_params = jax_init_params(jax.random.PRNGKey(1), _jax_config(cfg))
        jax_grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(_jax_config(cfg))))
        want_loss, want_grads = jax_grad_fn(jax_params, jnp.asarray(x), jnp.asarray(y))
        params = params_from_jax(jax.device_get(jax_params), device="cpu")
        loss, grads = value_and_grad(make_loss_fn(cfg))(
            params, torch.as_tensor(x), torch.as_tensor(y)
        )
        _close(float(loss), float(want_loss), 1e-4, f"loss {knobs}")
        want_leaves = tree_leaves(jax.tree_util.tree_map(np.asarray, want_grads))
        got_leaves = tree_leaves(grads)
        assert len(got_leaves) == len(want_leaves)
        for got, want in zip(got_leaves, want_leaves):
            _close(got, want, 1e-4, f"grads {knobs}")

        if knobs == cases[1]:
            for policy in ("full", "dots_saveable", "save_attn"):
                c = dataclasses.replace(cfg, remat_policy=policy)
                loss_p, grads_p = value_and_grad(make_loss_fn(c))(
                    params, torch.as_tensor(x), torch.as_tensor(y)
                )
                _close(float(loss_p), float(loss), 1e-6, f"loss remat {policy}")
                for got, want in zip(tree_leaves(grads_p), got_leaves):
                    _close(got, want, 1e-6, f"grads remat {policy}")


def _loops_from_one_checkpoint(tmp_path):
    """(c) The JAX ``train()`` and the port's ``train()``, both resumed from
    the same JAX-written step-0 checkpoint: per-step losses and the eval
    loss agree; the port's loader maps the JAX ``AdamWState`` and refuses
    any other global of the JAX package."""
    cfg = ModelConfig(
        vocab_size=97, context_length=16, d_model=32, num_layers=2, num_heads=2, d_ff=64,
    )
    jcfg = _jax_config(cfg)
    rng = np.random.default_rng(7)
    train_data = rng.integers(0, cfg.vocab_size, size=3000).astype(np.uint16)
    val_data = rng.integers(0, cfg.vocab_size, size=600).astype(np.uint16)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    ckpt = tmp_path / "step0.ckpt"
    jax_save_checkpoint(ckpt, params=params, opt_state=jax_adamw_init(params), iteration=0)

    hp = dict(warmup_iters=1, cosine_cycle_iters=3, max_learning_rate=1e-2)
    lp = dict(steps=3, batch_size=4, log_every=1, eval_every=3, eval_batches=2, seed=3)
    want = jax_train(jcfg, JaxTrainHParams(**hp), JaxLoopConfig(**lp), train_data, val_data,
                     resume_from=ckpt, log_fn=lambda *a: None)
    got = train(cfg, TrainHParams(**hp), LoopConfig(**lp), train_data, val_data,
                resume_from=ckpt, log_fn=lambda *a: None, device="cpu")
    want_losses = [r["loss"] for r in want["history"]]
    got_losses = [r["loss"] for r in got["history"]]
    assert len(got_losses) == len(want_losses) == 3
    _close(got_losses, want_losses, 1e-4, "loop losses")
    _close(got["final_val_loss"], want["final_val_loss"], 1e-4, "loop eval loss")
    np.testing.assert_allclose(
        [r["lr"] for r in got["history"]], [r["lr"] for r in want["history"]], rtol=1e-6
    )

    # Any other global of the JAX package in a checkpoint is refused.
    stranger = tmp_path / "stranger.ckpt"
    stranger.write_bytes(pickle.dumps({"format_version": 1, "extra": JaxLoopConfig()}))
    with pytest.raises(pickle.UnpicklingError, match="bpe_transformer_tpu.training.loop"):
        load_checkpoint(stranger)


def test_torch_training_matches_jax(tmp_path):
    _pinned_trajectory()
    _one_step_grads()
    _loops_from_one_checkpoint(tmp_path)
