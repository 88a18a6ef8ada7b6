"""The PyTorch port's single-device training path held against the JAX
package's.

Inputs are made with numpy from a seed; JAX weights are carried to the port
with ``params_from_jax``.  The JAX side runs its Pallas kernels in interpret
mode on the CPU; the port runs on the CPU (``device="cpu"``), where its
kernel wrappers take their plain versions (the CUDA kernels are held against
those on the card by ``chip_smoke.py``).  Tolerances: 1e-4, the JAX
package's trained-fixture trajectory test; 1e-6 between the port's own
remat policies, which change where activations are recomputed, not the
arithmetic.  The two-matrix FFNs (``ffn_type`` "silu" and "gelu") are held
to 1e-4 too, on every leaf after two AdamW steps, the unread ``w3`` included.
The sequence-parallel step (``parallel/sp.py``, four shards on a stacked
ring) is held to 1e-4 against JAX's ``make_sp_train_step`` on the 8-device
CPU mesh ``{"data": 2, "seq": 4}`` and against the port's own dense step.
Resuming from a corrupt checkpoint must quarantine and fall back exactly as
the JAX package does on the same directory.
"""

import dataclasses
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bpe_transformer_tpu.checkpointing import CheckpointCorruptionError as JaxCorruptionError
from bpe_transformer_tpu.checkpointing import load_checkpoint_with_fallback as jax_fallback
from bpe_transformer_tpu.checkpointing import save_checkpoint as jax_save_checkpoint
from bpe_transformer_tpu.models import init_params as jax_init_params
from bpe_transformer_tpu.models.config import ModelConfig as JaxModelConfig
from bpe_transformer_tpu.optim import adamw_init as jax_adamw_init
from bpe_transformer_tpu.parallel import make_mesh
from bpe_transformer_tpu.parallel import make_sp_train_step as jax_make_sp_train_step
from bpe_transformer_tpu.parallel import shard_sp_batch as jax_shard_sp_batch
from bpe_transformer_tpu.resilience import integrity as jax_integrity
from bpe_transformer_tpu.training.loop import LoopConfig as JaxLoopConfig
from bpe_transformer_tpu.training.loop import train as jax_train
from bpe_transformer_tpu.training.train_step import TrainHParams as JaxTrainHParams
from bpe_transformer_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from bpe_transformer_tpu.training.train_step import make_train_step as jax_make_train_step
from bpe_transformer_tpu_torch.checkpointing import (
    CheckpointCorruptionError,
    load_checkpoint,
    load_checkpoint_with_fallback,
    save_checkpoint,
    training_state,
)
from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG, ModelConfig
from bpe_transformer_tpu_torch.models.transformer import (
    forward,
    params_from_jax,
    params_from_state_dict,
)
from bpe_transformer_tpu_torch.optim import adamw_init
from bpe_transformer_tpu_torch.parallel import (
    StackedRing,
    make_sp_grad_fn,
    make_sp_train_step,
    shard_sp_batch,
    sp_forward,
)
from bpe_transformer_tpu_torch.resilience import integrity
from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    make_grad_accum_train_step,
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


def _two_matrix_ffns(tmp_path):
    """(d) The silu and gelu FFNs: two train steps of ``TS_TEST_CONFIG`` at
    vocab 512 from one JAX init, the port's ``make_train_step`` against
    JAX's: loss, grad norm and every leaf after each step (``w3``, which
    neither FFN reads, gets a zero gradient and shrinks by the decoupled
    weight decay alone); the gelu model also under ``save_attn``, which
    re-runs the GeLU forward in the backward.  The port's state after step
    one, through a checkpoint round trip, takes step two identically."""
    rng = np.random.default_rng(11)
    batches = [tuple(rng.integers(0, 512, size=(4, 16)) for _ in range(2)) for _ in range(2)]
    hp = dict(warmup_iters=1, cosine_cycle_iters=5, weight_decay=0.1)
    for knobs in (dict(ffn_type="silu"),
                  dict(ffn_type="gelu", remat_policy="save_attn", **KERNEL_KNOBS)):
        cfg = dataclasses.replace(TS_TEST_CONFIG, vocab_size=512, **knobs)
        jcfg = _jax_config(cfg)
        jax_params = jax_init_params(jax.random.PRNGKey(4), jcfg)
        params = params_from_jax(jax.device_get(jax_params), device="cpu")
        w3_init = params["layers"][0]["ffn"]["w3"].clone()
        jax_step = jax_make_train_step(jcfg, JaxTrainHParams(**hp))
        step = make_train_step(cfg, TrainHParams(**hp))
        j_state = (jax_params, jax_adamw_init(jax_params))
        state = (params, adamw_init(params))
        for i, (x, y) in enumerate(batches):
            if i == 1:
                ckpt = tmp_path / f"{cfg.ffn_type}.ckpt"
                save_checkpoint(ckpt, params=state[0], opt_state=state[1], iteration=1)
                reloaded = step(*training_state(load_checkpoint(ckpt), "cpu"),
                                torch.as_tensor(x), torch.as_tensor(y))
            *j_state, j_m = jax_step(*j_state, jnp.asarray(x), jnp.asarray(y))
            *state, m = step(*state, torch.as_tensor(x), torch.as_tensor(y))
            what = f"{knobs} step {i + 1}"
            _close(float(m["loss"]), float(j_m["loss"]), 1e-4, f"loss {what}")
            _close(float(m["grad_norm"]), float(j_m["grad_norm"]), 1e-4, f"grad norm {what}")
            want_leaves = tree_leaves(jax.tree_util.tree_map(np.asarray, j_state[0]))
            got_leaves = tree_leaves(state[0])
            assert len(got_leaves) == len(want_leaves)
            for got, want in zip(got_leaves, want_leaves):
                _close(got.detach(), want, 1e-4, f"params {what}")
        assert float(reloaded[2]["loss"]) == float(m["loss"])
        for got, want in zip(tree_leaves(reloaded[0]), tree_leaves(state[0])):
            assert torch.equal(got, want), f"{knobs}: the step after a checkpoint round trip"
        w3 = state[0]["layers"][0]["ffn"]["w3"].detach()
        assert not torch.equal(w3, w3_init) and float(w3.abs().sum()) < float(w3_init.abs().sum())


def _resume_through_verification(tmp_path):
    """(e) A resume from a checkpoint directory whose ``latest.ckpt`` has one
    bit flipped inside ``token_embeddings``: the port's ``train`` and the JAX
    package's ``load_checkpoint_with_fallback`` on copies of one directory
    quarantine the same file under the same name and load the same
    snapshot; a fallback never moves past the requested step; a snapshot
    whose bytes verify but whose load raises re-raises and stays."""
    data = np.random.default_rng(0).integers(0, 10_000, 4096).astype(np.uint16)
    src = tmp_path / "c1"
    train(TS_TEST_CONFIG, TrainHParams(),
          LoopConfig(steps=4, batch_size=4, checkpoint_every=2, seed=0,
                     checkpoint_dir=str(src)), data, log_fn=lambda *a: None, device="cpu")
    emb = load_checkpoint(src / "latest.ckpt")["params"]["token_embeddings"]
    raw = bytearray((src / "latest.ckpt").read_bytes())
    at = raw.find(emb.tobytes()[:256]) + 4 * 1000  # the low byte of element 1000
    raw[at] ^= 0x40
    (src / "latest.ckpt").write_bytes(bytes(raw))
    for name in ("latest.ckpt", "step_00000004.ckpt"):
        got, want = integrity.verify_checkpoint(src / name), jax_integrity.verify_checkpoint(
            src / name)
        assert (got.ok, got.problems) == (want.ok, want.problems), name
    assert not integrity.verify_checkpoint(src / "latest.ckpt").ok
    assert integrity.latest_valid_checkpoint(src).name == "step_00000004.ckpt"
    assert integrity.candidate_snapshots(src) == [src / "step_00000004.ckpt",
                                                  src / "step_00000002.ckpt"]

    def copy(name):
        dst = tmp_path / name
        shutil.copytree(src, dst)
        return dst

    def listing(directory):
        return sorted(p.name for p in directory.iterdir())

    jax_dir, port_dir = copy("c1_jax"), copy("c1_port")
    _, jax_used = jax_fallback(jax_dir / "latest.ckpt")
    logs = []
    summary = train(TS_TEST_CONFIG, TrainHParams(), LoopConfig(steps=4, batch_size=4, seed=0),
                    data, resume_from=port_dir, log_fn=logs.append, device="cpu")
    assert jax_used.name == "step_00000004.ckpt"
    assert logs == [f"resumed from {port_dir / jax_used.name} at iteration 4"], logs
    assert summary["history"] == []
    assert listing(port_dir) == listing(jax_dir)
    assert "latest.ckpt.corrupt" in listing(port_dir) and "latest.ckpt" not in listing(port_dir)

    # The requested step is corrupt: fall back to an earlier one only.
    for name, want_used in (("step_00000004.ckpt", "step_00000002.ckpt"),
                            ("step_00000002.ckpt", None)):
        dirs = copy(f"c1_jax_{name}"), copy(f"c1_port_{name}")
        for d in dirs:
            shutil.copyfile(d / "latest.ckpt", d / name)  # the flipped bytes, another name
        outcomes = []
        for d, fallback, error in ((dirs[0], jax_fallback, JaxCorruptionError),
                                   (dirs[1], load_checkpoint_with_fallback,
                                    CheckpointCorruptionError)):
            try:
                _, used = fallback(d / name)
                outcomes.append(used.name)
            except error as exc:
                outcomes.append(len(exc.failures))
        assert outcomes[0] == outcomes[1] == (want_used or 1), (name, outcomes)
        assert listing(dirs[0]) == listing(dirs[1]), name

    # Intact bytes whose load raises: re-raised, nothing quarantined.
    def failing_loader(path):
        raise RuntimeError(f"cannot place {path.name}")

    for fallback in (jax_fallback, load_checkpoint_with_fallback):
        with pytest.raises(RuntimeError, match="cannot place step_00000004.ckpt"):
            fallback(src / "step_00000004.ckpt", loader=failing_loader)
    assert "step_00000004.ckpt" in listing(src)


def _sp_step():
    """(f) Sequence parallelism on a stacked ring of four shards: one
    ``make_sp_train_step`` update against JAX's over ``{"data": 2, "seq":
    4}`` (ring-flash, contiguous), then the port's own variants (zig-zag,
    the plain rings, kv chunks, ``save_attn`` with per-example positions,
    gradient accumulation) against its dense step on the same batch, with
    ``sp_forward``'s logits against the dense forward's.  ``warmup_iters=0``
    so the first update moves every weight."""
    cfg = dataclasses.replace(TS_TEST_CONFIG, vocab_size=512, attention_impl="flash")
    jcfg = _jax_config(cfg)
    hp = dict(warmup_iters=0, cosine_cycle_iters=10)
    rng = np.random.default_rng(12)
    x, y = (rng.integers(0, cfg.vocab_size, size=(4, cfg.context_length)) for _ in range(2))
    jax_params = jax_init_params(jax.random.PRNGKey(3), jcfg)
    host = jax.device_get(jax_params)
    mesh = make_mesh({"data": 2, "seq": 4})
    jax_step = jax_make_sp_train_step(jcfg, JaxTrainHParams(**hp), mesh)
    jx, jy = jax_shard_sp_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    j_params, _, j_m = jax_step(jax_params, jax_adamw_init(jax_params), jx, jy)
    j_leaves = tree_leaves(jax.tree_util.tree_map(np.asarray, j_params))

    ring = StackedRing(4)
    dense = {}
    for accum in (1, 2):
        params = params_from_jax(host, device="cpu")
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        if accum == 1:
            step = make_train_step(cfg, TrainHParams(**hp))
        else:
            step = make_grad_accum_train_step(cfg, TrainHParams(**hp), accum)
            tx, ty = tx.reshape(accum, -1, tx.shape[-1]), ty.reshape(accum, -1, ty.shape[-1])
        dense[accum] = step(params, adamw_init(params), tx, ty)
    cases = [
        ("jax", cfg, {}),
        ("dense", cfg, {}),
        ("dense", cfg, dict(zigzag=True)),
        ("dense", dataclasses.replace(cfg, remat_policy="save_attn"), dict(zigzag=True)),
        ("dense", dataclasses.replace(cfg, attention_impl="xla"), {}),
        ("dense", dataclasses.replace(cfg, attention_impl="xla"), dict(zigzag=True)),
        ("dense", dataclasses.replace(cfg, attention_impl="xla", ring_kv_chunk=2), {}),
        ("dense", cfg, dict(accum_steps=2)),
    ]
    for against, c, kw in cases:
        what = f"sp step vs {against} {c.attention_impl} {c.remat_policy} {kw}"
        accum = kw.get("accum_steps", 1)
        zigzag = kw.get("zigzag", False)
        batch = (x, y) if accum == 1 else (x.reshape(accum, -1, x.shape[-1]),
                                           y.reshape(accum, -1, y.shape[-1]))
        tx, ty = shard_sp_batch(batch, ring, zigzag=zigzag, stacked=accum > 1, device="cpu")
        params = params_from_jax(host, device="cpu")
        p1, _, m = make_sp_train_step(c, TrainHParams(**hp), ring, **kw)(
            params, adamw_init(params), tx, ty)
        if against == "jax":
            want_loss, want_norm, want_leaves = j_m["loss"], j_m["grad_norm"], j_leaves
        else:
            d_params, _, d_m = dense[accum]
            want_loss, want_norm, want_leaves = d_m["loss"], d_m["grad_norm"], [
                t.detach() for t in tree_leaves(d_params)]
        _close(float(m["loss"]), float(want_loss), 1e-4, f"loss {what}")
        _close(float(m["grad_norm"]), float(want_norm), 1e-4, f"grad norm {what}")
        for got, want in zip(tree_leaves(p1), want_leaves, strict=True):
            _close(got.detach(), want, 1e-4, f"params {what}")

    params = params_from_jax(host, device="cpu")
    logits = sp_forward(params, shard_sp_batch(x, ring, device="cpu"), cfg, ring)
    want = forward(params, torch.as_tensor(x), cfg)
    _close(logits.permute(1, 0, 2, 3).reshape(want.shape).detach(), want.detach(), 1e-4,
           "sp_forward logits")
    loss, grads = make_sp_grad_fn(cfg, ring, zigzag=True)(
        params, *shard_sp_batch((x, y), ring, zigzag=True, device="cpu"))
    want_loss, want_grads = value_and_grad(make_loss_fn(cfg))(
        params, torch.as_tensor(x), torch.as_tensor(y))
    _close(float(loss), float(want_loss), 1e-5, "zig-zag sp loss")
    for got, want in zip(tree_leaves(grads), tree_leaves(want_grads), strict=True):
        _close(got, want, 1e-5, "zig-zag sp grads")

    # JAX's argument errors; Ulysses and scanned inner steps raise for the
    # multi-GPU slice, as does the loop's parallel="sp".
    hparams = TrainHParams(**hp)
    for kw, error, match in [
        (dict(accum_steps=0), ValueError, "accum_steps"),
        (dict(accum_steps=2, inner_steps=2), ValueError, "cannot both"),
        (dict(zigzag=True, ulysses=True), ValueError, "mutually exclusive"),
        (dict(ulysses=True), NotImplementedError, "multi-GPU"),
        (dict(inner_steps=2), NotImplementedError, "multi-GPU"),
    ]:
        with pytest.raises(error, match=match):
            make_sp_train_step(cfg, hparams, ring, **kw)
    for c, kw in ((dataclasses.replace(cfg, ring_kv_chunk=2), {}),
                  (dataclasses.replace(cfg, attention_impl="xla", ring_kv_chunk=2),
                   dict(zigzag=True))):
        with pytest.raises(ValueError, match="ring_kv_chunk"):
            make_sp_train_step(c, hparams, ring, **kw)
    with pytest.raises(NotImplementedError, match="slice 10"):
        train(cfg, hparams, LoopConfig(steps=1, batch_size=4, parallel="sp"),
              np.zeros(100, np.uint16), device="cpu")


def test_torch_training_matches_jax(tmp_path):
    _pinned_trajectory()
    _one_step_grads()
    _loops_from_one_checkpoint(tmp_path)
    _two_matrix_ffns(tmp_path)
    _resume_through_verification(tmp_path)
    _sp_step()
