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
the JAX package does on the same directory.  The MoE family (loops (j) and
(k)): ``switch_ffn`` and its gradients, the tapped and scanned steps, the sp
step with each ring rank routing its own tokens, and the loop resumed from
a JAX-written MoE checkpoint, each against the JAX package's.  Loop (l):
performance attribution in the loop (the JAX probe's record keys, the live
state untouched by the probe, the analytic FLOPs against XLA's count) and
the debug helpers (``check_finite``'s message equal to JAX's).
"""

import dataclasses
import json
import os
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
    whose bytes verify but whose load raises re-raises and stays.  Then the
    port's own layout, ``latest.ckpt`` a symlink: the flipped bit in the
    snapshot it links to is quarantined alike by both packages, and the
    next save repoints both links."""
    data = np.random.default_rng(0).integers(0, 10_000, 4096).astype(np.uint16)
    src = tmp_path / "c1"
    loop = dict(steps=4, batch_size=4, checkpoint_every=2, seed=0)
    train(TS_TEST_CONFIG, TrainHParams(), LoopConfig(**loop, checkpoint_dir=str(src)), data,
          log_fn=lambda *a: None, device="cpu")
    linked = tmp_path / "c1_linked"
    shutil.copytree(src, linked, symlinks=True)
    # The port links latest.ckpt to the newest snapshot; the JAX package's
    # dense loop writes it as a byte copy.  Lay the directory out as the
    # JAX package does, so the flipped bit lands in latest.ckpt alone.
    for name in ("latest.ckpt", "latest.ckpt.crc32.json"):
        target = (src / name).resolve()
        (src / name).unlink()
        shutil.copyfile(target, src / name)

    def flip_bit(path):
        emb = load_checkpoint(path)["params"]["token_embeddings"]
        raw = bytearray(path.read_bytes())
        at = raw.find(emb.tobytes()[:256]) + 4 * 1000  # the low byte of element 1000
        raw[at] ^= 0x40
        path.write_bytes(bytes(raw))

    flip_bit(src / "latest.ckpt")
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

    # The port's layout: the bit flipped in the snapshot latest.ckpt links to.
    assert os.readlink(linked / "latest.ckpt") == "step_00000004.ckpt"
    flip_bit(linked / "step_00000004.ckpt")
    outcomes = []
    for name, fallback in (("jax", jax_fallback), ("port", load_checkpoint_with_fallback)):
        d = tmp_path / f"c1_linked_{name}"
        shutil.copytree(linked, d, symlinks=True)
        payload, used = fallback(d / "latest.ckpt")
        outcomes.append((used.name, payload["iteration"], listing(d)))
    assert outcomes[0] == outcomes[1], outcomes
    assert outcomes[1][:2] == ("step_00000002.ckpt", 2), outcomes[1]
    # The link goes, its target is quarantined with its sidecar, and the
    # sidecar's link is left dangling.
    assert outcomes[1][2] == [
        "latest.ckpt.crc32.json", "step_00000002.ckpt", "step_00000002.ckpt.crc32.json",
        "step_00000004.ckpt.corrupt", "step_00000004.ckpt.corrupt.crc32.json", "summary.json"]
    assert not (d / "latest.ckpt.crc32.json").exists()
    # The next save, after a resume through the fallback, repoints both links.
    logs = []
    train(TS_TEST_CONFIG, TrainHParams(), LoopConfig(**loop, checkpoint_dir=str(d)), data,
          resume_from=d, log_fn=logs.append, device="cpu")
    assert logs[0] == f"resumed from {d / 'step_00000002.ckpt'} at iteration 2", logs
    assert os.readlink(d / "latest.ckpt") == "step_00000004.ckpt"
    assert os.readlink(d / "latest.ckpt.crc32.json") == "step_00000004.ckpt.crc32.json"
    assert integrity.verify_checkpoint(d / "latest.ckpt").ok
    assert jax_integrity.verify_checkpoint(d / "latest.ckpt").ok
    for fallback in (jax_fallback, load_checkpoint_with_fallback):
        payload, used = fallback(d / "latest.ckpt")
        assert (used.name, payload["iteration"]) == ("latest.ckpt", 4)


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


def _same_flat(got: dict, want: dict, what: str) -> None:
    """Flat health/dynamics records: the same keys in the same order, values
    within 1e-5 relative (attention entropy within 1e-4), paths equal."""
    assert list(got) == list(want), (what, list(got), list(want))
    for key, w in want.items():
        g = got[key]
        if isinstance(w, str):
            assert g == w, (what, key, g, w)
        elif key.startswith("attn_entropy/"):
            _close(g, w, 1e-4, f"{what} {key}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, equal_nan=True,
                                       err_msg=f"{what} {key}")


def _taps_and_scan():
    """(g) The training taps and the scanned step against the JAX package's:
    ``health_metrics``/``flatten_health`` and ``dynamics_metrics``/
    ``flatten_dynamics`` on the same trees (one param layer seeded with a
    NaN: the same ``first_nonfinite``), then ``health=True, dynamics=True``
    steps in the plain, grad-accum and scanned (n 4) variants, over the
    attention kernels and remat policies that move the entropy tap: the
    flat records, loss, grad norm and every parameter after the call within
    1e-5 (attention entropy 1e-4)."""
    from bpe_transformer_tpu.telemetry import dynamics as jax_dynamics
    from bpe_transformer_tpu.telemetry import health as jax_health
    from bpe_transformer_tpu.training.train_step import (
        make_grad_accum_train_step as jax_make_accum_step,
    )
    from bpe_transformer_tpu.training.train_step import (
        make_scanned_train_step as jax_make_scanned_step,
    )
    from bpe_transformer_tpu_torch.telemetry import dynamics, health
    from bpe_transformer_tpu_torch.training.loop import _fetch
    from bpe_transformer_tpu_torch.training.train_step import make_scanned_train_step

    base = ModelConfig(vocab_size=97, context_length=32, d_model=64, num_layers=2, num_heads=4,
                       d_ff=96)
    rng = np.random.default_rng(21)
    host = jax.device_get(jax_init_params(jax.random.PRNGKey(6), _jax_config(base)))
    grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                   host)
    after = jax.tree_util.tree_map(lambda a: a * np.float32(0.99) + np.float32(1e-3), host)
    before = jax.tree_util.tree_map(np.copy, host)
    before["layers"][1]["ffn"]["w2"][3, 5] = np.nan
    t = lambda tree: params_from_jax(tree, device="cpu")  # noqa: E731
    _same_flat(health.flatten_health(_fetch(health.health_metrics(torch.tensor(2.5), t(grads),
                                                                  t(after)))),
               jax_health.flatten_health(jax.device_get(jax_health.health_metrics(
                   jnp.float32(2.5), grads, after))), "health_metrics")
    got = dynamics.flatten_dynamics(_fetch(dynamics.dynamics_metrics(t(grads), t(before),
                                                                     t(after))))
    want = jax_dynamics.flatten_dynamics(jax.device_get(jax_dynamics.dynamics_metrics(
        grads, before, after)))
    _same_flat(got, want, "dynamics_metrics")
    assert got["first_nonfinite"] == "params/layers.1.ffn.w2", got["first_nonfinite"]

    xs, ys = rng.integers(0, base.vocab_size, size=(2, 4, 4, 32))
    hp = dict(warmup_iters=0, cosine_cycle_iters=10)
    variants = [
        ("plain", dict(), None),
        ("plain", dict(loss_chunk_size=8, **KERNEL_KNOBS), None),
        ("plain", dict(remat_policy="save_attn", **FUSED_KNOBS), None),
        ("plain", dict(remat_policy="dots_saveable", num_kv_heads=2), None),
        ("accum", dict(**KERNEL_KNOBS), 2),
        ("scanned", dict(remat_policy="full", **KERNEL_KNOBS), 4),
    ]
    for kind, knobs, n in variants:
        cfg = dataclasses.replace(base, **knobs)
        jcfg = _jax_config(cfg)
        jax_params = jax.tree_util.tree_map(jnp.asarray, host) if "num_kv_heads" not in knobs \
            else jax_init_params(jax.random.PRNGKey(6), jcfg)
        start = jax.device_get(jax_params)
        x, y = xs[0], ys[0]
        if kind == "plain":
            j_step = jax_make_train_step(jcfg, JaxTrainHParams(**hp), health=True, dynamics=True)
            step = make_train_step(cfg, TrainHParams(**hp), health=True, dynamics=True)
        elif kind == "accum":
            x, y = x.reshape(n, -1, 32), y.reshape(n, -1, 32)
            j_step = jax_make_accum_step(jcfg, JaxTrainHParams(**hp), n, health=True,
                                         dynamics=True)
            step = make_grad_accum_train_step(cfg, TrainHParams(**hp), n, health=True,
                                              dynamics=True)
        else:
            x, y = xs, ys
            j_step = jax_make_scanned_step(jcfg, JaxTrainHParams(**hp), n, health=True,
                                           dynamics=True)
            step = make_scanned_train_step(cfg, TrainHParams(**hp), n, health=True,
                                           dynamics=True)
        j_params, _, j_m = j_step(jax_params, jax_adamw_init(jax_params), jnp.asarray(x),
                                  jnp.asarray(y))
        j_m = jax.device_get(j_m)
        params = params_from_jax(start, device="cpu")
        params, _, m = step(params, adamw_init(params), torch.as_tensor(x), torch.as_tensor(y))
        m = _fetch(m)
        what = f"{kind} {knobs}"
        _close(m["loss"], float(j_m["loss"]), 1e-5, f"loss {what}")
        _close(m["grad_norm"], float(j_m["grad_norm"]), 1e-5, f"grad norm {what}")
        _same_flat(health.flatten_health(m["health"]),
                   jax_health.flatten_health(j_m["health"]), f"health {what}")
        flat = dynamics.flatten_dynamics(m["dynamics"])
        _same_flat(flat, jax_dynamics.flatten_dynamics(j_m["dynamics"]), f"dynamics {what}")
        assert any(k.startswith("attn_entropy/") for k in flat) == (kind != "accum"), what
        for got_leaf, want in zip(tree_leaves(params),
                                  tree_leaves(jax.tree_util.tree_map(np.asarray, j_params)),
                                  strict=True):
            _close(got_leaf.detach(), want, 1e-5, f"params {what}")

    # A NaN in the input params: the same localization.
    bad = jax.tree_util.tree_map(np.copy, host)
    bad["layers"][0]["ffn"]["w1"][0, 0] = np.nan
    j_step = jax_make_train_step(_jax_config(base), JaxTrainHParams(**hp), dynamics=True)
    _, _, j_m = j_step(jax.tree_util.tree_map(jnp.asarray, bad),
                       jax_adamw_init(jax.tree_util.tree_map(jnp.asarray, bad)),
                       jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    params = params_from_jax(bad, device="cpu")
    _, _, m = make_train_step(base, TrainHParams(**hp), dynamics=True)(
        params, adamw_init(params), torch.as_tensor(xs[0]), torch.as_tensor(ys[0]))
    got = dynamics.flatten_dynamics(_fetch(m)["dynamics"])
    want = jax_dynamics.flatten_dynamics(jax.device_get(j_m["dynamics"]))
    _same_flat(got, want, "dynamics on NaN params")
    assert got["first_nonfinite"] == "params/layers.0.ffn.w1", got["first_nonfinite"]


def _read_jsonl(path) -> list[dict]:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _kind_keys(records: list[dict]) -> dict:
    """Record kind (events and spans by name) -> the union of their keys."""
    kinds: dict = {}
    for r in records:
        kind = r.get("kind") or ("step" if "loss" in r else "val")
        if kind in ("event", "span"):
            kind = f"{kind}:{r['name']}"
        kinds.setdefault(kind, set()).update(r)
    return kinds


#: The tiny loop model and its byte-level token file (this file's bytes).
LOOP_CFG = ModelConfig(vocab_size=256, context_length=32, d_model=64, num_layers=2, num_heads=4,
                       d_ff=128)


def _byte_tokens() -> np.ndarray:
    return np.frombuffer(Path(__file__).read_bytes(), np.uint8).astype(np.uint16)


def _loop_telemetry_and_faults(tmp_path):
    """(h) The loop's telemetry and resilience against the JAX loop, both
    resumed from one JAX-written step-0 checkpoint on a byte-level token
    file: the stream with every tap (the same record kinds and, per kind,
    the same keys, manifest aside; losses within 1e-4); one ``nan_at_step``
    plan under the rollback, skip and raise policies and the rollback
    breaker (the same events, steps, paths and errors, final losses within
    1e-4, so the same salted batches); the config errors; retention and the
    ``latest.ckpt`` symlink read by both packages' ``gc_checkpoints`` and
    ``load_checkpoint_with_fallback``; then the port alone: prefetch 0 and
    2, inner steps 4 and 1 (with a 2-step tail), async and sync checkpoints
    give the same batches, losses and saved state."""
    from bpe_transformer_tpu.resilience.faults import FaultInjector as JaxInjector
    from bpe_transformer_tpu.resilience.faults import FaultPlan as JaxPlan
    from bpe_transformer_tpu.resilience.retention import gc_checkpoints as jax_gc
    from bpe_transformer_tpu.telemetry.watchdog import NonFiniteError as JaxNonFiniteError
    from bpe_transformer_tpu_torch.data import BatchPrefetcher, get_batch
    from bpe_transformer_tpu_torch.resilience.faults import FaultInjector, FaultPlan
    from bpe_transformer_tpu_torch.resilience.retention import gc_checkpoints
    from bpe_transformer_tpu_torch.telemetry.watchdog import NonFiniteError

    cfg, jcfg, data = LOOP_CFG, _jax_config(LOOP_CFG), _byte_tokens()
    jax_params = jax_init_params(jax.random.PRNGKey(9), jcfg)
    init = tmp_path / "init.ckpt"
    jax_save_checkpoint(init, params=jax_params, opt_state=jax_adamw_init(jax_params), iteration=0)
    hp = dict(warmup_iters=2, cosine_cycle_iters=40)
    quiet = lambda *a: None  # noqa: E731

    def run_both(tag, plan=None, **kw):
        out = {}
        for pkg in ("jax", "port"):
            d = tmp_path / f"{tag}_{pkg}"
            lp = dict(steps=12, batch_size=4, log_every=2, eval_every=1000, checkpoint_every=4,
                      checkpoint_dir=str(d / "ck"), metrics_jsonl=str(d / "m.jsonl"), seed=5)
            lp.update(kw)
            if pkg == "jax":
                call = lambda: jax_train(  # noqa: E731
                    jcfg, JaxTrainHParams(**hp), JaxLoopConfig(**lp), data, resume_from=init,
                    log_fn=quiet, fault_injector=JaxInjector(JaxPlan(**(plan or {}))))
            else:
                call = lambda: train(  # noqa: E731
                    cfg, TrainHParams(**hp), LoopConfig(**lp), data, resume_from=init,
                    log_fn=quiet, device="cpu",
                    fault_injector=FaultInjector(FaultPlan(**(plan or {}))))
            try:
                result = call()
            except (NonFiniteError, JaxNonFiniteError) as exc:
                result = f"NonFiniteError: {exc}"
            out[pkg] = (result, _read_jsonl(d / "m.jsonl"), d / "ck")
        return out

    def steps_of(records):
        return [(r["step"], r["loss"]) for r in records if r.get("kind") is None and "loss" in r]

    def tap_records(records):
        """Per step and dynamics record, its health and dynamics values."""
        return [{k: v for k, v in r.items() if "/" in k or k.startswith("nonfinite")}
                for r in records if r.get("kind") == "dynamics"
                or (r.get("kind") is None and "loss" in r)]

    def events(records):
        return [(r.get("kind"), r.get("name"), r.get("step"), r.get("restored_step"),
                 r.get("lost_steps"), r.get("fields"), r.get("policy"),
                 r.get("path") or r.get("nonfinite_path"))
                for r in records if r.get("kind") in ("event", "recovery", "preemption")]

    cases = [
        ("stream", None, dict(health_stats=True, dynamics_every=4, watchdog=True,
                              keep_checkpoints=2, eval_every=4, eval_batches=2)),
        ("rollback", dict(nan_at_step=5), dict(dynamics_every=2, health_stats=True,
                                                watchdog=True, watchdog_policy="rollback")),
        ("skip", dict(nan_at_step=5), dict(dynamics_every=2, watchdog=True,
                                           watchdog_policy="skip")),
        ("raise", dict(nan_at_step=5), dict(health_stats=True, watchdog=True)),
        ("breaker", dict(nan_at_step=5), dict(watchdog=True, watchdog_policy="rollback",
                                              max_rollbacks=0)),
    ]
    port_dirs = {}
    for tag, plan, kw in cases:
        val = dict(val_data=data) if "eval_every" in kw else {}
        if val:  # both loops evaluate on the same token file
            out = {}
            for pkg, fn in (("jax", jax_train), ("port", train)):
                d = tmp_path / f"{tag}_{pkg}"
                lp = dict(steps=12, batch_size=4, log_every=2, checkpoint_every=4,
                          checkpoint_dir=str(d / "ck"), metrics_jsonl=str(d / "m.jsonl"),
                          seed=5, **kw)
                extra = {} if pkg == "jax" else {"device": "cpu"}
                out[pkg] = (fn(jcfg if pkg == "jax" else cfg,
                               (JaxTrainHParams if pkg == "jax" else TrainHParams)(**hp),
                               (JaxLoopConfig if pkg == "jax" else LoopConfig)(**lp), data,
                               data, resume_from=init, log_fn=quiet, **extra),
                            _read_jsonl(d / "m.jsonl"), d / "ck")
        else:
            out = run_both(tag, plan, **kw)
        (want, want_recs, _), (got, got_recs, port_dirs[tag]) = out["jax"], out["port"]
        want_kinds, got_kinds = _kind_keys(want_recs), _kind_keys(got_recs)
        assert set(got_kinds) == set(want_kinds), (tag, set(got_kinds) ^ set(want_kinds))
        for kind in want_kinds.keys() - {"manifest"}:
            assert got_kinds[kind] == want_kinds[kind], (tag, kind,
                                                         got_kinds[kind] ^ want_kinds[kind])
        assert events(got_recs) == events(want_recs), (tag, events(got_recs))
        g_steps, w_steps = steps_of(got_recs), steps_of(want_recs)
        assert [s for s, _ in g_steps] == [s for s, _ in w_steps], tag
        np.testing.assert_allclose([v for _, v in g_steps], [v for _, v in w_steps], rtol=0,
                                   atol=1e-4, equal_nan=True, err_msg=tag)
        if tag == "stream":
            # The taps' values too: the port taps only the updates that end
            # on a log boundary, the JAX step every update.
            for got_r, want_r in zip(tap_records(got_recs), tap_records(want_recs),
                                     strict=True):
                assert got_r.keys() == want_r.keys(), (got_r.keys() ^ want_r.keys())
                for key, want_v in want_r.items():
                    _close(got_r[key], want_v, 1e-4, f"{tag} {key}")
        if isinstance(want, str):
            assert got == want, (tag, got, want)
        else:
            np.testing.assert_allclose(got["final_train_loss"], want["final_train_loss"],
                                       atol=1e-4, equal_nan=True, err_msg=tag)
            assert got.get("rollbacks") == want.get("rollbacks"), tag
    assert events(got_recs)[-1][1] == "recovery_abort"

    # Retention and the symlinked latest.ckpt, read by both packages.
    ck = port_dirs["stream"]
    assert (ck / "latest.ckpt").is_symlink()
    assert sorted(p.name for p in ck.glob("step_*.ckpt")) == ["step_00000008.ckpt",
                                                             "step_00000012.ckpt"]
    assert os.readlink(ck / "latest.ckpt") == "step_00000012.ckpt"
    for name, gc_fn, fallback in (("jax", jax_gc, jax_fallback),
                                  ("port", gc_checkpoints, load_checkpoint_with_fallback)):
        d = tmp_path / f"latest_{name}"
        shutil.copytree(ck, d, symlinks=True)
        assert [p.name for p in gc_fn(d, 1)] == ["step_00000008.ckpt"], name
        payload, used = fallback(d / "latest.ckpt")
        assert used.name == "latest.ckpt" and payload["iteration"] == 12, name
        assert sorted(p.name for p in d.iterdir()) == [
            "latest.ckpt", "latest.ckpt.crc32.json", "step_00000012.ckpt",
            "step_00000012.ckpt.crc32.json", "summary.json"], name
    # One seeded directory (an old latest target, a quarantined snapshot,
    # stale crash debris): both packages' GC remove the same files.
    seeded = tmp_path / "seeded"
    for step in (2, 4, 6, 8):
        save_checkpoint(seeded / f"step_{step:08d}.ckpt", params={"w": torch.ones(2)},
                        iteration=step)
    (seeded / "latest.ckpt").symlink_to("step_00000004.ckpt")
    integrity.quarantine(seeded / "step_00000002.ckpt")
    debris = seeded / "step_00000004.ckpt.tmpXYZ"
    debris.write_bytes(b"partial")
    os.utime(debris, (1e9, 1e9))
    listings = []
    for name, gc_fn in (("jax", jax_gc), ("port", gc_checkpoints)):
        d = tmp_path / f"seeded_{name}"
        shutil.copytree(seeded, d, symlinks=True)
        removed = sorted(p.name for p in gc_fn(d, 1))
        listings.append((removed, sorted(p.name for p in d.iterdir())))
    assert listings[0] == listings[1], listings
    assert "step_00000004.ckpt.tmpXYZ" in listings[0][0]

    # The config errors of the JAX loop, then what other slices hold.
    base = dict(steps=4, batch_size=4, log_every=2)
    for kw in (dict(dynamics_every=-1), dict(dynamics_every=3), dict(attribution_every=-1),
               dict(attribution_every=3), dict(prefetch=-1),
               dict(watchdog=True, watchdog_policy="bogus"),
               dict(watchdog=True, watchdog_policy="rollback"),
               dict(watchdog=True, watchdog_policy="rollback", checkpoint_dir=str(tmp_path),
                    checkpoint_every=3),
               dict(inner_steps=4), dict(inner_steps=2, grad_accum_steps=2),
               dict(grad_accum_steps=3)):
        messages = []
        for fn, loop_cls, c, extra in ((jax_train, JaxLoopConfig, jcfg, {}),
                                       (train, LoopConfig, cfg, {"device": "cpu"})):
            with pytest.raises(ValueError) as exc:
                fn(c, TrainHParams() if fn is train else JaxTrainHParams(),
                   loop_cls(**{**base, **kw}), data, log_fn=quiet, **extra)
            messages.append(str(exc.value).split(" — ")[0])
        assert messages[0] == messages[1], (kw, messages)
    for kw in (dict(parallel="dp"), dict(opt_sharding="zero1"),
               dict(mesh_axes={"data": 1}), dict(sp_zigzag=True), dict(sp_ulysses=True)):
        with pytest.raises(NotImplementedError, match="slice 1"):
            train(cfg, TrainHParams(), LoopConfig(**{**base, **kw}), data, device="cpu")

    # The port alone: prefetch, inner steps, async checkpoints.
    made = lambda it: get_batch(data, 4, 32, np.random.default_rng((5, it)))  # noqa: E731
    fetcher = BatchPrefetcher(made, depth=2)
    for it in range(6):
        for ahead in (1, 2):
            fetcher.schedule(it + ahead)
        for got_arr, want_arr in zip(fetcher.get(it), made(it)):
            assert np.array_equal(got_arr, want_arr), it
    fetcher.close()
    runs = {}
    for tag, kw in (("sync", dict(prefetch=0)), ("prefetch", dict(prefetch=2)),
                    ("async", dict(prefetch=2, async_checkpoint=True)),
                    ("inner1", dict(steps=10, log_every=4, checkpoint_every=4)),
                    ("inner4", dict(steps=10, log_every=4, checkpoint_every=4, inner_steps=4))):
        d = tmp_path / f"feed_{tag}"
        runs[tag] = (train(cfg, TrainHParams(**hp),
                           LoopConfig(**{**dict(steps=12, batch_size=4, log_every=2,
                                                checkpoint_every=4, checkpoint_dir=str(d),
                                                seed=5), **kw}),
                           data, resume_from=init, log_fn=quiet, device="cpu"), d)
    losses = {tag: [r["loss"] for r in run["history"]] for tag, (run, _) in runs.items()}
    assert losses["prefetch"] == losses["sync"] == losses["async"], losses
    assert [r["step"] for r in runs["inner4"][0]["history"]] == [4, 8, 10]
    np.testing.assert_allclose(losses["inner4"], losses["inner1"], rtol=1e-5)
    for step in (4, 8, 12):
        a = load_checkpoint(runs["async"][1] / f"step_{step:08d}.ckpt")
        b = load_checkpoint(runs["sync"][1] / f"step_{step:08d}.ckpt")
        for x, y in zip(tree_leaves(a["params"]) + tree_leaves(a["opt_state"]),
                        tree_leaves(b["params"]) + tree_leaves(b["opt_state"]), strict=True):
            assert np.array_equal(np.asarray(x), np.asarray(y)), step


def _preemption_and_supervisor(tmp_path):
    """(i) The port's ``train`` CLI on the CPU in subprocesses (each under a
    timeout): ``BT_FAULTS`` ``preempt_at_step`` 6 exits 75 with an
    emergency snapshot at step 6, and ``--resume`` finishes with the losses
    of an uninterrupted run; a NaN before the signal skips the emergency
    save (the clean step-4 snapshot stays the resume target); ``--supervise``
    respawns a child killed at step 6 and the run finishes with the same
    losses."""
    import subprocess
    import sys

    data = tmp_path / "tokens.bin"
    _byte_tokens().tofile(data)
    LOOP_CFG.to_json(tmp_path / "model.json")
    common = ["--data", str(data), "--model-config", str(tmp_path / "model.json"), "--steps",
              "12", "--batch-size", "4", "--log-every", "2", "--eval-every", "1000",
              "--checkpoint-every", "4", "--warmup", "2", "--device", "cpu"]

    def cli(*argv, faults=None):
        env = {**os.environ, "BT_FAULTS": json.dumps(faults)} if faults else None
        return subprocess.run(
            [sys.executable, "-m", "bpe_transformer_tpu_torch.training.cli", "train", *common,
             *argv], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)

    ck = tmp_path / "ck"
    proc = cli("--checkpoint-dir", str(ck), "--metrics-jsonl", str(tmp_path / "m.jsonl"),
               faults={"preempt_at_step": 6})
    assert proc.returncode == 75, proc.stderr[-3000:]
    pre = [r for r in _read_jsonl(tmp_path / "m.jsonl") if r.get("kind") == "preemption"]
    assert [(r["step"], Path(r["checkpoint"]).name) for r in pre] == [(6, "step_00000006.ckpt")]
    assert os.readlink(ck / "latest.ckpt") == "step_00000006.ckpt"
    assert integrity.verify_checkpoint(ck / "latest.ckpt").ok
    proc = cli("--checkpoint-dir", str(ck), "--resume", str(ck))
    assert proc.returncode == 0, proc.stderr[-3000:]
    resumed = json.loads((ck / "summary.json").read_text())["history"]
    want = train(LOOP_CFG, TrainHParams(max_learning_rate=3e-4, min_learning_rate=3e-5,
                                        warmup_iters=2, cosine_cycle_iters=12),
                 LoopConfig(steps=12, batch_size=4, log_every=2, eval_every=1000),
                 np.fromfile(data, np.uint16), log_fn=lambda *a: None, device="cpu")["history"]
    assert [r["step"] for r in resumed] == [8, 10, 12]
    np.testing.assert_allclose([r["loss"] for r in resumed], [r["loss"] for r in want[3:]],
                               rtol=1e-6)

    ck = tmp_path / "ck_nan"
    proc = cli("--checkpoint-dir", str(ck), "--log-every", "1000", "--metrics-jsonl",
               str(tmp_path / "nan.jsonl"), faults={"nan_at_step": 5, "preempt_at_step": 6})
    assert proc.returncode == 75, proc.stderr[-3000:]
    pre = [r for r in _read_jsonl(tmp_path / "nan.jsonl") if r.get("kind") == "preemption"]
    assert pre[0]["checkpoint"] is None and pre[0]["skipped_nonfinite_state"] is True
    assert load_checkpoint(ck / "latest.ckpt")["iteration"] == 4

    ck, once = tmp_path / "ck_sup", tmp_path / "once"
    proc = cli("--checkpoint-dir", str(ck), "--supervise", "--max-restarts", "2",
               "--restart-backoff", "0.1", faults={"kill_at_step": 6, "once_dir": str(once)})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert (once / "kill.fired").exists() and "spawn #2" in proc.stdout
    history = json.loads((ck / "summary.json").read_text())["history"]
    assert [r["step"] for r in history] == [6, 8, 10, 12]
    np.testing.assert_allclose([r["loss"] for r in history], [r["loss"] for r in want[2:]],
                               rtol=1e-6)


#: The MoE test model: tests/test_moe.py's ``MOE_CFG`` (4 experts, capacity
#: factor 2) at two layers.
MOE_CFG = dataclasses.replace(TS_TEST_CONFIG, vocab_size=512, num_layers=2, ffn_type="moe",
                              n_experts=4, capacity_factor=2.0)


def _jax_routing(tokens, router, top_k, cap):
    """The JAX package's routing of ``tokens (n, d)``, written out: each
    token's ``top_k`` experts by ``jax.lax.top_k`` of the float32 router
    softmax, rank-major (row ``r * n + t``), and whether the assignment is
    under capacity when every first choice queues before any second."""
    probs = jax.nn.softmax(jnp.asarray(tokens, jnp.float32) @ jnp.asarray(router, jnp.float32).T)
    expert = np.asarray(jax.lax.top_k(probs, top_k)[1]).T.reshape(-1)
    taken, kept = {}, []
    for e in expert:
        kept.append(taken.get(int(e), 0) < cap)
        taken[int(e)] = taken.get(int(e), 0) + 1
    return expert, np.array(kept)


def _moe():
    """(j) The MoE FFN and its training paths against the JAX package's.

    ``switch_ffn`` at top-1 and top-2, einsum and gather, capacity factors
    of 2 a choice (no drop here) and 0.5 (drops), float32 and bfloat16:
    the routing (each assignment's expert, and whether it is kept) exactly
    JAX's; output and aux within 1e-5 (bfloat16: within 2% of the largest
    output, about four bf16 ulps there: XLA rounds the fused SiLU gate once
    where PyTorch rounds each op, and a top-2 output sums two such terms);
    the input and weight gradients of ``sum(out * g) + aux`` within 1e-5
    plus 1e-5 relative of ``jax.grad`` (router gradients reach 14).

    ``make_train_step`` with health and dynamics (remat ``none``) and the
    scanned step (n 2, remat ``full``, the flash kernels, the einsum
    dispatch): loss, grad norm, the flat health (``moe_aux`` among them)
    and dynamics records and every parameter after the call within 2e-5.

    The sp step on a stacked ring of four: without drops and with the aux
    weight 0 against JAX's over ``{"data": 2, "seq": 4}`` (as
    tests/test_moe.py holds it against the dense step), and with drops and
    the aux loss on against JAX's over ``{"data": 1, "seq": 4}``, whose
    shards route the same token groups as the ring's ranks (a data axis of
    2 would halve each group), all within 1e-4 (matrices at 8 times the
    init scale, so the logits and the routing are of order 1).  The dense
    step on that batch, which routes all ranks as one group, must then
    differ in loss or grad norm by more than that."""
    from bpe_transformer_tpu.models.moe import init_moe_params as jax_init_moe
    from bpe_transformer_tpu.models.moe import switch_ffn as jax_switch_ffn
    from bpe_transformer_tpu.telemetry import dynamics as jax_dynamics
    from bpe_transformer_tpu.telemetry import health as jax_health
    from bpe_transformer_tpu.training.train_step import (
        make_scanned_train_step as jax_make_scanned_step,
    )
    from bpe_transformer_tpu_torch.models.moe import expert_capacity, route, switch_ffn
    from bpe_transformer_tpu_torch.telemetry import dynamics, health
    from bpe_transformer_tpu_torch.training.loop import _fetch
    from bpe_transformer_tpu_torch.training.train_step import make_scanned_train_step

    rng = np.random.default_rng(31)
    x = rng.normal(size=(4, 8, MOE_CFG.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    for top_k in (1, 2):
        # Weights at 8 times the init scale: outputs of order 1, soft routing.
        host = jax.device_get(jax.tree_util.tree_map(
            lambda a: a * 8, jax_init_moe(jax.random.PRNGKey(top_k), _jax_config(MOE_CFG))))
        for dispatch in ("einsum", "gather"):
            for factor in (2.0 * top_k, 0.5):
                cfg = dataclasses.replace(MOE_CFG, router_top_k=top_k, moe_dispatch=dispatch,
                                          capacity_factor=factor)
                jcfg = _jax_config(cfg)
                what = f"switch_ffn top-{top_k} {dispatch} factor {factor}"
                cap = expert_capacity(32, 4, factor)
                jax_ffn = jax.jit(lambda xj, p, jcfg=jcfg: jax_switch_ffn(xj, p, jcfg))
                for dtype in ("float32", "bfloat16"):
                    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
                    xj = jnp.asarray(x).astype(jdt)
                    want, want_aux = jax_ffn(
                        xj, jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), host))
                    params = {k: v.to(tdt) for k, v in params_from_jax(host, "cpu").items()}
                    xt = torch.as_tensor(np.array(xj.astype(jnp.float32))).to(tdt)
                    r = route(xt.reshape(1, 32, -1), params["router"], top_k, cap)
                    expert, kept = _jax_routing(np.asarray(xj.astype(jnp.float32)).reshape(32, -1),
                                                np.asarray(host["router"]).astype(jdt), top_k, cap)
                    assert np.array_equal(r["expert"][0].numpy(), expert), (what, dtype)
                    assert np.array_equal(r["kept"][0].numpy(), kept), (what, dtype)
                    assert kept.all() == (factor > 1), (what, kept)
                    out, aux = switch_ffn(xt, params, cfg)
                    want = np.asarray(want.astype(jnp.float32))
                    if dtype == "float32":
                        _close(out, want, 1e-5, f"{what} {dtype}")
                    else:
                        err = np.abs(out.float().numpy() - want).max()
                        assert err <= 2e-2 * np.abs(want).max(), (what, dtype, err)
                    _close(float(aux), float(want_aux), 1e-5, f"{what} {dtype} aux")

                def jax_objective(p, xj):
                    out, aux = jax_switch_ffn(xj, p, jcfg)
                    return jnp.sum(out * g) + aux

                want_gx, want_gp = jax.jit(jax.grad(jax_objective, argnums=(1, 0)))(
                    jax.tree_util.tree_map(jnp.asarray, host), jnp.asarray(x))
                params = params_from_jax(host, "cpu")
                xt = torch.as_tensor(x).requires_grad_(True)
                leaves = [params[k].requires_grad_(True) for k in sorted(params)]
                out, aux = switch_ffn(xt, params, cfg)
                grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)) + aux,
                                            [xt] + leaves)
                for name, got, want in zip(["x"] + sorted(params), grads,
                                           [want_gx] + [want_gp[k] for k in sorted(params)]):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                               atol=1e-5, err_msg=f"{what} {name} grad")

    # The train step with every tap, and the scanned step.
    xs, ys = rng.integers(0, MOE_CFG.vocab_size, size=(2, 2, 4, MOE_CFG.context_length))
    hp = dict(warmup_iters=0, cosine_cycle_iters=10)
    base = dataclasses.replace(MOE_CFG, router_top_k=2, moe_dispatch="gather",
                               capacity_factor=1.0)
    host = jax.device_get(jax_init_params(jax.random.PRNGKey(8), _jax_config(base)))
    for kind, knobs in (("plain", dict()),
                        ("scanned", dict(remat_policy="full", moe_dispatch="einsum",
                                         **KERNEL_KNOBS))):
        cfg = dataclasses.replace(base, **knobs)
        jcfg = _jax_config(cfg)
        x, y = (xs[0], ys[0]) if kind == "plain" else (xs, ys)
        if kind == "plain":
            j_step = jax_make_train_step(jcfg, JaxTrainHParams(**hp), health=True, dynamics=True)
            step = make_train_step(cfg, TrainHParams(**hp), health=True, dynamics=True)
        else:
            j_step = jax_make_scanned_step(jcfg, JaxTrainHParams(**hp), 2, health=True,
                                           dynamics=True)
            step = make_scanned_train_step(cfg, TrainHParams(**hp), 2, health=True,
                                           dynamics=True)
        jax_params = jax.tree_util.tree_map(jnp.asarray, host)
        j_params, _, j_m = j_step(jax_params, jax_adamw_init(jax_params), jnp.asarray(x),
                                  jnp.asarray(y))
        j_m = jax.device_get(j_m)
        params = params_from_jax(host, device="cpu")
        params, _, m = step(params, adamw_init(params), torch.as_tensor(x), torch.as_tensor(y))
        m = _fetch(m)
        what = f"moe {kind} {knobs}"
        _close(m["loss"], float(j_m["loss"]), 2e-5, f"loss {what}")
        _close(m["grad_norm"], float(j_m["grad_norm"]), 2e-5, f"grad norm {what}")
        flat = health.flatten_health(m["health"])
        assert "moe_aux" in flat and np.isfinite(flat["moe_aux"]), what
        _close(flat["moe_aux"], float(j_m["health"]["moe_aux"]), 2e-5, f"moe_aux {what}")
        _same_flat(flat, jax_health.flatten_health(j_m["health"]), f"health {what}")
        _same_flat(dynamics.flatten_dynamics(m["dynamics"]),
                   jax_dynamics.flatten_dynamics(j_m["dynamics"]), f"dynamics {what}")
        for got_leaf, want in zip(tree_leaves(params),
                                  tree_leaves(jax.tree_util.tree_map(np.asarray, j_params)),
                                  strict=True):
            _close(got_leaf.detach(), want, 2e-5, f"params {what}")

    # The sp step: per-rank routing on the stacked ring.
    ring = StackedRing(4)
    x, y = (rng.integers(0, MOE_CFG.vocab_size, size=(4, MOE_CFG.context_length))
            for _ in range(2))
    devices = jax.devices()
    for name, knobs, axes in (
        ("no drops, aux 0", dict(capacity_factor=16.0, router_aux_weight=0.0),
         {"data": 2, "seq": 4}),
        ("drops, aux on", dict(capacity_factor=0.5, router_top_k=2, moe_dispatch="gather"),
         {"data": 1, "seq": 4}),
    ):
        cfg = dataclasses.replace(MOE_CFG, attention_impl="flash", **knobs)
        jcfg = _jax_config(cfg)
        # Matrices at 8 times the init scale: logits of order 1, soft routing.
        host = jax.device_get(jax.tree_util.tree_map(
            lambda a: a * 8 if a.ndim >= 2 else a, jax_init_params(jax.random.PRNGKey(10), jcfg)))
        mesh = make_mesh(axes, devices=devices[: axes["data"] * axes["seq"]])
        jax_params = jax.tree_util.tree_map(jnp.asarray, host)
        jx, jy = jax_shard_sp_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
        j_params, _, j_m = jax_make_sp_train_step(jcfg, JaxTrainHParams(**hp), mesh)(
            jax_params, jax_adamw_init(jax_params), jx, jy)
        params = params_from_jax(host, device="cpu")
        tx, ty = shard_sp_batch((x, y), ring, device="cpu")
        p1, _, m = make_sp_train_step(cfg, TrainHParams(**hp), ring)(params, adamw_init(params),
                                                                    tx, ty)
        what = f"moe sp step, {name}"
        _close(float(m["loss"]), float(j_m["loss"]), 1e-4, f"loss {what}")
        _close(float(m["grad_norm"]), float(j_m["grad_norm"]), 1e-4, f"grad norm {what}")
        for got, want in zip(tree_leaves(p1),
                             tree_leaves(jax.tree_util.tree_map(np.asarray, j_params)),
                             strict=True):
            _close(got.detach(), want, 1e-4, f"params {what}")
        params = params_from_jax(host, device="cpu")
        _, _, d_m = make_train_step(cfg, TrainHParams(**hp))(
            params, adamw_init(params), torch.as_tensor(x), torch.as_tensor(y))
        gap = max(abs(float(d_m["loss"]) - float(m["loss"])),
                  abs(float(d_m["grad_norm"]) - float(m["grad_norm"])))
        assert (gap < 1e-4) == (name == "no drops, aux 0"), (what, gap)


def _moe_loop(tmp_path):
    """(k) The JAX ``train()`` and the port's on the MoE model, both resumed
    from one JAX-written step-0 checkpoint, with health stats on: the same
    step records, ``moe_aux`` among them (losses and ``moe_aux`` within
    1e-4), and the port's MoE checkpoint verifies in both packages and
    resumes in the port."""
    cfg = dataclasses.replace(MOE_CFG, router_top_k=2, moe_dispatch="gather", capacity_factor=1.0)
    jcfg = _jax_config(cfg)
    data = np.random.default_rng(13).integers(0, cfg.vocab_size, 4000).astype(np.uint16)
    jax_params = jax_init_params(jax.random.PRNGKey(12), jcfg)
    init = tmp_path / "moe_init.ckpt"
    jax_save_checkpoint(init, params=jax_params, opt_state=jax_adamw_init(jax_params), iteration=0)
    hp = dict(warmup_iters=1, cosine_cycle_iters=4, max_learning_rate=1e-2)
    records = {}
    for pkg in ("jax", "port"):
        d = tmp_path / f"moe_{pkg}"
        lp = dict(steps=2, batch_size=4, log_every=1, eval_every=1000, checkpoint_every=2,
                  checkpoint_dir=str(d / "ck"), metrics_jsonl=str(d / "m.jsonl"), seed=4,
                  health_stats=True)
        if pkg == "jax":
            jax_train(jcfg, JaxTrainHParams(**hp), JaxLoopConfig(**lp), data, resume_from=init,
                      log_fn=lambda *a: None)
        else:
            train(cfg, TrainHParams(**hp), LoopConfig(**lp), data, resume_from=init,
                  log_fn=lambda *a: None, device="cpu")
        records[pkg] = [r for r in _read_jsonl(d / "m.jsonl")
                        if r.get("kind") is None and "loss" in r]
    assert [r["step"] for r in records["port"]] == [r["step"] for r in records["jax"]] == [1, 2]
    for got, want in zip(records["port"], records["jax"], strict=True):
        assert got.keys() == want.keys(), got.keys() ^ want.keys()
        _close([got["loss"], got["moe_aux"]], [want["loss"], want["moe_aux"]], 1e-4,
               f"moe loop step {want['step']}")
    ck = tmp_path / "moe_port" / "ck" / "latest.ckpt"
    assert integrity.verify_checkpoint(ck).ok and jax_integrity.verify_checkpoint(ck).ok
    payload = load_checkpoint(ck)
    assert payload["params"]["layers"][0]["ffn"]["w1"].shape == (4, cfg.d_ff, cfg.d_model)
    resumed = train(cfg, TrainHParams(**hp), LoopConfig(steps=3, batch_size=4, seed=4), data,
                    resume_from=ck, log_fn=lambda *a: None, device="cpu")
    assert [r["step"] for r in resumed["history"]] == [3] and np.isfinite(
        resumed["history"][0]["loss"])


def _attribution_and_debug(tmp_path):
    """(l) Attribution and the debug helpers.  A 4-step CPU loop with
    ``attribution_every=2`` writes two ``kind="attribution"`` records with
    the JAX probe's key set plus the probe's own wall time and the source
    of its device time, their compute and host-gap fractions summing to 1
    (1e-3, the records' rounding) and splitting the loop's own step time
    (the step record's) against the device time, which on the CPU is the
    probe's fenced wall time; the first record carries the roofline;
    the live state after the run is bit-equal to the same run's without
    the probe; ``report`` renders the records.  The probe's train-step
    FLOPs are ``train_step_flops``'s, and their ratio to XLA's count of the
    JAX probe's compiled step on the same config is printed and held to
    [0.8, 1.0]: both count the same matmuls and the full (unmasked)
    attention scores, and XLA adds every elementwise op (norms, softmax,
    the loss, clipping and AdamW), so the analytic count can only be the
    smaller; on this 3-layer d64 config the elementwise work is about a
    tenth of XLA's count (0.89 measured), and a dropped matmul or a wrong
    factor in either count would leave the band.  ``check_finite``
    raises JAX's message on params and an AdamW state; ``nan_checks``
    restores autograd's anomaly mode."""
    import contextlib
    import io

    from bpe_transformer_tpu.telemetry.attribution import StepProbe as JaxStepProbe
    from bpe_transformer_tpu.utils.debug import check_finite as jax_check_finite
    from bpe_transformer_tpu_torch.telemetry.attribution import StepProbe
    from bpe_transformer_tpu_torch.telemetry.report import main as report_main
    from bpe_transformer_tpu_torch.utils import check_finite, nan_checks
    from bpe_transformer_tpu_torch.utils.flops import train_step_flops

    cfg = dataclasses.replace(TS_TEST_CONFIG, vocab_size=64, context_length=16)
    jcfg = _jax_config(cfg)
    batch = 2
    jax_params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jax_probe = JaxStepProbe(jcfg, JaxTrainHParams(), batch_size=batch, iters=1)
    jax_record = jax_probe.attribution_record(
        jax_params, jax_adamw_init(jax_params), step=2, wall_step_s=1.0, t=0.0)

    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, 2000).astype(np.uint16)
    states = {}
    for every in (0, 2):
        loop = LoopConfig(steps=4, batch_size=batch, log_every=2, attribution_every=every,
                          checkpoint_every=4, checkpoint_dir=str(tmp_path / f"attr_ck{every}"),
                          metrics_jsonl=str(tmp_path / f"attr{every}.jsonl"))
        train(cfg, TrainHParams(), loop, tokens, device="cpu", log_fn=lambda *a: None)
        states[every] = load_checkpoint(tmp_path / f"attr_ck{every}" / "latest.ckpt")
    for key in ("params", "opt_state"):
        for a, b in zip(tree_leaves(states[0][key]), tree_leaves(states[2][key])):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key
    records = [json.loads(line) for line in (tmp_path / "attr2.jsonl").read_text().splitlines()]
    attrs = [r for r in records if r.get("kind") == "attribution"]
    assert [r["step"] for r in attrs] == [2, 4], attrs
    port_only = {"probe_wall_step_s", "device_time_from"}
    assert set(attrs[0]) == set(jax_record) | port_only, set(attrs[0]) ^ set(jax_record)
    assert set(attrs[1]) == set(jax_record) - {"programs"} | port_only
    step_wall = {r["step"]: r["step_wall_s"] for r in records if r.get("kind") is None
                 and "step_wall_s" in r}
    for r in attrs:
        assert abs(r["compute_frac"] + r["host_gap_frac"] - 1.0) <= 1e-3, r
        assert r["collective_frac"] == 0.0 and r["device_step_s"] > 0, r
        assert r["device_time_from"] == "fenced_wall", r
        assert r["device_step_s"] == r["probe_wall_step_s"], r
        assert abs(r["wall_step_s"] - step_wall[r["step"]]) <= 1e-6, (r, step_wall)
        assert abs(r["compute_frac"] - r["device_step_s"]
                   / max(r["wall_step_s"], r["device_step_s"])) <= 1e-3, r
    row = attrs[0]["programs"][0]
    assert row["name"] == "train_step" and row["bound"] == "unknown"
    assert row["flops"] == train_step_flops(cfg, batch)
    ratio = row["flops"] / jax_record["programs"][0]["flops"]
    print(f"analytic / XLA train-step FLOPs: {ratio:.4f}")
    assert 0.8 <= ratio <= 1.0, ratio
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report_main([str(tmp_path / "attr2.jsonl")]) == 0
    assert "== attribution (2 records" in out.getvalue(), out.getvalue()
    with pytest.raises(ValueError, match="multiple of log_every"):
        train(cfg, TrainHParams(), LoopConfig(steps=4, batch_size=batch, log_every=2,
                                             attribution_every=3), tokens, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 10"):
        StepProbe(cfg, TrainHParams(), batch_size=batch, parallel="dp", device="cpu")

    # check_finite: the JAX package's message, on params and on an AdamW state.
    params = params_from_jax(jax_params, "cpu")
    params["layers"][1]["attn"]["k_proj"][0, 0] = float("nan")
    opt = adamw_init(params)
    opt.v["lm_head"][1, 2] = float("inf")
    jax_opt = jax_adamw_init(jax_params)
    jax_bad = (jax.tree_util.tree_map(np.array, jax_params), jax_opt)
    jax_bad[0]["layers"][1]["attn"]["k_proj"][0, 0] = np.nan
    jax_opt = jax_opt._replace(v={**jax_opt.v, "lm_head": jax_opt.v["lm_head"].at[1, 2].set(
        jnp.inf)})
    for tree, jax_tree, name in ((params, jax_bad[0], "params"), (opt, jax_opt, "opt_state")):
        messages = []
        for fn, t in ((check_finite, tree), (jax_check_finite, jax_tree)):
            with pytest.raises(FloatingPointError) as info:
                fn(t, name)
            messages.append(str(info.value))
        assert messages[0] == messages[1], messages
    check_finite(adamw_init(params_from_jax(jax_params, "cpu")), "clean")
    before = torch.is_anomaly_enabled()
    with nan_checks():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    assert torch.is_anomaly_enabled() == before


def test_torch_training_matches_jax(tmp_path):
    _pinned_trajectory()
    _one_step_grads()
    _loops_from_one_checkpoint(tmp_path)
    _two_matrix_ffns(tmp_path)
    _resume_through_verification(tmp_path)
    _sp_step()
    _taps_and_scan()
    _loop_telemetry_and_faults(tmp_path)
    _preemption_and_supervisor(tmp_path)
    _moe()
    _moe_loop(tmp_path)
    _attribution_and_debug(tmp_path)
