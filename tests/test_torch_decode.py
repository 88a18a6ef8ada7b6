"""The PyTorch port's KV-cached prefill and decode step held against the JAX
package's, with the kernel knobs of the ported serving path
(``attention_impl="flash"``, ``ffn_impl="pallas"``,
``decode_attention_impl="pallas"``), and the paged twins
(``init_kv_pool``, ``paged_chunk_prefill``, ``paged_decode_step``) at act
width and with int8 KV blocks, under ``decode_attention_impl`` "paged" and
"xla", with the speculative verify pass (``paged_verify_step``) after the
decode steps and the final hidden states that ``return_hidden`` gives; for
the SwiGLU FFN and for the two-matrix ``silu`` and ``gelu`` FFNs.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs on the CPU (``device="cpu"``), where its kernel wrappers take their
plain versions.  Logits agree to 1e-4, the tolerance of the JAX package's
own trained-fixture test; caches and act-width pools to 1e-5; int8 pool
values within 1 (a value rounding at the other side of a .5 boundary) and
their scales to a relative 1e-5 (the verify pass quantizes its rows one
after another as JAX's sequential quantizer does, so the same bounds hold);
hidden states to 1e-4.  The trash block 0 takes masked writes in no fixed
order, so it is left out of the pool comparison.  The MoE FFN runs both
dispatches at a capacity factor of 1, where a per-call default capacity
would drop tokens in a 3-token decode step: the port's decode capacity rule
(``_ffn_decode``, from ``context_length``) must give JAX's logits and pools.
Batched ``generate_cached`` and ``generate_ids`` give the JAX functions'
greedy ids (``_generate_cached_matches_jax``).
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
from bpe_transformer_tpu_torch.models.decode import (
    decode_step,
    generate_cached,
    init_kv_cache,
    init_kv_pool,
    paged_chunk_prefill,
    paged_decode_step,
    paged_verify_step,
    prefill,
)
from bpe_transformer_tpu_torch.models.transformer import (
    params_from_jax,
    params_from_state_dict,
)
from bpe_transformer_tpu_torch.ops.core import head_logits

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
        lambda p, t, pos, c, a, h=False: jax_decode.decode_step(
            p, t, pos, c, jax_cfg, active=a, return_hidden=h),
        static_argnums=5,
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
        if step == 0:
            # The final hidden state (the step's cache write is idempotent).
            j_hidden, _ = j_step(jax_params, jnp.asarray(token), jnp.asarray(pos, jnp.int32),
                                 j_cache, jnp.asarray(active), True)
            with torch.inference_mode():
                hidden, _ = decode_step(
                    torch_params, torch.as_tensor(token, dtype=torch.int64),
                    torch.as_tensor(pos), cache, cfg, active=torch.as_tensor(active),
                    return_hidden=True,
                )
            np.testing.assert_allclose(hidden.numpy(), np.asarray(j_hidden), atol=1e-4,
                                       err_msg="decode_step return_hidden")
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
        if step == 0:
            assert torch.equal(head_logits(hidden, lm_head_of(torch_params, cfg)), logits)
        for layer, (j_layer, t_layer) in enumerate(zip(j_cache, cache)):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    t_layer[name].numpy(), np.asarray(j_layer[name]), atol=1e-5,
                    err_msg=f"cache layer {layer} {name} after step {step}",
                )
        token = np.where(active, np.argmax(np.asarray(j_logits), axis=-1), token)
        pos = np.where(active, pos + 1, pos)


def lm_head_of(params, cfg):
    return params["token_embeddings"] if cfg.tie_embeddings else params["lm_head"]


def _assert_pools(pool, j_pool, what):
    for layer, (t_layer, j_layer) in enumerate(zip(pool, j_pool)):
        assert set(t_layer) == set(j_layer)
        for name, arr in t_layer.items():
            got, want = arr.numpy()[1:], np.asarray(j_layer[name])[1:]
            assert got.dtype == want.dtype, (what, name, got.dtype, want.dtype)
            msg = f"{what}: pool layer {layer} {name}"
            if got.dtype == np.int8:
                assert np.abs(got.astype(np.int32) - want).max() <= 1, msg
            elif name.endswith("_scale"):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=msg)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, err_msg=msg)


def _run_paged(jax_params, torch_params, jax_cfg, cfg, ids, block_size, steps,
               impls=("paged", "xla")):
    """Prefill three slots into a paged pool through shuffled block tables
    in both packages (slot 0 in two chunks, slot 1 resuming after a
    block-aligned prefix shared with slot 0, slot 2 in one chunk), then take
    ``steps`` greedy decode steps at ragged positions that cross block
    boundaries, with slot 2 inactive; for act and int8 pools and the
    decode attentions ``impls``, assert logits and pools agree at every
    stage."""
    ids = np.array(ids[:3], np.int32)
    ids[1, :block_size] = ids[0, :block_size]  # slot 1 shares slot 0's first block
    lengths = [2 * block_size + 2, block_size + 3, block_size + 1]
    chunk = 2 * block_size
    nbs = cfg.context_length // block_size
    num_blocks = 3 * nbs + 1
    tables = np.random.default_rng(9).permutation(np.arange(1, num_blocks))[: 3 * nbs]
    tables = tables.reshape(3, nbs).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    # (slot, start, length) per chunk; the shared block is never rewritten.
    chunks = [(0, 0, chunk), (0, chunk, lengths[0] - chunk), (1, block_size, 3), (2, 0, lengths[2])]
    active = np.array([True, True, False])
    for kv_dtype in (None, "int8"):
        for impl in impls:
            jcfg = dataclasses.replace(jax_cfg, decode_attention_impl=impl)
            tcfg = dataclasses.replace(cfg, decode_attention_impl=impl)
            what = f"kv_dtype={kv_dtype} impl={impl}"
            j_pool = jax_decode.init_kv_pool(jcfg, num_blocks, block_size, kv_dtype=kv_dtype)
            pool = init_kv_pool(tcfg, num_blocks, block_size, kv_dtype=kv_dtype, device="cpu")
            _assert_pools(pool, j_pool, f"{what} init")
            j_chunk = jax.jit(lambda p, c, s, n, t, pl, jcfg=jcfg: jax_decode.paged_chunk_prefill(
                p, c, s, n, t, pl, jcfg, block_size=block_size))
            for slot, start, n in chunks:
                padded = np.zeros((1, chunk), np.int32)
                padded[0, :n] = ids[slot, start:start + n]
                j_logits, j_pool = j_chunk(jax_params, jnp.asarray(padded), jnp.int32(start),
                                           jnp.int32(n), jnp.asarray(tables[slot]), j_pool)
                with torch.inference_mode():
                    logits, _ = paged_chunk_prefill(
                        torch_params, torch.as_tensor(padded, dtype=torch.int64), start, n,
                        torch.as_tensor(tables[slot]), pool, tcfg, block_size=block_size,
                    )
                stage = f"{what} chunk slot {slot} start {start}"
                np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4,
                                           err_msg=stage)
                _assert_pools(pool, j_pool, stage)
            j_step = jax.jit(lambda p, tok, pos, pl, t, a, h=False, jcfg=jcfg:
                             jax_decode.paged_decode_step(p, tok, pos, pl, t, jcfg, active=a,
                                                          return_hidden=h, block_size=block_size),
                             static_argnums=6)
            pos = np.array(lengths, np.int32)
            token = ids[np.arange(3), pos - 1]
            for step in range(steps):
                if step == 0:
                    # The final hidden state (the step's pool write is idempotent).
                    j_hidden, _ = j_step(jax_params, jnp.asarray(token), jnp.asarray(pos),
                                         j_pool, jnp.asarray(tables), jnp.asarray(active), True)
                    with torch.inference_mode():
                        hidden, _ = paged_decode_step(
                            torch_params, torch.as_tensor(token, dtype=torch.int64),
                            torch.as_tensor(pos, dtype=torch.int64), pool,
                            torch.as_tensor(tables), tcfg, active=torch.as_tensor(active),
                            return_hidden=True, block_size=block_size,
                        )
                    np.testing.assert_allclose(hidden.numpy()[active],
                                               np.asarray(j_hidden)[active], atol=1e-4,
                                               err_msg=f"{what} return_hidden")
                j_logits, j_pool = j_step(jax_params, jnp.asarray(token), jnp.asarray(pos),
                                          j_pool, jnp.asarray(tables), jnp.asarray(active))
                with torch.inference_mode():
                    logits, _ = paged_decode_step(
                        torch_params, torch.as_tensor(token, dtype=torch.int64),
                        torch.as_tensor(pos, dtype=torch.int64), pool, torch.as_tensor(tables),
                        tcfg, active=torch.as_tensor(active), block_size=block_size,
                    )
                stage = f"{what} decode step {step}"
                np.testing.assert_allclose(logits.numpy()[active], np.asarray(j_logits)[active],
                                           atol=1e-4, err_msg=stage)
                _assert_pools(pool, j_pool, stage)
                token = np.where(active, np.argmax(np.asarray(j_logits), axis=-1), token)
                pos = np.where(active, pos + 1, pos)
            if impl != "paged":
                continue  # the verify pass does not read decode_attention_impl
            # The verify pass: each slot's last token and 3 proposals from its
            # frontier, rooms 3 / 1 / 2 (slot 2 inactive), twice at the same
            # positions (a rewind and a new window rewrite the rows; int8
            # blocks keep their grown scales).  Near the context edge rows
            # past it go to the trash block.
            j_verify = jax.jit(lambda p, tk, ps, rm, pl, t, a, jcfg=jcfg:
                               jax_decode.paged_verify_step(p, tk, ps, rm, pl, t, jcfg, active=a,
                                                            block_size=block_size))
            rooms = np.array([3, 1, 2], np.int32)
            for window in range(2):
                tokens = np.concatenate(
                    [token[:, None], ids[:3, window + 1:window + 4]], axis=1).astype(np.int32)
                j_logits, j_pool = j_verify(jax_params, jnp.asarray(tokens), jnp.asarray(pos),
                                            jnp.asarray(rooms), j_pool, jnp.asarray(tables),
                                            jnp.asarray(active))
                with torch.inference_mode():
                    logits, _ = paged_verify_step(
                        torch_params, torch.as_tensor(tokens, dtype=torch.int64),
                        torch.as_tensor(pos, dtype=torch.int64), torch.as_tensor(rooms), pool,
                        torch.as_tensor(tables), tcfg, active=torch.as_tensor(active),
                        block_size=block_size,
                    )
                stage = f"{what} verify window {window}"
                assert logits.shape == (3, 4, cfg.vocab_size)
                live = active[:, None] & (np.arange(4)[None, :] <= rooms[:, None])
                np.testing.assert_allclose(logits.numpy()[live], np.asarray(j_logits)[live],
                                           atol=1e-4, err_msg=stage)
                _assert_pools(pool, j_pool, stage)


def _generate_cached_matches_jax():
    """Batched ``generate_cached`` against the JAX function at 2 layers, d
    64, vocab 256, GQA on 2 KV heads, batch 3, float32, under the kernel
    knobs: greedy ids identical, with and without a ``stop_id`` (the tokens
    after a row's first stop pinned to it), one new token, the context
    error's text; ``generate_ids`` (one row, through ``generate_cached``)
    equal to JAX's; a seeded sampled run repeatable and pinned."""
    from bpe_transformer_tpu.training.sampling import generate_ids as jax_generate_ids
    from bpe_transformer_tpu_torch.training.sampling import generate_ids

    jax_cfg = dataclasses.replace(
        JAX_TS_TEST_CONFIG, vocab_size=256, context_length=32, d_model=64, num_layers=2,
        num_heads=4, num_kv_heads=2, d_ff=128, **KERNEL_KNOBS,
    )
    cfg = ModelConfig.from_dict(dataclasses.asdict(jax_cfg))
    jax_params = jax.tree_util.tree_map(
        lambda a: a * 8 if a.ndim == 2 else a, jax_init_params(jax.random.PRNGKey(7), jax_cfg)
    )
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    prompts = np.random.default_rng(8).integers(0, 256, size=(3, 10)).astype(np.int32)

    def both(n, **kw):
        want = np.asarray(jax_decode.generate_cached(
            jax_params, jnp.asarray(prompts), jax.random.PRNGKey(0), config=jax_cfg,
            max_new_tokens=n, temperature=0.0, **kw))
        got = generate_cached(params, prompts, config=cfg, max_new_tokens=n, temperature=0.0,
                              device="cpu", **kw)
        assert got.shape == (3, n) and got.dtype == torch.long, got.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
        return want

    free = both(12)
    stop = int(free[0, 3])
    pinned = both(12, stop_id=stop)
    first = list(pinned[0]).index(stop)
    assert first <= 3 and (pinned[0, first:] == stop).all(), pinned
    both(1)
    both(1, stop_id=int(free[1, 0]))
    errors = []
    for fn in (lambda: jax_decode.generate_cached(
                   jax_params, jnp.asarray(prompts), jax.random.PRNGKey(0), config=jax_cfg,
                   max_new_tokens=23, temperature=0.0),
               lambda: generate_cached(params, prompts, config=cfg, max_new_tokens=23,
                                       device="cpu")):
        try:
            fn()
        except ValueError as exc:
            errors.append(str(exc))
    assert len(errors) == 2 and errors[0] == errors[1], errors
    for stop_id in (None, stop):
        want = jax_generate_ids(jax_params, jax_cfg, list(prompts[0]), max_new_tokens=12,
                                temperature=0.0, stop_id=stop_id)
        got = generate_ids(params, cfg, list(prompts[0]), max_new_tokens=12, temperature=0.0,
                           stop_id=stop_id, device="cpu")
        assert got == [int(t) for t in want], (stop_id, got, want)
    sampled = [
        generate_cached(params, prompts, config=cfg, max_new_tokens=12, temperature=1.0,
                        top_k=8, stop_id=stop, generator=torch.Generator().manual_seed(3),
                        device="cpu")
        for _ in range(2)
    ]
    assert torch.equal(sampled[0], sampled[1])
    for row in sampled[0].tolist():
        if stop in row:
            assert all(t == stop for t in row[row.index(stop):]), row


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
    _run_paged(jax_params, torch_params, jax_cfg, cfg, ids, block_size=4, steps=3)

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
    _run_paged(jax_params, torch_params, jax_cfg, cfg, ids, block_size=4, steps=3)

    # The two-matrix FFNs (silu plain, gelu through the GeLU kernel's
    # wrapper), dense and paged, act and int8 pools, on random weights whose
    # matrices are at 8 times the init scale (the norm gains stay 1, so the
    # K/V rows and the logits are of order 1).
    for ffn_type in ("silu", "gelu"):
        jax_cfg = dataclasses.replace(
            JAX_TS_TEST_CONFIG, vocab_size=96, context_length=24, ffn_type=ffn_type,
            **KERNEL_KNOBS,
        )
        cfg = ModelConfig.from_dict(dataclasses.asdict(jax_cfg))
        jax_params = jax.tree_util.tree_map(
            lambda a: a * 8 if a.ndim == 2 else a, jax_init_params(jax.random.PRNGKey(5), jax_cfg)
        )
        torch_params = params_from_jax(jax.device_get(jax_params), device="cpu")
        _run_both(
            jax_params, torch_params, jax_cfg, cfg, ids,
            last_pos=np.array([11, 4, 8], np.int32), steps=2,
        )
        _run_paged(jax_params, torch_params, jax_cfg, cfg, ids, block_size=4, steps=2,
                   impls=("paged",))

    # The MoE FFN (4 experts, capacity factor 1): top-2 gather and top-1
    # einsum, dense and paged.  The decode capacity comes from the context
    # length: at 3 tokens a step the per-call default (1 slot an expert)
    # would drop tokens, the decode rule keeps them all.  Matrices at 8
    # times the init scale (the 3-D expert stacks and the router too).
    for top_k, dispatch in ((2, "gather"), (1, "einsum")):
        jax_cfg = dataclasses.replace(
            JAX_TS_TEST_CONFIG, vocab_size=96, context_length=24, ffn_type="moe", n_experts=4,
            router_top_k=top_k, capacity_factor=1.0, moe_dispatch=dispatch, **KERNEL_KNOBS,
        )
        cfg = ModelConfig.from_dict(dataclasses.asdict(jax_cfg))
        jax_params = jax.tree_util.tree_map(
            lambda a: a * 8 if a.ndim >= 2 else a, jax_init_params(jax.random.PRNGKey(6), jax_cfg)
        )
        torch_params = params_from_jax(jax.device_get(jax_params), device="cpu")
        assert torch_params["layers"][0]["ffn"]["w2"].shape == (4, cfg.d_model, cfg.d_ff)
        _run_both(
            jax_params, torch_params, jax_cfg, cfg, ids,
            last_pos=np.array([11, 4, 8], np.int32), steps=2,
        )
        if dispatch == "gather":
            _run_paged(jax_params, torch_params, jax_cfg, cfg, ids, block_size=4, steps=2,
                       impls=("paged",))

    _generate_cached_matches_jax()
