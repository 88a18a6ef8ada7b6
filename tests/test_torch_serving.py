"""The PyTorch port's continuous-batching serving path held against the JAX
package's: greedy tokens identical to the JAX ``SlotPoolEngine`` and
``PagedEngine`` (act and int8 KV blocks, int8 weights, prefix sharing),
seeded sampling that replays and agrees between the port's paged and dense
engines, the serving weight bytes and label equal to JAX's, the paged
``ServingEngine`` parking admissions the block pool cannot cover,
``filter_logits`` masks identical on shared logits, the fused-sampling tick
giving the unfused tick's tokens, and speculative decoding: the port's
``SpecEngine`` greedy tokens identical to its ``PagedEngine``'s and to the
JAX ``SpecEngine``'s (fused and unfused tails, act width and int8), its
verify tail giving JAX's ``(out, n_emit)`` on JAX's own noise, and the
``rewind``/``extend_blocks`` bookkeeping equal to JAX's; and the two-matrix
``silu`` and ``gelu`` FFNs served by the dense, paged (act, int8) and
speculative engines with JAX's greedy tokens and weight gauges, as is the
MoE FFN (act weights, act and int8 KV; int8 weights refused by both), also
through ``generate`` on a JAX-written MoE checkpoint.

The serving surface is held against the JAX package's too: the regex-free
host tokenizer (its class tables against ``regex`` itself, pre-tokens and
special-token splits on a seeded multilingual corpus, a trained vocabulary
and merge list, encode/decode and the token file) and its native C++ engine
(pre-tokens, counts, merges and ids against the JAX package's engine and
the port's Python path, the generated class tables byte for byte,
``BT_NATIVE=0``), the HTTP server (greedy
``/generate`` ids and completions, ``stop_id``, the 400/503 paths with
``X-Request-Id`` echoed, the ``/healthz``/``/statusz`` keys and the
Prometheus families, drain, offline batch files, a schema-valid telemetry
stream), and the CLIs on a JAX-written checkpoint (``serve`` in a
subprocess read by the JAX package's ``report`` and ``monitor``,
``generate`` against ``generate_ids``, ``eval`` against ``cmd_eval`` within
1e-5, the rc-2 flag checks, ``--role`` and ``--evacuate-to`` among them).

And the serving fleet: the KV payload frames byte-identical to the JAX
package's (float32, int8 with scales, bfloat16, v1, corrupt bodies
refused, codec negotiation), migration mid-decode and mid-prefill
token-identical to the unmigrated run (port to port, greedy and seeded;
port to JAX and back, greedy; the speculative engine too), export
read-only on shared blocks, malformed payloads refused by both packages;
and with in-process HTTP replicas, prefill and decode roles behind the
port's router and JAX's, a JAX prefill replica feeding a port decode
replica, drain evacuation and ``/admin/evacuate`` with no failed request,
a ``BT_FAULTS`` corrupted payload answered 400 and its clean retry under one
idempotency key grafted once, the controller deciding as JAX's on the same
evidence, and fleet records that JAX's ``report`` renders.

Both packages run a GQA model with the kernel knobs of the ported serving
path, on random JAX weights at 8 times the init scale (the greedy tokens
then vary, and the top two logits of every step differ by about 0.02,
far above the packages' numerical differences).  The JAX side runs its
Pallas kernels in interpret mode on the CPU, the port runs on the CPU
(``device="cpu"``) through its plain versions.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bpe_transformer_tpu.models import TS_TEST_CONFIG as JAX_TS_TEST_CONFIG
from bpe_transformer_tpu.models import init_params as jax_init_params
from bpe_transformer_tpu.serving.engine import SlotPoolEngine as JaxSlotPoolEngine
from bpe_transformer_tpu.serving.engine import filter_logits as jax_filter_logits
from bpe_transformer_tpu.serving.engine import (
    prepare_serving_weights as jax_prepare_serving_weights,
)
from bpe_transformer_tpu.serving.kvpool.paged_engine import PagedEngine as JaxPagedEngine
from bpe_transformer_tpu.serving.spec.draft import DraftSpec as JaxDraftSpec
from bpe_transformer_tpu.serving.spec.engine import SpecEngine as JaxSpecEngine
from bpe_transformer_tpu.serving.spec.engine import _spec_verify_program
from bpe_transformer_tpu_torch.models import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import params_from_jax
from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine, filter_logits
from bpe_transformer_tpu_torch.serving.kvpool import NoFreeBlocksError, PagedEngine
from bpe_transformer_tpu_torch.models.decode import paged_verify_step
from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine
from bpe_transformer_tpu_torch.serving.spec import DraftModel, DraftSpec, SpecEngine
from bpe_transformer_tpu_torch.serving.spec import spec_verify_tail

JAX_CFG = dataclasses.replace(
    JAX_TS_TEST_CONFIG, vocab_size=128, context_length=32, num_kv_heads=2,
    attention_impl="flash", ffn_impl="pallas", decode_attention_impl="pallas",
)


def _drive(engine, prompts, max_new_tokens, **knobs):
    """Serve ``prompts`` (greedily unless ``knobs`` say otherwise) through a
    slot-pool or paged engine, admitting whenever a slot is free; returns
    each prompt's tokens in input order."""
    knobs = {"temperature": 0.0, **knobs}
    outs, pending, owner = {}, list(range(len(prompts))), {}
    while pending or owner:
        while pending and engine.free_slots:
            i = pending.pop(0)
            event = engine.admit(prompts[i], max_new_tokens=max_new_tokens, **knobs)
            outs[i] = [event.token]
            if not event.finished:
                owner[event.slot] = i
        for event in engine.tick():
            outs[owner[event.slot]].append(event.token)
            if event.finished:
                del owner[event.slot]
    return [outs[i] for i in range(len(prompts))]


REPO = Path(__file__).resolve().parent.parent


def test_torch_serving_matches_jax_engine(tmp_path):
    cfg = ModelConfig.from_dict(dataclasses.asdict(JAX_CFG))
    jax_params = jax.tree_util.tree_map(
        lambda a: a * 8, jax_init_params(jax.random.PRNGKey(0), JAX_CFG)
    )
    params = params_from_jax(jax.device_get(jax_params), device="cpu")

    # Greedy: six prompts across the 8/16/32 buckets through two slots, so
    # slots are reused and admissions interleave with ticks.
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in (3, 7, 12, 19, 5, 26)]
    jax_engine = JaxSlotPoolEngine(jax_params, JAX_CFG, slots=2, min_bucket=8)
    want = _drive(jax_engine, prompts, 6)
    engine = SlotPoolEngine(params, cfg, slots=2, min_bucket=8, device="cpu")
    assert engine.buckets == jax_engine.buckets == (8, 16, 32)
    assert _drive(engine, prompts, 6) == want
    assert engine.ticks == jax_engine.ticks
    assert all(s == {"slot": i, "active": False} for i, s in enumerate(engine.slot_states()))

    # Re-admission replaces the slot's whole cache row: a short prompt in a
    # slot that held a long one leaves zeros past its bucket, as in JAX.
    for eng in (engine, jax_engine):
        event = eng.admit(prompts[0], max_new_tokens=6, temperature=0.0)
        assert event.slot == 0
    for t_layer, j_layer in zip(engine._cache, jax_engine._cache):
        for name in ("k", "v"):
            row = t_layer[name][0].numpy()
            np.testing.assert_allclose(row, np.asarray(j_layer[name][0]), atol=1e-4)
            assert not row[:, 8:].any() and row[:, :3].any()

    with ServingEngine(params, cfg, slots=3, min_bucket=8, device="cpu") as serving:
        results = serving.run_batch(prompts, max_new_tokens=6, temperature=0.0)
        assert [list(r.token_ids) for r in results] == want
        assert all(r.finish_reason == "length" for r in results)

        # Sampling: a seeded request replays the same tokens, alone or
        # beside other requests (each slot draws from its own generator).
        sampled = Request(prompt_ids=tuple(prompts[3]), max_new_tokens=4,
                          temperature=0.9, top_k=40, top_p=0.95, seed=11)
        alone = list(serving.stream(sampled))
        handles = [serving.submit(Request(prompt_ids=tuple(p), max_new_tokens=4,
                                          temperature=0.0)) for p in prompts[:2]]
        beside = serving.submit(dataclasses.replace(sampled, request_id="again"))
        assert list(beside.result(timeout=60).token_ids) == alone
        assert [list(h.result(timeout=60).token_ids) for h in handles] == [
            w[:4] for w in want[:2]
        ]
        assert len(alone) == 4 and all(0 <= t < cfg.vocab_size for t in alone)

        # Callers on several threads at once (switching often) each get their
        # own request's tokens; a request cancelled right after submission
        # (queued or in a slot) finishes as cancelled.
        old_interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with ThreadPoolExecutor(max_workers=6) as pool:
                futures = [pool.submit(serving.generate, p, max_new_tokens=6, temperature=0.0,
                                       timeout=60) for p in prompts]
                queued = serving.submit(Request(prompt_ids=(1, 2), max_new_tokens=6))
                serving.cancel(queued.request_id)
                got = [list(f.result(timeout=120).token_ids) for f in futures]
        finally:
            sys.setswitchinterval(old_interval)
        assert got == want
        assert queued.result(timeout=60).finish_reason == "cancelled"

    # Serving weights: params_bytes (the tree and the head copy),
    # tick_weight_bytes and the label equal to JAX's at the activation width
    # and under int8 weights, on both engines.
    for weight_dtype in (None, "int8"):
        _, _, label, params_bytes, tick_bytes = jax_prepare_serving_weights(
            jax_params, JAX_CFG, weight_dtype
        )
        for eng in (
            SlotPoolEngine(params, cfg, slots=2, weight_dtype=weight_dtype, device="cpu"),
            PagedEngine(params, cfg, slots=2, block_size=4, weight_dtype=weight_dtype,
                        device="cpu"),
        ):
            assert (eng.weight_dtype, eng.params_bytes, eng.tick_weight_bytes) == (
                label, params_bytes, tick_bytes), (type(eng).__name__, weight_dtype)

    # Paged serving: the JAX PagedEngine's greedy tokens, with prompts that
    # share a two-block prefix (the prefix cache's hits equal JAX's), for
    # act KV, int8 KV, and int8 KV with int8 weights.
    paged_cfg = dataclasses.replace(JAX_CFG, decode_attention_impl="paged")
    tcfg = ModelConfig.from_dict(dataclasses.asdict(paged_cfg))
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, size=8)]
    paged_prompts = [shared + p[:n] for p, n in zip(prompts, (3, 7, 12))] + prompts[:3]
    knobs = dict(slots=2, block_size=4, prefill_chunk=8, min_bucket=8)
    paged_want = {}
    for kv_dtype, weight_dtype in ((None, None), ("int8", None), ("int8", "int8")):
        jax_paged = JaxPagedEngine(jax_params, paged_cfg, kv_dtype=kv_dtype,
                                   weight_dtype=weight_dtype, **knobs)
        want_paged = _drive(jax_paged, paged_prompts, 6)
        paged = PagedEngine(params, tcfg, kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                            device="cpu", **knobs)
        assert paged.buckets == jax_paged.buckets == (8,)
        assert _drive(paged, paged_prompts, 6) == want_paged, (kv_dtype, weight_dtype)
        gauges = paged.gauges()
        assert gauges["prefix_cache_hits"] >= 8
        for key in ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_nodes",
                    "kv_blocks_free", "kv_pool_bytes", "kv_bytes_per_token"):
            assert gauges[key] == jax_paged.gauges()[key], (key, kv_dtype, weight_dtype)
        paged_want[kv_dtype, weight_dtype] = want_paged

    # The port's paged engine (act KV) and dense engine give the same
    # tokens, greedy and seeded-sampled (one generator per slot, drawn once
    # a token on both).
    dense = SlotPoolEngine(params, cfg, slots=2, min_bucket=8, device="cpu")
    paged = PagedEngine(params, tcfg, device="cpu", **knobs)
    assert _drive(dense, paged_prompts, 6) == paged_want[None, None]
    sampled = dict(temperature=0.9, top_k=40, top_p=0.95, seed=7)
    got_dense = _drive(dense, paged_prompts, 6, **sampled)
    assert _drive(paged, paged_prompts, 6, **sampled) == got_dense
    assert got_dense != paged_want[None, None]

    # The paged ServingEngine with a pool of two requests' worth of blocks
    # and a prefill budget of one chunk a tick: requests park and are
    # admitted in order as blocks free, every one finishes with JAX's
    # tokens, a request cancelled while parked finishes as cancelled, and
    # afterwards every usable block is free or held by the prefix cache.
    # The first admission waits until every request is queued, so that the
    # third one in line (20 tokens of its own) finds the pool short.
    need = max(paged.blocks_needed(len(p), 6) for p in paged_prompts)
    with ServingEngine(params, tcfg, paged=True, slots=3, block_size=4, prefill_chunk=8,
                       min_bucket=8, num_kv_blocks=2 * need + 1, prefill_token_budget=8,
                       device="cpu") as serving:
        engine = serving.engine
        parked, begin, all_queued = [], engine.begin, threading.Event()

        def gated_begin(prompt_ids, **kw):
            all_queued.wait(timeout=60)
            try:
                return begin(prompt_ids, **kw)
            except NoFreeBlocksError:
                parked.append(kw["request_id"])
                if kw["request_id"] == "cancel-me":
                    serving.cancel("cancel-me")  # on the worker thread, while parked
                raise

        engine.begin = gated_begin
        requests = [Request(prompt_ids=tuple(p), max_new_tokens=6, temperature=0.0)
                    for p in paged_prompts]
        victim = Request(prompt_ids=tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 20)),
                         max_new_tokens=6, request_id="cancel-me")
        handles = [serving.submit(r) for r in requests[:2] + [victim] + requests[2:]]
        all_queued.set()
        results = [h.result(timeout=120) for h in handles]
    assert results.pop(2).finish_reason == "cancelled"
    assert [list(r.token_ids) for r in results] == paged_want[None, None]
    assert all(r.finish_reason == "length" for r in results)
    assert parked[0] == "cancel-me" and len(parked) >= 2, parked
    cached = len(engine.prefix_cache)
    assert cached > 0
    assert engine.allocator.free_count + cached == engine.allocator.usable_blocks

    # Fused sampling: the fused tick gives the unfused tick's tokens, greedy
    # and seeded-sampled (on the CPU both tails run the same plain math), on
    # the dense and the paged engine.
    for fused_engine, plain_engine in (
        (SlotPoolEngine(params, cfg, slots=2, min_bucket=8, fused_sampling=True, device="cpu"),
         dense),
        (PagedEngine(params, tcfg, fused_sampling=True, device="cpu", **knobs), paged),
    ):
        assert _drive(fused_engine, paged_prompts, 6) == paged_want[None, None]
        assert _drive(fused_engine, paged_prompts, 6, **sampled) == got_dense

    # Speculative decoding, greedy: the port's SpecEngine (a one-layer
    # truncated draft, K 3, fused and unfused verify tails) gives the paged
    # engine's tokens through the shared prefix and chunked prefill, and the
    # JAX SpecEngine's with its acceptance gauges; at int8 KV + int8
    # weights, the JAX SpecEngine's tokens.
    spec_knobs = dict(knobs, draft=DraftSpec(truncate_layers=1), speculate_k=3)
    for kv_dtype, weight_dtype in ((None, None), ("int8", "int8")):
        jax_spec = JaxSpecEngine(jax_params, paged_cfg, kv_dtype=kv_dtype,
                                 weight_dtype=weight_dtype, **dict(
                                     spec_knobs, draft=JaxDraftSpec(truncate_layers=1)))
        want_spec = _drive(jax_spec, paged_prompts, 6)
        if kv_dtype is None:
            assert want_spec == paged_want[None, None]
        for fused in (False, True):
            spec = SpecEngine(params, tcfg, kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                              fused_sampling=fused, device="cpu", **spec_knobs)
            assert _drive(spec, paged_prompts, 6) == want_spec, (kv_dtype, fused)
            gauges, want_gauges = spec.spec_gauges(), jax_spec.spec_gauges()
            for key in ("spec_proposed_tokens", "spec_accepted_tokens", "spec_emitted_tokens",
                        "spec_target_steps", "spec_rewound_tokens"):
                assert gauges[key] == want_gauges[key], (key, kv_dtype, fused)
            assert spec.allocator.free_count + len(spec.prefix_cache) == \
                spec.allocator.usable_blocks
    # The truncated draft views the engine's tensors: no weight bytes of its
    # own; a geometry draft owns its (seeded) weights.
    assert spec.draft.param_bytes == 0
    assert spec.draft.params["layers"][0]["attn"]["q_proj"] is \
        spec._params["layers"][0]["attn"]["q_proj"]
    geometry = DraftSpec(d_model=32, num_layers=1, num_heads=2, d_ff=64, seed=3)
    drafts = [DraftModel(params, tcfg, geometry, device="cpu") for _ in range(2)]
    assert drafts[0].param_bytes > 0 and torch.equal(drafts[0].params["lm_head"],
                                                      drafts[1].params["lm_head"])
    for bad, match in ((DraftSpec(truncate_layers=1, vocab_size=7), "vocab_size"),
                       (DraftSpec(truncate_layers=9), "truncate_layers"),
                       (DraftSpec(truncate_layers=1, d_model=8), "not both"),
                       (DraftSpec(d_model=8), "incomplete")):
        with pytest.raises(ValueError, match=match):
            bad.validate_against(tcfg)
    assert DraftSpec.from_dict({"truncate_layers": 2}) == DraftSpec(truncate_layers=2)

    # A pool of exactly one request's reservation: the speculation window
    # shrinks instead of stalling (JAX tests/test_spec.py), with JAX's
    # tokens and proposals, and every block comes back.
    dry = dict(slots=1, block_size=8, min_bucket=8, num_blocks=3, prefix_cache=False,
               speculate_k=3)
    jax_dry = JaxSpecEngine(jax_params, paged_cfg, draft=JaxDraftSpec(truncate_layers=1), **dry)
    port_dry = SpecEngine(params, tcfg, draft=DraftSpec(truncate_layers=1), device="cpu", **dry)
    assert _drive(port_dry, [prompts[2]], 4) == _drive(jax_dry, [prompts[2]], 4)
    assert port_dry.spec_proposed == jax_dry.spec_proposed < 3 * port_dry.spec_target_steps
    assert port_dry.allocator.free_count == port_dry.allocator.usable_blocks

    # rewind / extend_blocks: the same calls on the JAX and the port's paged
    # engines leave the same chains, tables, free counts and results; a
    # rewind into a radix-shared block copies it (all rows) into a fresh one.
    engines = [JaxPagedEngine(jax_params, paged_cfg, slots=2, block_size=4, min_bucket=8),
               PagedEngine(params, tcfg, slots=2, block_size=4, min_bucket=8, device="cpu")]
    for eng in engines:
        eng.admit(paged_prompts[0], max_new_tokens=6, temperature=0.0)  # indexes 2 full blocks
        eng.admit(paged_prompts[1], max_new_tokens=6, temperature=0.0)  # shares the first two
    results = []
    for eng in engines:
        info = eng._slots[1]
        got = [list(info.block_ids)]
        eng.extend_blocks(1, len(paged_prompts[1]) + 12)
        got.append(list(info.block_ids))
        got.append(eng.rewind(1, 14, keep_blocks=5))
        got.append(eng.rewind(1, 6))  # into shared block 1: copy-on-write
        got += [list(info.block_ids), eng._tables[1].tolist(), eng.allocator.free_count,
                info.shared_len]
        results.append(got)
    assert results[0] == results[1], results
    assert results[1][3] == {"released": 3, "cow": True}
    shared, fresh = engines[1]._slots[0].block_ids[1], engines[1]._slots[1].block_ids[1]
    for layer in engines[1]._pool:
        assert torch.equal(layer["k"][fresh], layer["k"][shared])

    # The verify tail from noise to tokens: after three admissions (greedy,
    # top-k 20 / top-p 0.9 at temperature 0.9, temperature 1.3), random draft
    # tokens and draft distributions and rooms 3 / 2 / 3, the port's tail
    # fed the uniforms and gumbel rows that JAX draws from each slot's key
    # gives JAX's (out, n_emit), fused and unfused.
    engines = [JaxPagedEngine(jax_params, paged_cfg, slots=3, block_size=4, min_bucket=8),
               PagedEngine(params, tcfg, slots=3, block_size=4, min_bucket=8, device="cpu")]
    slot_knobs = [dict(temperature=0.0), dict(temperature=0.9, top_k=20, top_p=0.9, seed=5),
                  dict(temperature=1.3, seed=6)]
    for eng in engines:
        for p, kn in zip(prompts[3:6], slot_knobs):
            eng.admit(p, max_new_tokens=12, **kn)
    jax_eng, port_eng = engines
    rng = np.random.default_rng(7)
    k, vocab = 3, cfg.vocab_size
    d_toks = rng.integers(0, vocab, size=(3, k))
    rooms = np.array([3, 2, 3], np.int32)
    for j in range(2):
        # Slots 0 and 1 propose the target's argmax for their first two
        # tokens: acceptances beside the random proposals' rejections.
        with torch.inference_mode():
            logits, _ = paged_verify_step(
                port_eng._params,
                torch.as_tensor(np.concatenate([port_eng._tokens[:, None], d_toks], axis=1)),
                torch.as_tensor(port_eng._positions), torch.as_tensor(rooms), port_eng._pool,
                torch.as_tensor(port_eng._tables), tcfg, lm_head=port_eng._lm_head,
                block_size=4)
        d_toks[:2, j] = torch.argmax(logits[:2, j], dim=-1).numpy()
    d_probs = np.array(jax.nn.softmax(jnp.asarray(rng.standard_normal((3, k, vocab)) * 2.0)),
                       np.float32)
    keys = jnp.asarray(jax_eng._keys)
    split = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
    u = np.array(jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(split[:, 1]))
    g_row = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (vocab,)))(split[:, 2]))
    g_all = np.array(jax.vmap(lambda kk: jax.random.gumbel(kk, (k + 1, vocab)))(split[:, 2]))
    dev_args = dict(rooms=torch.as_tensor(rooms), active=torch.ones(3, dtype=torch.bool),
                    base_tokens=torch.as_tensor(port_eng._tokens),
                    temps=torch.as_tensor(port_eng._temps),
                    top_ks=torch.as_tensor(port_eng._top_ks),
                    top_ps=torch.as_tensor(port_eng._top_ps), u=torch.as_tensor(u))
    tokens = torch.cat([dev_args["base_tokens"][:, None], torch.as_tensor(d_toks)], dim=1)
    outcomes = set()
    for fused, gumbel in ((False, np.repeat(g_row[:, None], k + 1, axis=1)), (True, g_all)):
        j_out, j_emit, _, _ = jax.jit(functools.partial(
            _spec_verify_program, config=paged_cfg, block_size=4, fused=fused))(
            jax_eng._params, jax_eng._lm_head, jax_eng._pool, jax_eng._tables,
            jax_eng._tokens, d_toks.astype(np.int32), d_probs, jax_eng._positions, rooms,
            np.ones(3, bool), keys, jax_eng._temps, jax_eng._top_ks, jax_eng._top_ps)
        with torch.inference_mode():
            scores, _ = paged_verify_step(
                port_eng._params, tokens, torch.as_tensor(port_eng._positions),
                dev_args["rooms"], port_eng._pool, torch.as_tensor(port_eng._tables), tcfg,
                lm_head=port_eng._lm_head, active=dev_args["active"], return_hidden=fused,
                block_size=4)
            out, n_emit = spec_verify_tail(
                scores, port_eng._lm_head, torch.as_tensor(d_toks), torch.as_tensor(d_probs),
                gumbel=torch.as_tensor(gumbel), fused=fused, **dev_args)
        np.testing.assert_array_equal(n_emit.numpy(), np.asarray(j_emit), err_msg=f"{fused}")
        np.testing.assert_array_equal(out.numpy(), np.asarray(j_out), err_msg=f"{fused}")
        outcomes.update(n_emit.tolist())
    assert len(outcomes) > 1, outcomes  # both rejections and acceptances

    # The spec ServingEngine delivers several tokens of one request per
    # tick (greedy: the paged engine's tokens); speculate_k needs paged=True
    # and a draft.
    with ServingEngine(params, tcfg, paged=True, slots=2, block_size=4, prefill_chunk=8,
                       min_bucket=8, speculate_k=3, draft_spec=DraftSpec(truncate_layers=1),
                       fused_sampling=True, device="cpu") as serving:
        results = serving.run_batch(paged_prompts, max_new_tokens=6, temperature=0.0)
        assert serving.spec and serving.engine.spec_emitted > serving.engine.spec_target_steps
    assert [list(r.token_ids) for r in results] == paged_want[None, None]
    for kw, match in ((dict(paged=False, draft_spec=DraftSpec(truncate_layers=1)), "paged=True"),
                      (dict(paged=True), "draft_spec")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(params, tcfg, speculate_k=2, device="cpu", **kw)

    # filter_logits: identical masks to the JAX package on shared logits,
    # with tied values at the top-k boundary and every knob combination.
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 50)).astype(np.float32) * 3
    logits[1, :4] = logits[1].max() + 1.0  # a four-way tie at the top
    logits[2, 10:13] = np.sort(logits[2])[-11]  # three-way tie at the 11th value
    temps = np.array([1.0, 0.7, 1.3, 0.0, 2.0, 1.0], np.float32)
    top_ks = np.array([0, 2, 11, 5, 0, 50], np.int32)
    top_ps = np.array([2.0, 0.9, 2.0, 0.3, 0.05, 0.5], np.float32)
    want = np.asarray(jax_filter_logits(*map(jnp.asarray, (logits, temps, top_ks, top_ps))))
    got = filter_logits(*map(torch.as_tensor, (logits, temps, top_ks, top_ps))).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    assert keep.sum(axis=1).tolist()[:3] == [50, 4, 13]  # ties are kept
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)

    # The two-matrix FFNs (silu, and gelu through the GeLU kernel's
    # wrapper): the JAX dense and paged engines' greedy tokens, the paged
    # ones at act width and at int8 KV + int8 weights, with the serving
    # weight gauges equal to JAX's (both count the unread w3, quantized
    # under int8); the speculative engine, whose truncated draft is itself a
    # silu or gelu model, gives the same greedy tokens.
    for ffn_type in ("silu", "gelu"):
        jcfg = dataclasses.replace(paged_cfg, ffn_type=ffn_type)
        fcfg = ModelConfig.from_dict(dataclasses.asdict(jcfg))
        j_params = jax.tree_util.tree_map(
            lambda a: a * 8, jax_init_params(jax.random.PRNGKey(0), jcfg)
        )
        f_params = params_from_jax(jax.device_get(j_params), device="cpu")
        want = _drive(JaxSlotPoolEngine(j_params, jcfg, slots=2, min_bucket=8),
                      paged_prompts[:4], 6)
        assert _drive(SlotPoolEngine(f_params, fcfg, slots=2, min_bucket=8, device="cpu"),
                      paged_prompts[:4], 6) == want, ffn_type
        for kv_dtype, weight_dtype in ((None, None), ("int8", "int8")):
            jax_paged = JaxPagedEngine(j_params, jcfg, kv_dtype=kv_dtype,
                                       weight_dtype=weight_dtype, **knobs)
            want_paged = _drive(jax_paged, paged_prompts[:4], 6)
            paged = PagedEngine(f_params, fcfg, kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                                device="cpu", **knobs)
            assert _drive(paged, paged_prompts[:4], 6) == want_paged, (ffn_type, kv_dtype)
            if kv_dtype is None:
                assert want_paged == want
            _, _, label, params_bytes, tick_bytes = jax_prepare_serving_weights(
                j_params, jcfg, weight_dtype
            )
            assert (paged.weight_dtype, paged.params_bytes, paged.tick_weight_bytes) == (
                label, params_bytes, tick_bytes), (ffn_type, weight_dtype)
        spec = SpecEngine(f_params, fcfg, draft=DraftSpec(truncate_layers=1), speculate_k=3,
                          device="cpu", **knobs)
        assert spec.draft.config.ffn_type == ffn_type
        assert _drive(spec, paged_prompts[:4], 6) == want, ffn_type

    _check_moe_matches_jax(paged_cfg, paged_prompts, knobs, tmp_path)

    # The serving surface: the regex-free host tokenizer, the HTTP server and
    # its telemetry, and the CLIs, each against the JAX package's.
    _check_tokenizer_matches_jax(tmp_path)
    _check_http_server_matches_jax(jax_params, params, cfg, prompts, tmp_path)
    _check_cli_matches_jax(jax_params, tmp_path)

    # The serving fleet: KV migration and its wire format, roles,
    # evacuation, the router, the controller and the fleet tools.
    _check_migration_matches_jax(jax_params, params)
    _check_fleet_matches_jax(jax_params, params)


def _check_moe_matches_jax(paged_cfg, paged_prompts, knobs, tmp_path):
    """The MoE FFN (4 experts, top-2, gather, capacity factor 1: the 32-token
    prefill bucket drops assignments, decode steps drop none) served by the
    dense, paged (act and int8 KV) and speculative engines with the JAX
    engines' greedy tokens, the weight gauges (3-D expert stacks) equal to
    JAX's, int8 weights refused with JAX's message; and the CLIs on a
    JAX-written MoE checkpoint: ``generate`` gives JAX's ``generate_ids``
    and ``serve --weight-dtype int8`` exits 2 in both packages."""
    import pickle

    from bpe_transformer_tpu.checkpointing import save_checkpoint as jax_save_checkpoint
    from bpe_transformer_tpu.training import cli as jax_cli
    from bpe_transformer_tpu.training.sampling import generate_ids as jax_generate_ids
    from bpe_transformer_tpu_torch.training import cli as port_cli

    jcfg = dataclasses.replace(paged_cfg, ffn_type="moe", n_experts=4, router_top_k=2,
                               capacity_factor=1.0, moe_dispatch="gather")
    cfg = ModelConfig.from_dict(dataclasses.asdict(jcfg))
    j_params = jax.tree_util.tree_map(lambda a: a * 8, jax_init_params(jax.random.PRNGKey(1), jcfg))
    params = params_from_jax(jax.device_get(j_params), device="cpu")
    prompts = paged_prompts[:4]
    want = _drive(JaxSlotPoolEngine(j_params, jcfg, slots=2, min_bucket=8), prompts, 6)
    assert _drive(SlotPoolEngine(params, cfg, slots=2, min_bucket=8, device="cpu"),
                  prompts, 6) == want
    for kv_dtype in (None, "int8"):
        jax_paged = JaxPagedEngine(j_params, jcfg, kv_dtype=kv_dtype, **knobs)
        want_paged = _drive(jax_paged, prompts, 6)
        paged = PagedEngine(params, cfg, kv_dtype=kv_dtype, device="cpu", **knobs)
        assert _drive(paged, prompts, 6) == want_paged, kv_dtype
        _, _, label, params_bytes, tick_bytes = jax_prepare_serving_weights(j_params, jcfg, None)
        assert (paged.weight_dtype, paged.params_bytes, paged.tick_weight_bytes) == (
            label, params_bytes, tick_bytes), kv_dtype
    jax_spec = JaxSpecEngine(j_params, jcfg, draft=JaxDraftSpec(truncate_layers=1),
                             speculate_k=3, **knobs)
    spec = SpecEngine(params, cfg, draft=DraftSpec(truncate_layers=1), speculate_k=3,
                      device="cpu", **knobs)
    assert spec.draft.config.ffn_type == "moe"
    assert _drive(spec, prompts, 6) == _drive(jax_spec, prompts, 6)
    messages = []
    for make in (lambda: JaxPagedEngine(j_params, jcfg, weight_dtype="int8", **knobs),
                 lambda: PagedEngine(params, cfg, weight_dtype="int8", device="cpu", **knobs)):
        with pytest.raises(ValueError) as exc:
            make()
        messages.append(str(exc.value))
    assert messages[0] == messages[1] and "MoE" in messages[0], messages

    ckpt = tmp_path / "moe.ckpt"
    jax_save_checkpoint(ckpt, params=j_params, extra={"model_config": dataclasses.asdict(jcfg)})
    tok_dir = tmp_path / "moe_tok"
    tok_dir.mkdir()
    (tok_dir / "vocab.pkl").write_bytes(pickle.dumps({i: bytes([i]) for i in range(127)}))
    (tok_dir / "merges.pkl").write_bytes(pickle.dumps([]))
    common = ["--checkpoint", str(ckpt), "--tokenizer-dir", str(tok_dir),
              "--special-token", "<|eot|>"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(["generate", *common, "--prompt", "hello", "--max-new-tokens", "8",
                            "--temperature", "0", "--print-ids", "--device", "cpu"])
    want = jax_generate_ids(j_params, jcfg, [ord(c) for c in "hello"], max_new_tokens=8,
                            temperature=0.0, stop_id=127)
    assert rc == 0 and json.loads(out.getvalue())["token_ids"] == want, (out.getvalue(), want)
    for main, extra in ((port_cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["serve", *common, "--weight-dtype", "int8", *extra]) == 2, main


# ------------------------------------------------------------------------
# The serving surface: host tokenizer, HTTP server, telemetry and CLIs.

def _tokenizer_corpus() -> str:
    """A seeded corpus over the pre-tokenizer's hard cases: Latin, CJK,
    Devanagari, non-ASCII digits, contractions, mixed whitespace runs (with
    the \\x1c-\\x1f separators and U+0085, which ``str.isspace`` calls
    space and ``regex`` does not / does), emoji, and overlapping specials."""
    pieces = ["the", "The", "quick", "brown", "fox", "naïve", "café", "Σίσυφος", "中文",
              "日本語", "नमस्ते", "दुनिया", "٣٤٥", "४२", "Ⅻ", "½", "2026", "3.14", "don't",
              "we'll", "they've", "you're", "I'm", "it'd", "'S", "''", "😀", "👍🏽", "🇺🇳",
              "!!", "...", "--", "$", "@#", "\t", "\n", "\r\n", "  ", "   ", "\x0b", "\x0c",
              "\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", " ", "　", "​",
              "<|endoftext|>", "<|endoftext|><|endoftext|>", "<|end"]
    rng = np.random.default_rng(0)
    words = [pieces[i] for i in rng.integers(0, len(pieces), 3000)]
    seps = [" ", "", "  ", "\n"]
    return "".join(w + seps[i] for w, i in zip(words, rng.integers(0, len(seps), 3000)))


def _check_tokenizer_matches_jax(tmp_path):
    """The port's regex-free host tokenizer against the JAX package's: the
    class tables against ``regex`` itself, pre-tokens and special-token
    splits, a trained vocabulary and merge list, encode/decode, and the token
    file ``tokenize_to_memmap`` writes."""
    from bpe_transformer_tpu.data import tokenize_to_memmap as jax_tokenize_to_memmap
    from bpe_transformer_tpu.native.gen_unicode_tables import _class_ranges
    from bpe_transformer_tpu.tokenization import BPETokenizer as JaxBPETokenizer
    from bpe_transformer_tpu.tokenization import BPETrainer as JaxBPETrainer
    from bpe_transformer_tpu.tokenization import pretokenize_text as jax_pretokenize_text
    from bpe_transformer_tpu.tokenization import (
        split_on_special_tokens as jax_split_on_special_tokens,
    )
    from bpe_transformer_tpu_torch.data import tokenize_to_memmap
    from bpe_transformer_tpu_torch.tokenization import (
        BPETokenizer,
        BPETrainer,
        pretokenize_text,
        split_on_special_tokens,
        unicode_classes,
    )

    for pattern, ranges in ((r"\p{L}", unicode_classes.LETTER_RANGES),
                            (r"\p{N}", unicode_classes.NUMBER_RANGES),
                            (r"\s", unicode_classes.SPACE_RANGES)):
        assert list(ranges) == _class_ranges(pattern), pattern

    corpus = _tokenizer_corpus()
    specials = ["<|endoftext|>", "<|endoftext|><|endoftext|>"]
    lines = corpus.split("\n")
    for text in lines + [corpus, "", " ", "  x", "a  \x1c\x1db", "it's'll", " \x85\x85"]:
        assert pretokenize_text(text) == jax_pretokenize_text(text), repr(text)
        for training in (True, False):
            assert split_on_special_tokens(text, specials, training=training) == (
                jax_split_on_special_tokens(text, specials, training=training)), repr(text)

    path = tmp_path / "corpus.txt"
    path.write_text(corpus, encoding="utf-8")
    want = JaxBPETrainer(vocab_size=600, special_tokens=specials[:1])
    want.train(path)
    got = BPETrainer(vocab_size=600, special_tokens=specials[:1])
    got.train(path, n_workers=1)
    assert got.vocab == want.vocab and got.merges == want.merges
    assert len(got.merges) > 250
    tok = BPETokenizer(dict(got.vocab), got.merges, specials)
    jax_tok = JaxBPETokenizer(dict(want.vocab), want.merges, specials)
    ids = tok.encode(corpus)
    assert ids == jax_tok.encode(corpus)
    assert tok.decode(ids) == jax_tok.decode(ids) == corpus
    assert tok.decode([5000, ids[0]]) == jax_tok.decode([5000, ids[0]])
    tokenize_to_memmap(tok, path, tmp_path / "port.bin")
    jax_tokenize_to_memmap(jax_tok, path, tmp_path / "jax.bin")
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    assert "regex" not in {m.split(".")[0] for m in sys.modules
                           if m.startswith("bpe_transformer_tpu_torch")}
    _check_native_engine_matches_jax(tmp_path, corpus, lines, specials, want)


def _check_native_engine_matches_jax(tmp_path, corpus, lines, specials, jax_trainer):
    """The port's native (C++) engine against the JAX package's and against
    the port's own Python path on the seeded hard-case corpus, all exact:
    pre-token offsets, the streaming counter's items, the merge loop's
    merges, the fused encoder's ids, a trainer run and ``count_pretokens``
    through each engine; the ``.inc`` regenerated from the port's tables
    byte-equal to the committed one and to the JAX package's; a pickled
    tokenizer (the ``encode_iterable`` workers' copy) encoding after
    unpickling; ``BT_NATIVE=0`` and ``engine="native"`` behaving as in the
    JAX package."""
    import collections
    import pickle
    from unittest import mock

    from bpe_transformer_tpu.native import engine as jax_native
    from bpe_transformer_tpu.tokenization import count_pretokens as jax_count_pretokens
    from bpe_transformer_tpu_torch.native import engine as native
    from bpe_transformer_tpu_torch.native import gen_unicode_tables
    from bpe_transformer_tpu_torch.tokenization import (
        BPETokenizer,
        BPETrainer,
        count_pretokens,
        iter_pretoken_strings,
    )

    inc = gen_unicode_tables.OUT
    assert gen_unicode_tables.render().encode() == inc.read_bytes() == (
        Path(jax_native.__file__).parent / "src" / "unicode_classes.inc").read_bytes()
    assert native.is_available() == jax_native.is_available(), native.unavailable_reason()
    path = tmp_path / "corpus.txt"
    if native.is_available():
        for text in lines + [corpus, "", " ", "a  \x1c\x1db", " \x85\x85"]:
            offsets = native.pretokenize_offsets(text)
            assert offsets == jax_native.pretokenize_offsets(text), repr(text)
            data = text.encode("utf-8")
            assert [data[a:b].decode("utf-8") for a, b in offsets] == list(
                iter_pretoken_strings(text)), repr(text)
        counters = [native.NativePretokenCounter(), jax_native.NativePretokenCounter()]
        python_counts = collections.Counter()
        for line in lines:
            for counter in counters:
                counter.add(line)
            python_counts.update(p.encode("utf-8") for p in iter_pretoken_strings(line))
        items = [sorted(c.items()) for c in counters]
        assert items[0] == items[1] == sorted(python_counts.items())
        words = [tuple(w) for w, n in items[0] if len(w) > 1]
        counts = [n for w, n in items[0] if len(w) > 1]
        base = [bytes([i]) for i in range(256)]
        merges = native.train_bpe_merges(words, counts, base, 500)
        assert merges == jax_native.train_bpe_merges(words, counts, base, 500)
        assert merges == counters[0].train_bpe(base, 500) and len(merges) > 100
        for engine in ("native", "python"):
            trainer = BPETrainer(vocab_size=600, special_tokens=specials[:1])
            if engine == "native":
                # Required to run: a silent fallback would test Python twice.
                assert trainer._train_native_file(path) is True
            else:
                with mock.patch.dict(os.environ, {"BT_NATIVE": "0"}):
                    trainer.train(path, n_workers=1)
            assert trainer.vocab == jax_trainer.vocab and trainer.merges == jax_trainer.merges
            assert count_pretokens(path, specials[:1], n_workers=1, engine=engine) == (
                jax_count_pretokens(path, specials[:1], n_workers=1, engine=engine)), engine
        tok = BPETokenizer(dict(jax_trainer.vocab), jax_trainer.merges, specials)
        encoder = tok._native_encoder()
        jax_encoder = jax_native.NativeBPEEncoder(tok._byte_id, tok._pair_rank)
        python_tok = pickle.loads(pickle.dumps(tok))
        assert python_tok._native is None
        python_tok._native_tried = True  # the pure-Python path
        for text in lines + [corpus]:
            text = text.replace("<|endoftext|>", "")  # encode_part takes specials-free text
            ids = encoder.encode_part(text)
            assert ids == jax_encoder.encode_part(text) == python_tok.encode(text), repr(text)
        unpickled = pickle.loads(pickle.dumps(tok))
        assert unpickled.encode(corpus) == tok.encode(corpus) == python_tok.encode(corpus)
        assert unpickled._native is not None

    # BT_NATIVE=0 turns the engine off in both packages, from the next load.
    saved = [(m, m._lib, m._load_failed) for m in (native, jax_native)]
    try:
        with mock.patch.dict(os.environ, {"BT_NATIVE": "0"}):
            for m in (native, jax_native):
                m._lib, m._load_failed = None, None
            assert not native.is_available() and not jax_native.is_available()
            assert native.unavailable_reason() == jax_native.unavailable_reason()
            errors = []
            for fn in (count_pretokens, jax_count_pretokens):
                with pytest.raises(RuntimeError) as info:
                    fn(path, specials[:1], n_workers=1, engine="native")
                errors.append(str(info.value))
            assert errors[0] == errors[1] == "native engine unavailable: disabled via BT_NATIVE=0"
            assert count_pretokens(path, specials[:1], n_workers=1) == (
                jax_count_pretokens(path, specials[:1], n_workers=1))
            assert BPETokenizer(dict(jax_trainer.vocab), jax_trainer.merges)._native_encoder() is None
            trainer = BPETrainer(vocab_size=600, special_tokens=specials[:1])
            trainer.train(path, n_workers=1)
            assert trainer.merges == jax_trainer.merges
        for fn in (count_pretokens, jax_count_pretokens):
            with pytest.raises(ValueError, match="unknown engine"):
                fn(path, specials[:1], engine="rust")
    finally:
        for m, lib, failed in saved:
            m._lib, m._load_failed = lib, failed


def _byte_tokenizers():
    """The JAX package's and the port's tokenizer over plain ASCII bytes and
    one special stop token (id 127, the model's last)."""
    from bpe_transformer_tpu.tokenization import BPETokenizer as JaxBPETokenizer
    from bpe_transformer_tpu_torch.tokenization import BPETokenizer

    return tuple(cls(vocab={i: bytes([i]) for i in range(127)}, merges=[],
                     special_tokens=["<|eot|>"]) for cls in (JaxBPETokenizer, BPETokenizer))


def _http(url, payload=None, request_id=None, timeout=60.0):
    """``(status, headers, body)`` of a GET (``payload`` None) or a JSON
    POST; HTTP errors are returned, not raised."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if request_id is not None:
        headers["X-Request-Id"] = request_id
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data, headers=headers),
                                    timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read().decode()


@contextlib.contextmanager
def _http_server(make_server, serving):
    server = make_server(serving, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _prom_families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _check_http_server_matches_jax(jax_params, params, cfg, prompts, tmp_path):
    """The port's ServingEngine + make_http_server against the JAX
    package's on the same weights and byte tokenizer: greedy /generate ids
    and completions, stop_id, 400/503 paths with X-Request-Id echoed, the
    /healthz and /statusz keys and /metrics families (the serving fleet's
    included), drain, offline batch files, and the telemetry stream."""
    from bpe_transformer_tpu.serving import Request as JaxRequest
    from bpe_transformer_tpu.serving import ServingEngine as JaxServingEngine
    from bpe_transformer_tpu.serving import make_http_server as jax_make_http_server
    from bpe_transformer_tpu_torch.serving.server import DuplicateRequestError, make_http_server
    from bpe_transformer_tpu_torch.telemetry import Telemetry, validate_record

    jax_tok, tok = _byte_tokenizers()
    records = []
    sides = (
        ("jax", lambda **kw: JaxServingEngine(jax_params, JAX_CFG, tokenizer=jax_tok, **kw),
         jax_make_http_server, JaxRequest),
        ("port", lambda **kw: ServingEngine(params, cfg, tokenizer=tok, device="cpu", **kw),
         make_http_server, Request),
    )
    seen = {}
    for side, build, make_server, request_cls in sides:
        telemetry = Telemetry(sink=records.append) if side == "port" else None
        out = seen[side] = {}
        with build(slots=2, min_bucket=8, default_max_new_tokens=5, telemetry=telemetry,
                   engine_record_every_s=0.0) as serving, \
                _http_server(make_server, serving) as base:
            for i, text in enumerate(("ab cd", "hello, world", "x")):
                code, headers, body = _http(f"{base}/generate",
                                            {"prompt": text, "temperature": 0.0,
                                             "max_new_tokens": 6}, request_id=f"g{i}")
                assert code == 200 and headers["X-Request-Id"] == f"g{i}", (side, body)
                body = json.loads(body)
                out[text] = (body["token_ids"], body["completion"], body["finish_reason"])
                assert body["request_id"] == f"g{i}"
            ids = out["ab cd"][0]
            code, _, body = _http(f"{base}/generate", {"prompt": "ab cd", "temperature": 0.0,
                                                       "max_new_tokens": 6, "stop_id": ids[2]})
            body = json.loads(body)
            out["stop"] = (body["token_ids"], body["completion"], body["finish_reason"])
            assert body["finish_reason"] == "stop" and body["token_ids"] == ids[:3]
            for bad in ({"bogus": 1}, {"prompt_ids": []}, {"prompt": "a", "seed": "x"}):
                code, headers, body = _http(f"{base}/generate", bad, request_id="bad")
                assert code == 400 and headers["X-Request-Id"] == "bad", (side, bad, body)
            for path in ("/healthz", "/statusz", "/debug/flightrecorder"):
                code, _, body = _http(base + path)
                assert code == 200, (side, path)
                out[path] = json.loads(body)
            assert _http(base + "/debug/dump", {})[0] == 200
            out["/metrics"] = _http(base + "/metrics")[2]
            if side == "port":
                # drain: queued and in-flight work finishes, new work is
                # refused (503 over HTTP).
                handles = [serving.submit(Request(prompt_ids=tuple(p), max_new_tokens=6,
                                                  temperature=0.0)) for p in prompts[:3]]
                assert serving.drain(timeout_s=60.0)
                assert all(h.result(timeout=5).finish_reason == "length" for h in handles)
                code, headers, _ = _http(f"{base}/generate", {"prompt": "ab"}, request_id="late")
                assert code == 503 and headers["X-Request-Id"] == "late"
                with pytest.raises(RuntimeError, match="draining"):
                    serving.submit(Request(prompt_ids=(1, 2), max_new_tokens=2))

        # 503 on a full queue and on an id already in flight: an engine whose
        # worker never runs keeps what it queued.
        serving = build(slots=1, min_bucket=8, max_queue=1)
        serving._running = True
        with _http_server(make_server, serving) as base:
            serving.submit(request_cls(prompt_ids=(1, 2), max_new_tokens=2, request_id="dup"))
            for rid in ("dup", "full"):
                code, headers, body = _http(f"{base}/generate", {"prompt": "ab"},
                                            request_id=rid)
                assert code == 503 and headers["X-Request-Id"] == rid, (side, rid, body)
        serving._running = False
        serving.close()

        # Offline batch file mode.
        prompts_path = tmp_path / "prompts.txt"
        prompts_path.write_text("ab\ncdef\n\nxy\n", encoding="utf-8")
        with build(slots=2, min_bucket=8) as serving:
            serving.serve_batch_file(prompts_path, tmp_path / f"{side}.jsonl",
                                     max_new_tokens=4, temperature=0.0)
        out["batch"] = [
            {k: v for k, v in json.loads(line).items() if not k.endswith("_s")}
            for line in (tmp_path / f"{side}.jsonl").read_text().splitlines()
        ]

    jax_out, port_out = seen["jax"], seen["port"]
    for key in ("ab cd", "hello, world", "x", "stop", "batch"):
        assert port_out[key] == jax_out[key], key
    for path in ("/healthz", "/statusz"):
        assert set(port_out[path]) == set(jax_out[path]), path
    assert set(port_out["/debug/flightrecorder"]) == set(jax_out["/debug/flightrecorder"])
    assert _prom_families(port_out["/metrics"]) == _prom_families(jax_out["/metrics"])
    assert issubclass(DuplicateRequestError, ValueError)

    # The telemetry stream: schema-valid spans, engine/resources/roofline
    # records and a clean footer, which the JAX package's report renders.
    from bpe_transformer_tpu.telemetry.report import render_report

    assert all(not validate_record(r) for r in records), [
        (r.get("kind"), validate_record(r)) for r in records if validate_record(r)]
    kinds = {r.get("kind") for r in records}
    assert {"span", "engine", "resources", "roofline", "footer"} <= kinds, kinds
    assert {r["path"] for r in records if r.get("kind") == "span"} >= {
        "serve/queue_wait", "serve/prefill", "serve/decode"}
    assert records[-1]["kind"] == "footer" and records[-1]["clean"] is True
    report = render_report(records)
    assert "== serving ==" in report and "queue_wait" in report


def _check_cli_matches_jax(jax_params, tmp_path):
    """The port's CLIs on a checkpoint the JAX package wrote: ``serve`` as a
    subprocess (banner, /generate, /metrics, /statusz, drain on SIGINT, a
    kill timer), its JSONL rendered by the JAX package's own ``report`` and
    ``monitor``; ``generate`` against JAX's ``generate_ids``; ``eval``
    against JAX's ``cmd_eval``; ``--device`` and the rc-2 flag checks."""
    import pickle
    import signal
    import subprocess

    from bpe_transformer_tpu.checkpointing import save_checkpoint as jax_save_checkpoint
    from bpe_transformer_tpu.telemetry import monitor as jax_monitor
    from bpe_transformer_tpu.telemetry import report as jax_report
    from bpe_transformer_tpu.training import cli as jax_cli
    from bpe_transformer_tpu.training.sampling import generate_ids as jax_generate_ids
    from bpe_transformer_tpu_torch.training import cli as port_cli

    ckpt = tmp_path / "model.ckpt"
    jax_save_checkpoint(ckpt, params=jax_params,
                        extra={"model_config": dataclasses.asdict(JAX_CFG)})
    tok_dir = tmp_path / "tok"
    tok_dir.mkdir()
    with open(tok_dir / "vocab.pkl", "wb") as f:
        pickle.dump({i: bytes([i]) for i in range(127)}, f)
    with open(tok_dir / "merges.pkl", "wb") as f:
        pickle.dump([], f)
    common = ["--checkpoint", str(ckpt), "--tokenizer-dir", str(tok_dir),
              "--special-token", "<|eot|>"]

    def run_cli(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        return rc, out.getvalue()

    metrics = tmp_path / "serve.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "bpe_transformer_tpu_torch.training.cli", "serve", *common,
         "--port", "0", "--slots", "2", "--max-new-tokens", "6", "--metrics-jsonl",
         str(metrics), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    killer = threading.Timer(240, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (line, proc.stderr.read()[-3000:])
        base = line.split()[2]
        code, _, body = _http(f"{base}/generate", {"prompt": "ab", "temperature": 0.0},
                              timeout=120)
        assert code == 200 and len(json.loads(body)["token_ids"]) >= 1, body
        prom = _http(f"{base}/metrics")[2]
        assert "bpe_tpu_requests_submitted_total 1" in prom
        statusz = json.loads(_http(f"{base}/statusz")[2])
        assert statusz["manifest"]["run_kind"] == "serve"
        assert statusz["manifest"]["devices"]["platform"] == "cpu"
        assert statusz["compiled_programs"] == 0  # no kernel library on the CPU
        assert statusz["resources"]["kernel_launches"] == {}  # plain versions count none
    finally:
        killer.cancel()
        proc.send_signal(signal.SIGINT)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate(timeout=10)
    assert proc.returncode == 0 and "drained cleanly" in out, (out, err[-3000:])

    rc, report = run_cli(jax_report.main, [str(metrics)])
    assert rc == 0 and "kind=serve" in report and "== serving ==" in report, report
    for phase in ("serve/queue_wait", "serve/prefill", "serve/decode"):
        assert phase in report, report
    assert "clean footer" in report
    rc, frame = run_cli(jax_monitor.main, [str(metrics), "--once", "--plain"])
    assert rc == 0 and "serve on 1xcpu" in frame, frame

    # generate: the JAX package's greedy ids for the same prompt.
    rc, out = run_cli(port_cli.main, ["generate", *common, "--prompt", "hello", "--max-new-tokens",
                                      "8", "--temperature", "0", "--print-ids", "--device",
                                      "cpu"])
    got = json.loads(out)
    want = jax_generate_ids(jax_params, JAX_CFG, [ord(c) for c in "hello"], max_new_tokens=8,
                            temperature=0.0, stop_id=127)
    assert rc == 0 and got["token_ids"] == want, (got, want)

    # eval: JAX's cmd_eval loss on the same token file and batches.
    tokens = np.random.default_rng(3).integers(0, 128, 400).astype(np.uint16)
    tokens.tofile(tmp_path / "val.bin")
    argv = ["eval", "--checkpoint", str(ckpt), "--data", str(tmp_path / "val.bin"),
            "--batches", "2", "--batch-size", "2"]
    rc, out = run_cli(port_cli.main, argv + ["--device", "cpu"])
    jax_rc, jax_out = run_cli(jax_cli.main, argv)
    assert rc == jax_rc == 0
    got, want = json.loads(out)["val_loss"], json.loads(jax_out)["val_loss"]
    assert np.isfinite(got) and abs(got - want) <= 1e-5, (got, want)

    # Flag combinations refused before anything loads (rc 2).
    for extra in (["--kv-dtype", "int8"], ["--speculate", "2"], ["--draft-config", "d.json"],
                  ["--speculate", "2", "--paged"], ["--prompts-file", "p.txt"],
                  ["--decode-attention", "paged"], ["--role", "decode"], ["--role", "prefill"],
                  ["--evacuate-to", "127.0.0.1:9"],
                  ["--paged", "--role", "prefill", "--prompts-file", "p.txt", "--output", "o"]):
        rc, _ = run_cli(port_cli.main, ["serve", *common, "--device", "cpu", *extra])
        assert rc == 2, extra
        if extra[0] in ("--role", "--evacuate-to", "--paged"):
            assert run_cli(jax_cli.main, ["serve", *common, *extra])[0] == 2, extra


# ------------------------------------------------------------------------
# The serving fleet: KV migration (wire v2), roles, evacuation, the router
# and the fleet tools.


def _drive_migrating(src, dst, prompts, knobs, max_new_tokens, plan, ship):
    """Serve ``prompts`` on ``src`` (all admitted at once, ``knobs[i]`` each)
    and move the ones ``plan`` names to ``dst``: an int after that many
    tokens, ``"prefill"`` after the first prefill chunk.  ``ship`` carries
    an exported payload to ``dst`` (bytes and back).  Works on either
    package's engines; returns every prompt's tokens."""
    outs = {i: [] for i in range(len(prompts))}
    owner = {}
    for i, prompt in enumerate(prompts):
        owner[(0, src.begin(prompt, max_new_tokens=max_new_tokens, **knobs[i]))] = i
    moved = set()

    def migrate(slot, i):
        payload = src.export_slot(slot, {"history": list(prompts[i]) + outs[i],
                                         "emitted": list(outs[i])})
        src.release(slot)
        del owner[(0, slot)]
        owner[(1, dst.import_slot(ship(payload)))] = i
        moved.add(i)

    engines = (src,) if dst is None else (src, dst)
    while owner:
        for side, eng in enumerate(engines):
            for slot in list(eng.pending_prefills()):
                i = owner[(side, slot)]
                event = eng.prefill_step(slot)
                if event is None:
                    if side == 0 and plan.get(i) == "prefill" and i not in moved:
                        migrate(slot, i)
                    continue
                outs[i].append(int(event.token))
                if event.finished:
                    del owner[(side, slot)]
            for event in eng.tick():
                i = owner[(side, event.slot)]
                outs[i].append(int(event.token))
                if event.finished:
                    del owner[(side, event.slot)]
        for (side, slot), i in list(owner.items()):
            at = plan.get(i)
            if (side == 0 and isinstance(at, int) and i not in moved and len(outs[i]) >= at
                    and src._active[slot]):
                migrate(slot, i)
    assert moved == set(plan), (sorted(plan), sorted(moved))
    return [outs[i] for i in range(len(prompts))]


def _check_migration_matches_jax(jax_params, params):
    """KV migration against the JAX package's: the wire frames byte for
    byte (float32, int8 with scales, bfloat16; v1 frames; flipped and
    truncated bodies refused; codec negotiation); port -> port migration
    mid-decode and mid-prefill token-identical to the unmigrated run,
    greedy and seeded sampled, act and int8 KV; a port payload grafted into
    a JAX ``PagedEngine`` and a JAX payload into the port's (and a port
    ``SpecEngine`` payload into a JAX ``SpecEngine``) with JAX's unmigrated
    greedy ids; export leaving shared radix blocks, refcounts and the pool
    untouched; every malformed payload refused by both packages."""
    import ml_dtypes

    from bpe_transformer_tpu.serving.kvpool import migrate as jax_migrate
    from bpe_transformer_tpu_torch.serving.kvpool import migrate

    # Wire frames: the same payload gives the same bytes in both packages
    # and decodes to the same arrays.
    rng = np.random.default_rng(12)
    values = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    bf16 = values.astype(ml_dtypes.bfloat16)
    meta = {"format": 1, "num_layers": 2, "note": "é", "x": 0.1}
    cases = {
        "float32": ([{"k": values, "v": values * 2} for _ in range(2)],) * 2,
        "int8": ([{"k": (values * 20).astype(np.int8), "v": (values * 9).astype(np.int8),
                   "k_scale": values[:, :, 0, 0], "v_scale": values[:, :, 1, 0]}
                  for _ in range(2)],) * 2,
        "bfloat16": ([{"k": bf16, "v": bf16} for _ in range(2)],
                     [{"k": migrate.bf16_bits(bf16.view(np.uint16)),
                       "v": migrate.bf16_bits(bf16.view(np.uint16))} for _ in range(2)]),
    }
    codecs = ("raw", "zlib") + (("zstd",) if migrate.HAVE_ZSTD else ())
    assert jax_migrate.HAVE_ZSTD == migrate.HAVE_ZSTD
    for name, (jax_layers, port_layers) in cases.items():
        for codec in codecs:
            frame = jax_migrate.payload_to_bytes({"meta": meta, "layers": jax_layers},
                                                 codec=codec)
            assert migrate.payload_to_bytes({"meta": meta, "layers": port_layers},
                                            codec=codec) == frame, (name, codec)
            got = migrate.payload_from_bytes(frame)
            assert got["meta"] == meta and migrate.payload_nbytes(got) == (
                jax_migrate.payload_nbytes({"meta": meta, "layers": jax_layers}))
            for layer, want in zip(got["layers"], jax_layers):
                for key, arr in want.items():
                    assert migrate.wire_dtype(layer[key]) == str(arr.dtype), (name, key)
                    assert layer[key].tobytes() == np.ascontiguousarray(arr).tobytes()
            assert migrate.payload_to_bytes(got, codec=codec) == frame
            # A flipped byte in the array section or a cut body: refused.
            flipped = bytearray(frame)
            flipped[len(frame) * 3 // 4] ^= 0xFF
            for bad in (bytes(flipped), frame[: len(frame) // 2], b"BPEKV009" + frame[8:],
                        b"nonsense"):
                for decode in (jax_migrate.payload_from_bytes, migrate.payload_from_bytes):
                    with pytest.raises(ValueError):
                        decode(bad)
        # Version-1 frames (no CRC, no codec) still decode.
        header = json.dumps({"meta": meta, "arrays": [
            {"key": f"L{i}/{k}", "dtype": str(a.dtype), "shape": list(a.shape)}
            for i, layer in enumerate(jax_layers) for k, a in sorted(layer.items())]}).encode()
        v1 = b"".join([jax_migrate.PAYLOAD_MAGIC_V1, len(header).to_bytes(8, "little"),
                       header] + [np.ascontiguousarray(a).tobytes()
                                  for layer in jax_layers for _, a in sorted(layer.items())])
        a, b = jax_migrate.payload_from_bytes(v1), migrate.payload_from_bytes(v1)
        assert [{k: v.tobytes() for k, v in la.items()} for la in a["layers"]] == [
            {k: v.tobytes() for k, v in lb.items()} for lb in b["layers"]]
    for accept in (None, "", "raw", "zlib", "zstd", "zstd,zlib", " ZLIB , raw", "gzip",
                   "br,zlib,zstd", "raw,zstd"):
        assert migrate.negotiate_codec(accept) == jax_migrate.negotiate_codec(accept), accept
    assert migrate.supported_codecs() == jax_migrate.supported_codecs()
    synth = migrate.synthetic_decode_payload(JAX_CFG, block_size=4, kv_dtype="bfloat16")
    assert migrate.payload_to_bytes(synth) == jax_migrate.payload_to_bytes(
        jax_migrate.synthetic_decode_payload(JAX_CFG, block_size=4, kv_dtype="bfloat16"))

    def port_wire(payload):
        return migrate.payload_from_bytes(migrate.payload_to_bytes(payload, codec="zlib"))

    def port_to_jax(payload):
        return jax_migrate.payload_from_bytes(migrate.payload_to_bytes(payload, codec="zlib"))

    def jax_to_port(payload):
        return migrate.payload_from_bytes(jax_migrate.payload_to_bytes(payload, codec="zlib"))

    # Engines: five requests at once, migrated mid-decode and mid-prefill
    # (chunks of 8, blocks of 4).
    paged_cfg = dataclasses.replace(JAX_CFG, decode_attention_impl="paged")
    tcfg = ModelConfig.from_dict(dataclasses.asdict(paged_cfg))
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)] for n in (5, 12, 19, 26, 9)]
    sampled = [dict(temperature=0.0), dict(temperature=0.9, top_k=20, seed=3),
               dict(temperature=0.8, top_p=0.9, seed=7), dict(temperature=0.0),
               dict(temperature=1.0, seed=11)]
    greedy = [dict(temperature=0.0)] * 5
    plan = {0: 3, 1: "prefill", 2: 2, 3: "prefill", 4: 4}
    knobs = dict(slots=5, block_size=4, prefill_chunk=8, min_bucket=8)
    for kv_dtype in (None, "int8"):
        def port(cls=PagedEngine, **kw):
            return cls(params, tcfg, kv_dtype=kv_dtype, device="cpu", **knobs, **kw)

        def jax_engine(cls=JaxPagedEngine, **kw):
            return cls(jax_params, paged_cfg, kv_dtype=kv_dtype, **knobs, **kw)

        for knob_set in (sampled, greedy):
            want = _drive_migrating(port(), None, prompts, knob_set, 6, {}, None)
            got = _drive_migrating(port(), port(), prompts, knob_set, 6, plan, port_wire)
            assert got == want, (kv_dtype, knob_set is sampled)
        jax_want = _drive_migrating(jax_engine(), None, prompts, greedy, 6, {}, None)
        assert jax_want == want, kv_dtype  # the port's greedy ids are JAX's
        assert _drive_migrating(port(), jax_engine(), prompts, greedy, 6, plan,
                                port_to_jax) == jax_want, kv_dtype
        assert _drive_migrating(jax_engine(), port(), prompts, greedy, 6, plan,
                                jax_to_port) == jax_want, kv_dtype
        spec_kw = dict(draft=DraftSpec(truncate_layers=1), speculate_k=3)
        jax_spec_kw = dict(draft=JaxDraftSpec(truncate_layers=1), speculate_k=3)
        spec_plan = {0: 3, 1: "prefill", 3: 2}
        # (Under int8 KV a speculative run's rejected writes stay in their
        # blocks' scales, so its ids are its own, not the paged engine's.)
        spec_want = _drive_migrating(port(SpecEngine, **spec_kw), None, prompts, greedy, 6,
                                     {}, None)
        assert _drive_migrating(port(SpecEngine, **spec_kw), port(SpecEngine, **spec_kw),
                                prompts, greedy, 6, spec_plan, port_wire) == spec_want
        assert _drive_migrating(port(SpecEngine, **spec_kw),
                                jax_engine(JaxSpecEngine, **jax_spec_kw), prompts, greedy, 6,
                                spec_plan, port_to_jax) == spec_want

    # Export reads and never writes: a slot holding radix-shared blocks
    # leaves the pool, the refcounts and the radix index as they were.
    eng = PagedEngine(params, tcfg, kv_dtype="int8", device="cpu", **knobs)
    shared = prompts[3][:12]
    eng.admit(shared + [1, 2], max_new_tokens=4, temperature=0.0)
    event = eng.admit(shared + [3], max_new_tokens=4, temperature=0.0)
    assert eng.slot_shared_len(event.slot) == 12
    eng.tick()
    pool = [{k: v.clone() for k, v in layer.items()} for layer in eng._pool]
    refs = [eng.allocator.refcount(b) for b in range(eng.allocator.num_blocks)]
    radix = eng.prefix_cache.gauges()
    payload = eng.export_slot(event.slot)
    assert payload["meta"]["n_blocks"] == 4 and payload["meta"]["torch_rng"]["device_type"] == "cpu"
    assert [eng.allocator.refcount(b) for b in range(eng.allocator.num_blocks)] == refs
    assert eng.prefix_cache.gauges() == radix
    assert all(torch.equal(a, layer[k]) for layer, old in zip(eng._pool, pool)
               for k, a in old.items())

    # Malformed payloads: refused by both packages' validation.
    eng = PagedEngine(params, tcfg, device="cpu", **knobs)
    jax_eng = JaxPagedEngine(jax_params, paged_cfg, **knobs)
    event = eng.admit(prompts[2], max_new_tokens=4, temperature=0.0)
    good = eng.export_slot(event.slot)
    jax_eng.validate_import_payload(good)
    eng.validate_import_payload(good)

    def variant(meta=None, layers=None):
        return {"meta": {**good["meta"], **(meta or {})},
                "layers": good["layers"] if layers is None else layers}

    n = good["meta"]["n_blocks"]
    bad_payloads = [variant(meta=m) for m in (
        {"format": 2}, {"block_size": 8}, {"kv_dtype": "bfloat16"}, {"num_layers": 4},
        {"kv_heads": 4}, {"d_head": 8}, {"context_length": 64}, {"n_blocks": 99},
        {"decoding": False, "next_pos": 5})] + [
        variant(layers=good["layers"][:1]),
        variant(layers=[{"k": layer["k"]} for layer in good["layers"]]),
        variant(layers=[{k: a[: n - 1] for k, a in layer.items()} for layer in good["layers"]]),
        variant(layers=[{k: a.astype(np.float64) for k, a in layer.items()}
                        for layer in good["layers"]]),
    ]
    for bad in bad_payloads:
        for engine in (eng, jax_eng):
            with pytest.raises(ValueError):
                engine.validate_import_payload(bad)
    with pytest.raises(ValueError, match="history"):
        SpecEngine(params, tcfg, draft=DraftSpec(truncate_layers=1), speculate_k=2,
                   device="cpu", **knobs).import_slot(
            {"meta": {k: v for k, v in good["meta"].items() if k != "history"},
             "layers": good["layers"]})


def _check_fleet_matches_jax(jax_params, params):
    """The fleet over HTTP with in-process replicas on the CPU: port
    prefill and decode replicas behind the port's router and behind the
    JAX package's (ids equal to one replica's, seeded sampling included), a
    JAX prefill replica handing off to a port decode replica (greedy ids),
    drain evacuation in process and over the wire and ``/admin/evacuate``
    with no failed request, a ``BT_FAULTS`` corrupted payload answered 400
    and its clean retry under one idempotency key grafted once, the
    controller's decisions equal to JAX's on the same evidence, and the
    fleet aggregator's records schema-valid and rendered by JAX's
    ``report``."""
    from bpe_transformer_tpu.serving import ServingEngine as JaxServingEngine
    from bpe_transformer_tpu.serving import make_http_server as jax_make_http_server
    from bpe_transformer_tpu.serving.controller import FleetController as JaxFleetController
    from bpe_transformer_tpu.serving.router import Router as JaxRouter
    from bpe_transformer_tpu.serving.router import (
        make_router_http_server as jax_make_router_http_server,
    )
    from bpe_transformer_tpu.telemetry.report import render_report
    from bpe_transformer_tpu_torch.serving.controller import FleetController
    from bpe_transformer_tpu_torch.serving.router import Router, make_router_http_server
    from bpe_transformer_tpu_torch.serving.server import make_http_server
    from bpe_transformer_tpu_torch.telemetry import Telemetry, validate_record
    from bpe_transformer_tpu_torch.telemetry.fleet import FleetAggregator

    paged_cfg = dataclasses.replace(JAX_CFG, decode_attention_impl="paged")
    tcfg = ModelConfig.from_dict(dataclasses.asdict(paged_cfg))
    knobs = dict(slots=2, paged=True, block_size=4, prefill_chunk=8, min_bucket=8)

    def port(slow_ticks=False, **kw):
        serving = ServingEngine(params, tcfg, device="cpu", **knobs, **kw)
        if slow_ticks:  # keep sessions in flight long enough to move them
            tick = serving.engine.tick
            serving.engine.tick = lambda: (time.sleep(0.02), tick())[1]
        return serving

    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)] for n in (5, 12, 19, 26, 9, 14)]
    bodies = [dict(prompt_ids=p, max_new_tokens=5, temperature=0.0) if i % 2 == 0 else
              dict(prompt_ids=p, max_new_tokens=5, temperature=0.9, top_k=20, seed=i)
              for i, p in enumerate(prompts)]
    long_bodies = [dict(b, max_new_tokens=min(20, 31 - len(b["prompt_ids"]))) for b in bodies]
    with port() as mono:
        want = {k: [list(mono.generate(**b).token_ids) for b in group]
                for k, group in (("short", bodies), ("long", long_bodies))}

    def ids_through(base, group):
        with ThreadPoolExecutor(max_workers=len(group)) as pool:
            answers = list(pool.map(lambda b: _http(f"{base}/generate", b, timeout=120), group))
        assert all(code == 200 for code, _, _ in answers), answers
        return [json.loads(body)["token_ids"] for _, _, body in answers]

    # Port prefill + decode replicas behind the port's router and JAX's.
    with port(role="prefill") as pre, port(role="decode") as dec, \
            _http_server(make_http_server, pre) as pre_url, \
            _http_server(make_http_server, dec) as dec_url:
        for router_cls, make_router in ((Router, make_router_http_server),
                                        (JaxRouter, jax_make_router_http_server)):
            router = router_cls([pre_url, dec_url], prefill_threshold=10)
            router.poll_once()
            assert [r["role"] for r in router.statusz()["replicas"]] == ["prefill", "decode"]
            with _http_server(make_router, router) as router_url:
                assert ids_through(router_url, bodies) == want["short"], router_cls.__module__
            stat = router.statusz()
            assert stat["requests_failed"] == 0 and stat["requests_migrated"] == 4, stat
        assert pre.metrics.migrations_out == dec.metrics.migrations_in == 8
        assert pre.stats()["migration_bytes_out"] == dec.stats()["migration_bytes_in"] > 0
        code, _, body = _http(f"{pre_url}/generate", bodies[0])
        assert code == 503 and "prefill-role" in body

        # The fleet aggregator over them: schema-valid records that JAX's
        # report renders; the controller decides as JAX's on its evidence.
        records = []
        fleet = FleetAggregator([pre_url, dec_url], telemetry=Telemetry(sink=records.append))
        for _ in range(3):
            fleet.poll_once()
        assert records and all(not validate_record(r) for r in records), [
            validate_record(r) for r in records]
        assert {"fleet", "slo"} <= {r["kind"] for r in records}
        report = render_report(records)
        assert "== fleet" in report and "== slo" in report, report
        evidence = [{"fleet": fleet.statusz(), "router": router.statusz(), "errors": {}}]

    # A JAX prefill replica hands off to a port decode replica.
    with JaxServingEngine(jax_params, paged_cfg, role="prefill", **knobs) as jax_pre, \
            port(role="decode") as dec, \
            _http_server(jax_make_http_server, jax_pre) as pre_url, \
            _http_server(make_http_server, dec) as dec_url:
        router = Router([pre_url, dec_url], prefill_threshold=10)
        router.poll_once()
        greedy = [b for b in bodies if b["temperature"] == 0.0]
        with _http_server(make_router_http_server, router) as router_url:
            assert ids_through(router_url, greedy) == want["short"][::2]
        assert router.statusz()["requests_migrated"] == 1 and dec.metrics.migrations_in == 1

    # Drain evacuation, in process and over the wire, and /admin/evacuate:
    # every session finishes with the ids of a replica that never moved it.
    for mode in ("in_process", "wire", "admin"):
        with port(slow_ticks=True) as a, port() as b, _http_server(make_http_server, b) as b_url, \
                _http_server(make_http_server, a) as a_url:
            handles = [a.submit(Request(prompt_ids=tuple(body["prompt_ids"]), **{
                k: v for k, v in body.items() if k != "prompt_ids"})) for body in long_bodies]
            while a.engine.active_count < 2:
                time.sleep(0.01)
            if mode == "admin":
                code, _, body = _http(f"{a_url}/admin/evacuate",
                                      {"target": b_url, "max_sessions": 1})
                assert code == 200 and json.loads(body)["moved"] == 1, body
            else:
                assert a.drain(timeout_s=120, **(
                    {"evacuate_to": [b]} if mode == "in_process" else {"evacuate_urls": [b_url]}))
            results = [h.result(timeout=120) for h in handles]
            assert [r.finish_reason for r in results] == ["length"] * len(results), mode
            assert [list(r.token_ids) for r in results] == want["long"], mode
            assert b.metrics.migrations_in >= 1 and a.metrics.migrations_out >= 1, mode
            if mode != "in_process":
                assert a._relays_failed == 0 and a._relays_ok >= 1, mode
            evidence.append({"fleet": {"fleet": {"kind": "fleet", "t": 10.0,
                                                 "time_unix": time.time()},
                                       "replicas": [], "alerts": []},
                             "router": None, "errors": {}})

    # A corrupted payload (BT_FAULTS) is answered 400 and grafts nothing;
    # the clean re-export sent twice under one idempotency key grafts once.
    os.environ["BT_FAULTS"] = json.dumps({"corrupt_payload": "flip"})
    try:
        pre = port(role="prefill")
    finally:
        del os.environ["BT_FAULTS"]
    with pre, port(role="decode") as dec, _http_server(make_http_server, pre) as pre_url, \
            _http_server(make_http_server, dec) as dec_url:
        def post(url, data, headers):
            try:
                with urllib.request.urlopen(urllib.request.Request(url, data=data,
                                                                   headers=headers)) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as err:
                return err.code, err.read()

        def export():
            return post(f"{pre_url}/kv/export", json.dumps(bodies[2]).encode(),
                        {"Content-Type": "application/json", "X-KV-Accept": "zlib"})

        key = {"X-Idempotency-Key": "k1", "Content-Type": "application/octet-stream"}
        code, bad = export()
        assert code == 200 and post(f"{dec_url}/kv/import", bad, key)[0] == 400
        assert dec.metrics.migrations_in == 0
        code, good = export()
        answers = [post(f"{dec_url}/kv/import", good, key) for _ in range(2)]
        assert [c for c, _ in answers] == [200, 200]
        assert [json.loads(a)["token_ids"] for _, a in answers] == [want["short"][2]] * 2
        assert dec.metrics.migrations_in == 1

    # The controller: the same decisions as JAX's on the same evidence (the
    # fleet's own, and load gaps, KV starvation, a partial sweep, a prompt
    # mix that retunes the tier threshold).
    def snap(url, **kw):
        return {"url": url, "online": True, "draining": False, "role": "both",
                "queue_depth": 0, "slots": 2, "active_slots": 0, "kv_blocks_free": None,
                "kv_blocks_total": None, "error": None, **kw}

    for snaps, router_page in (
        ([snap("http://h", queue_depth=5, active_slots=2), snap("http://c", active_slots=1)],
         None),
        ([snap("http://h", queue_depth=1, active_slots=1, kv_blocks_free=1,
               kv_blocks_total=32), snap("http://c", kv_blocks_free=30, kv_blocks_total=32)],
         None),
        ([snap("http://h", queue_depth=6, active_slots=2), snap("http://c"),
          snap("http://gone", online=False, error="refused")], None),
        ([], {"prompt_mix": {"count": 20, "p75": 48}, "prefill_threshold": 8,
              "replicas": [{"role": "prefill", "available": True},
                           {"role": "both", "available": True}]}),
    ):
        evidence.append({"fleet": {"fleet": {"kind": "fleet", "t": 100.0, "time_unix": 1000.0,
                                             "queue_depth": 0, "active_slots": 0},
                                   "replicas": snaps, "alerts": []},
                         "router": router_page, "errors": {}})
    for ev in evidence:
        decisions = [ctl_cls("http://127.0.0.1:1", wall_clock=lambda: 1000.0,
                             sleep=lambda s: None, rebalance_batch=2).decide(ev)
                     for ctl_cls in (JaxFleetController, FleetController)]
        assert decisions[0] == decisions[1], decisions
    assert sum(bool(ev_d) for ev_d in (
        FleetController("http://127.0.0.1:1", wall_clock=lambda: 1000.0).decide(ev)
        for ev in evidence)) >= 3
