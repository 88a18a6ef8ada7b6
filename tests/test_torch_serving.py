"""The PyTorch port's continuous-batching serving path held against the JAX
package's: greedy tokens identical to the JAX ``SlotPoolEngine`` and
``PagedEngine`` (act and int8 KV blocks, int8 weights, prefix sharing),
seeded sampling that replays and agrees between the port's paged and dense
engines, the serving weight bytes and label equal to JAX's, the paged
``ServingEngine`` parking admissions the block pool cannot cover, and
``filter_logits`` masks identical on shared logits.

Both packages run a GQA model with the kernel knobs of the ported serving
path, on random JAX weights at 8 times the init scale (the greedy tokens
then vary, and the top two logits of every step differ by about 0.02,
far above the packages' numerical differences).  The JAX side runs its
Pallas kernels in interpret mode on the CPU, the port runs on the CPU
(``device="cpu"``) through its plain versions.
"""

import dataclasses
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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
from bpe_transformer_tpu_torch.models import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import params_from_jax
from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine, filter_logits
from bpe_transformer_tpu_torch.serving.kvpool import NoFreeBlocksError, PagedEngine
from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine

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


def test_torch_serving_matches_jax_engine():
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
