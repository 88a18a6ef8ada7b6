"""The PyTorch port's continuous-batching serving path held against the JAX
package's: greedy tokens identical to the JAX ``SlotPoolEngine``, seeded
sampling that replays, and ``filter_logits`` masks identical on shared
logits.

Both packages run a GQA model with the kernel knobs of the ported serving
path, on random JAX weights at 8 times the init scale (the greedy tokens
then vary, and the top two logits of every step differ by about 0.02,
far above the packages' numerical differences).  The JAX side runs its
Pallas kernels in interpret mode on the CPU, the port runs on the CPU
(``device="cpu"``) through its plain versions.
"""

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp
import torch

from bpe_transformer_tpu.models import TS_TEST_CONFIG as JAX_TS_TEST_CONFIG
from bpe_transformer_tpu.models import init_params as jax_init_params
from bpe_transformer_tpu.serving.engine import SlotPoolEngine as JaxSlotPoolEngine
from bpe_transformer_tpu.serving.engine import filter_logits as jax_filter_logits
from bpe_transformer_tpu_torch.models import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import params_from_jax
from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine, filter_logits
from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine

JAX_CFG = dataclasses.replace(
    JAX_TS_TEST_CONFIG, vocab_size=128, context_length=32, num_kv_heads=2,
    attention_impl="flash", ffn_impl="pallas", decode_attention_impl="pallas",
)


def _drive(engine, prompts, max_new_tokens):
    """Serve ``prompts`` greedily through a slot-pool engine, admitting
    whenever a slot is free; returns each prompt's tokens in input order."""
    outs, pending, owner = {}, list(range(len(prompts))), {}
    while pending or owner:
        while pending and engine.free_slots:
            i = pending.pop(0)
            event = engine.admit(prompts[i], max_new_tokens=max_new_tokens, temperature=0.0)
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
