#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases (each failure exits non-zero and prints no ``ok`` line):

1. the card's name and power limit (``nvidia-smi``), then the build of every
   kernel in ``bpe_transformer_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and its time;
2. each kernel against its plain PyTorch version on the card, at the
   ``GPT2_SMALL_32K`` serving shapes, in float32 and bfloat16: max error
   against the stated tolerance, kernel / plain / one-library-call times,
   and the least time the card could take (the bound); and, for correctness
   only, at shapes off that path (other head dims, GQA groups, ragged
   lengths, odd d_ff);
3. the whole path in float32 on the trained 3-layer fixture
   (``tests/fixtures/trained_3l64d.npz``): prefill logits against the
   fixture's pinned logits, and greedy tokens served on the card identical
   to the same requests served on the CPU;
4. the whole path at full width: ``GPT2_SMALL_32K`` (bfloat16, ctx 1024) from
   seeded random weights, one prefill + decode step held against the plain
   versions in float32, then a ``ServingEngine`` with 8 slots answering 16
   mixed greedy and sampled requests (prompts of 16 to 900 tokens, 64 new
   tokens each) with every kernel counter at 0 before and checked after,
   and where a tick's time goes (host clock, and device time by kernel from
   ``torch.profiler``);
5. the training kernels (flash forward with lse, the dK/dV and dQ backward
   kernels, the RoPE-in-kernel forward) against autograd through their
   plain versions, in float32 and bfloat16, at the ``TINYSTORIES_4L`` and
   ``GPT2_SMALL_32K`` training shapes and, for correctness only, at ragged
   S and head dims 16 and 128; with kernel / plain / SDPA times and bounds;
6. the pinned 5-step AdamW trajectory of the trained fixture, trained on the
   card in float32 through the flash kernels and then through the RoPE
   kernel, against ``pin/traj_losses`` and ``pin/traj_lm_head``;
7. the ``TINYSTORIES_4L`` north-star protocol (``benchmarks/northstar.py``,
   reimplemented here without JAX): 200 float32 steps from the port's own
   seeded init through the kernels, the val loss curve against the torch-CPU
   reference, a checkpoint round trip at step 100, training tok/s;
8. ``GPT2_SMALL_32K`` training at full width (bf16 activations, float32
   masters, RoPE in the flash kernel, ``remat_policy="save_attn"``), 10
   steps on one batch with exact launch counts, host ms per step, device
   time by kernel for one step and peak memory;
then one JSON line listing every ported kernel, and the ``ok`` line.

Float32 matmuls run in full float32 (``allow_tf32 = False`` for cuBLAS and
cuDNN).  Per-shape kernel numbers are also written as JSON under
``OUT_DIR``: ``chip_smoke_kernels.json`` (serving) and
``chip_smoke_training.json`` (training).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "trained_3l64d.npz"
NORTHSTAR_TOKENS = ROOT / "benchmarks" / "northstar_tokens.npz"
NORTHSTAR_TORCH = ROOT / "benchmarks" / "northstar_torch.json"
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the rate of
#: the operations each kernel does for its input type — bf16 tensor-core
#: rate for bfloat16, the float32 rate outside the tensor cores for float32.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: Max-abs-error tolerances of kernel vs plain on the card.  float32 keeps
#: the JAX kernel tests' atol (attention 2e-5, SwiGLU 1e-5); bfloat16 uses
#: 3e-2, the JAX bf16 kernel tests' atol (one bf16 ulp at |x| in [2, 4) is
#: 1.6e-2, and the kernel and the plain version round once each).
TOL = {
    ("decode_attention", "float32"): 2e-5,
    ("flash_attention", "float32"): 2e-5,
    ("swiglu", "float32"): 1e-5,
}
TOL_BF16 = 3e-2

KERNEL_META = {
    "decode_attention": {
        "source": "bpe_transformer_tpu_torch/csrc/decode_attention.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/decode_attention.py:107",
    },
    "flash_attention": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:462",
    },
    "swiglu": {
        "source": "bpe_transformer_tpu_torch/csrc/swiglu.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/swiglu.py:76",
    },
    "flash_attention_rope": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:569",
    },
    "flash_attention_bwd_dkdv": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:299",
    },
    "flash_attention_bwd_dq": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:341",
    },
}
SERVING_KERNELS = ("decode_attention", "flash_attention", "swiglu")
TRAINING_KERNELS = ("flash_attention_rope", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- timing


def time_ms(torch, fn, input_sets, iters: int) -> float:
    """Mean ms of ``fn(*inputs)`` over ``iters`` launches on the current
    stream, cycling through ``input_sets`` (sized to exceed the 50 MB L2,
    so each launch finds its inputs cold as the serving path does)."""
    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*input_sets[i % len(input_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(2, min(16, math.ceil(128e6 / max(nbytes, 1))))


# ------------------------------------------------------------ phase 2


def kernel_cases(torch, dtype, gen):
    """(name, label, kernel_fn, plain_fn, library_fn, input_sets, bytes,
    flops) at the GPT2_SMALL_32K serving shapes: 8 slots x 12 heads x d 64,
    ctx 1024, prefill buckets 16..1024, d_model 768, d_ff 2048."""
    from bpe_transformer_tpu_torch.kernels import decode_attention as da
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    F = torch.nn.functional
    dev = "cuda"
    isz = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    cases = []
    # decode attention: one tick, ragged frontiers across the 8 slots; the
    # model's 12 heads (MHA), and 16 query heads over 4 KV heads (groups of
    # 4) for the kernel's grouped path.
    B, ctx, d = 8, 1024, 64
    pos = torch.tensor([0, 15, 100, 257, 511, 700, 900, 1023], device=dev)
    live = int((pos + 1).sum())
    for H, KV in ((12, 12), (16, 4)):
        nbytes = live * KV * d * 2 * isz + 2 * B * H * d * isz + B * 8
        sets = []
        for _ in range(copies_for(B * KV * ctx * d * 2 * isz)):
            q, k, v = rnd(B, H, d), rnd(B, KV, ctx, d), rnd(B, KV, ctx, d)
            mask = (torch.arange(ctx, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
            sets.append((q, k, v, pos, mask))
        cases.append((
            "decode_attention", f"B={B} H={H} KV={KV} ctx={ctx} d={d} ragged pos",
            lambda q, k, v, p, m: da.decode_attention(q, k, v, p),
            lambda q, k, v, p, m: da.decode_attention_plain(q, k, v, p),
            lambda q, k, v, p, m: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=m, enable_gqa=True),
            sets, nbytes, 4 * live * H * d,
        ))
    # flash attention: every prefill bucket, one request (batch 1) x 12 heads.
    for s in (16, 32, 64, 128, 256, 512, 1024):
        bh = 12
        sets = [tuple(rnd(1, bh, s, d) for _ in range(3))
                for _ in range(copies_for(3 * bh * s * d * isz))]
        cases.append((
            "flash_attention", f"BH={bh} S={s} d={d} causal",
            fa.flash_attention, fa.flash_attention_plain,
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            sets, 4 * bh * s * d * isz, 4 * bh * d * s * (s + 1) // 2,
        ))
    # swiglu: the tick (m = slots) and the largest prefill bucket, at the
    # model's init scale (rms-normed activations, std 0.02 weights).
    dm, ff = 768, 2048
    for m in (8, 1024):
        sets = [
            (rnd(m, dm), rnd(ff, dm, std=0.02), rnd(dm, ff, std=0.02), rnd(ff, dm, std=0.02))
            for _ in range(copies_for(3 * ff * dm * isz))
        ]
        cases.append((
            "swiglu", f"m={m} d={dm} ff={ff}",
            sw.swiglu_fused, sw.swiglu_plain,
            lambda x, w1, w2, w3: F.linear(F.silu(F.linear(x, w1)) * F.linear(x, w3), w2),
            sets, (2 * m * dm + 3 * ff * dm) * isz, 6 * m * dm * ff,
        ))
    return cases


def check_other_shapes(torch) -> None:
    """Kernel vs plain at shapes off the main path that the kernels take:
    every head dim and GQA group size they instantiate, ragged ctx and S,
    d_ff not a multiple of the SwiGLU slice (TINYSTORIES_4L's 683), and the
    widest SwiGLU register tile (d_model 2048).  Correctness only."""
    from bpe_transformer_tpu_torch.kernels import decode_attention as da
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")

        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

        cases = []
        for B, H, KV, ctx, d in ((3, 4, 4, 77, 16), (2, 8, 4, 200, 32), (2, 8, 1, 300, 128),
                                 (4, 16, 2, 64, 64)):
            pos = torch.randint(0, ctx, (B,), generator=gen, device="cuda")
            cases.append(("decode_attention", f"B={B} H={H} KV={KV} ctx={ctx} d={d}",
                          da.decode_attention, da.decode_attention_plain,
                          (rnd(B, H, d), rnd(B, KV, ctx, d), rnd(B, KV, ctx, d), pos)))
        for shape in ((2, 3, 77, 16), (1, 2, 200, 32), (2, 1, 300, 128)):
            cases.append(("flash_attention", f"{shape}", fa.flash_attention,
                          fa.flash_attention_plain, tuple(rnd(*shape) for _ in range(3))))
        for m, dm, ff in ((5, 256, 683), (37, 64, 200), (3, 2048, 96)):
            cases.append(("swiglu", f"m={m} d={dm} ff={ff}", sw.swiglu_fused, sw.swiglu_plain,
                          (rnd(m, dm), rnd(ff, dm, std=0.02), rnd(dm, ff, std=0.02),
                           rnd(ff, dm, std=0.02))))
        worst = 0.0
        for name, label, kern, plain, args in cases:
            out = kern(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL.get((name, dname), TOL_BF16)
            require(out.shape == ref.shape and bool(torch.isfinite(out).all()) and err <= tol,
                    f"{name} {dname} {label}: max error {err:.3e} (tol {tol:g})")
            worst = max(worst, err / tol)
        log(f"kernels off the main path, {dname}: {len(cases)} shapes within tolerance "
            f"(largest error {worst:.3f} of its tolerance)")


def phase_kernels(torch) -> dict:
    """Kernel vs plain on the card.  Returns the bf16 rows of the main-path
    representatives, keyed by kernel name."""
    check_other_shapes(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for name, label, kern, plain, lib, sets, nbytes, flops in kernel_cases(torch, dtype, gen):
            errs = []
            for inputs in sets[:2]:
                out = kern(*inputs)
                torch.cuda.synchronize()
                ref = plain(*inputs)
                require(out.shape == ref.shape and out.dtype == ref.dtype,
                        f"{name} {label}: output {tuple(out.shape)} {out.dtype}")
                require(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output")
                errs.append((out.float() - ref.float()).abs().max().item())
            err = max(errs)
            tol = TOL.get((name, dname), TOL_BF16)
            iters = 50 if name != "flash_attention" or "S=1024" not in label else 20
            ms = time_ms(torch, kern, sets, iters)
            plain_ms = time_ms(torch, plain, sets, max(5, iters // 5))
            lib_ms = time_ms(torch, lib, sets, iters)
            byte_ms = nbytes / HBM_BYTES_S * 1e3
            op_ms = flops / PEAK_FLOPS[dname] * 1e3
            row = {
                "name": name, "dtype": dname, "shape": label,
                "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "bytes": nbytes, "flops": flops,
            }
            rows.append(row)
            log(
                f"kernel {name:16s} {dname:8s} {label:38s} err {err:.3e} (tol {tol:g}) "
                f"ms {ms:.4f} plain {plain_ms:.4f} library {lib_ms:.4f} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})"
            )
            require(err <= tol, f"{name} {dname} {label}: max error {err:.3e} > {tol:g}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_kernels.json").write_text(json.dumps(rows, indent=1))
    main_shapes = {
        "decode_attention": "KV=12 ",
        "flash_attention": "S=1024",
        "swiglu": "m=8 ",
    }
    return {
        r["name"]: r for r in rows
        if r["dtype"] == "bfloat16" and main_shapes[r["name"]] in r["shape"]
    }


# ------------------------------------------------------------ phase 3


def reset_counts() -> None:
    from bpe_transformer_tpu_torch.kernels import _build

    _build.reset_launches()


def read_counts(names=SERVING_KERNELS) -> dict:
    from bpe_transformer_tpu_torch.kernels import _build

    return _build.read_launches(names)


KERNEL_KNOBS = dict(attention_impl="flash", ffn_impl="pallas", decode_attention_impl="pallas")


def phase_fixture(torch) -> None:
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
    from bpe_transformer_tpu_torch.models.decode import init_kv_cache, prefill
    from bpe_transformer_tpu_torch.models.transformer import params_from_state_dict
    from bpe_transformer_tpu_torch.serving.server import ServingEngine

    require(FIXTURE.exists(), f"fixture missing: {FIXTURE}")
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    sd = {k: v for k, v in arrays.items() if not k.startswith("pin/")}
    cfg = dataclasses.replace(TS_TEST_CONFIG, **KERNEL_KNOBS)
    ids = arrays["pin/input_ids"]

    reset_counts()
    params = params_from_state_dict(sd, cfg.num_layers, device="cuda")
    with torch.inference_mode():
        cache = init_kv_cache(cfg, ids.shape[0], device="cuda")
        logits, _ = prefill(params, torch.as_tensor(ids, device="cuda"), cfg, cache)
    err = (logits.cpu().numpy() - arrays["pin/logits"][:, -1]).__abs__().max()
    log(f"fixture prefill logits vs pinned logits: max err {err:.3e} (tol 1e-4)")
    require(err <= 1e-4, f"fixture prefill logits differ from the pinned logits by {err:.3e}")

    rng = np.random.default_rng(0)
    prompts = [list(ids[i, : 3 + 3 * i]) for i in range(4)]
    prompts += [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)] for n in (2, 6, 11, 15)]
    served = {}
    for device in ("cuda", "cpu"):
        with ServingEngine(params_from_state_dict(sd, cfg.num_layers, device=device), cfg,
                           slots=3, min_bucket=8, device=device) as serving:
            results = serving.run_batch(prompts, max_new_tokens=16, temperature=0.0)
        served[device] = [list(r.token_ids) for r in results]
    counts = read_counts()
    log(f"fixture greedy tokens (card): {served['cuda']}")
    log(f"fixture launches: {counts}")
    require(served["cuda"] == served["cpu"],
            f"greedy tokens differ: card {served['cuda']} vs cpu {served['cpu']}")
    require(all(counts[k] > 0 for k in counts), f"a kernel was not launched: {counts}")


# ------------------------------------------------------------ phase 4


def phase_full_width(torch) -> dict:
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.decode import decode_step, init_kv_cache, prefill
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine

    cfg = dataclasses.replace(GPT2_SMALL_32K, **KERNEL_KNOBS)
    plain_cfg = dataclasses.replace(GPT2_SMALL_32K)  # every knob "xla"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    log(f"GPT2_SMALL_32K init: {time.perf_counter() - t0:.2f} s")

    # Reference check at full width: one 100-token prefill and one decode
    # step through the kernels vs the plain versions, in float32.
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 100)), device="cuda")
    outs = {}
    with torch.inference_mode():
        for label, c in (("kernels", cfg), ("plain", plain_cfg)):
            c32 = dataclasses.replace(c, activation_dtype="float32")
            cache = init_kv_cache(c32, 1, device="cuda")
            lp, _ = prefill(params, prompt, c32, cache)
            ld, _ = decode_step(params, torch.argmax(lp, -1), 100, cache, c32)
            outs[label] = (lp, ld)
    err = max((a - b).abs().max().item() for a, b in zip(outs["kernels"], outs["plain"]))
    scale = outs["plain"][0].abs().max().item()
    log(f"full-width float32 logits, kernels vs plain: max err {err:.3e} "
        f"(|logits| max {scale:.3e}, tol 1e-4)")
    require(err <= 1e-4, f"full-width logits differ by {err:.3e}")

    lengths = [16, 40, 100, 200, 300, 450, 600, 750, 900, 17, 64, 129, 257, 513, 800, 33]
    requests = []
    for i, n in enumerate(lengths):
        knobs = {"temperature": 0.0} if i % 2 == 0 else {
            "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": i}
        requests.append(Request(
            prompt_ids=tuple(int(t) for t in rng.integers(0, cfg.vocab_size, size=n)),
            max_new_tokens=64, **knobs,
        ))
    with ServingEngine(params, cfg, slots=8, device="cuda") as serving:
        # Warm up outside the counted run (cuBLAS handles, allocator pools).
        serving.generate(list(range(20)), max_new_tokens=4, temperature=0.0)
        torch.cuda.synchronize()
        ticks0 = serving.engine.ticks
        reset_counts()
        t0 = time.perf_counter()
        handles = [serving.submit(r) for r in requests]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ticks = serving.engine.ticks - ticks0
    n_tokens = sum(len(r.token_ids) for r in results)
    prefill_s = sum(r.prefill_s for r in results)  # the worker admits one at a time
    log(f"full-width serving: {len(results)} requests, {n_tokens} tokens in {wall:.3f} s "
        f"= {n_tokens / wall:.1f} tok/s; {len(results)} prefills {prefill_s:.3f} s, "
        f"{ticks} ticks {wall - prefill_s:.3f} s; launches {counts}")
    for req, res in zip(requests, results):
        require(res.finish_reason == "length" and len(res.token_ids) == 64,
                f"request {req.request_id}: {res.finish_reason} after {len(res.token_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in res.token_ids), "token id out of range")
    L, P = cfg.num_layers, len(requests)
    expected = {"decode_attention": L * ticks, "flash_attention": L * P,
                "swiglu": L * (ticks + P)}
    require(counts == expected, f"launch counts {counts} != expected {expected}")
    profile_ticks(torch, params, cfg, rng)
    return counts


def profile_ticks(torch, params, cfg, rng, n_ticks: int = 10) -> None:
    """Where a full-width tick's time goes: the host-clock time of a tick
    with all 8 slots busy, and, from a ``torch.profiler`` trace of as many
    more ticks, the device time per tick by kernel and the device's idle
    share of the tick."""
    from torch.profiler import ProfilerActivity, profile

    from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine

    engine = SlotPoolEngine(params, cfg, slots=8, device="cuda")
    for i, n in enumerate((16, 100, 200, 300, 450, 600, 750, 900)):
        knobs = {"temperature": 0.0} if i % 2 == 0 else {"temperature": 0.8, "top_k": 50}
        engine.admit(rng.integers(0, cfg.vocab_size, size=n), max_new_tokens=100, **knobs)
    for _ in range(3):
        engine.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        engine.tick()
    torch.cuda.synchronize()
    tick_us = (time.perf_counter() - t0) * 1e6 / n_ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            engine.tick()
        torch.cuda.synchronize()
    by_name, busy_us = _device_breakdown(prof, n_ticks)
    if not by_name:
        log(f"tick profile: {tick_us:.0f} us per tick (host clock); device time not measured "
            "(the profiler recorded no device events)")
        return
    launches = sum(n for _, n in by_name.values()) / n_ticks
    log(f"tick profile (8 slots busy): {tick_us:.0f} us per tick (host clock), device busy "
        f"{busy_us:.0f} us per tick in {launches:.0f} launches, idle share "
        f"{1 - busy_us / tick_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {us:9.1f} us/tick  {n // n_ticks:4d} launches/tick  {name[:90]}")


# ------------------------------------------------------------ phase 5

#: Training-kernel tolerances of kernel vs plain on the card.  float32 keeps
#: the JAX kernel tests' atol: forward 2e-5 (tests/test_kernels.py:64; also
#: for the lse, a float32 statistic whatever the input type), backward 3e-5
#: (:113); bfloat16 uses 3e-2 for outputs (as phase 2) and 5e-2 for
#: gradients (:136).  The RoPE table gradients are sums over every (batch,
#: head) row, so they are held to 3e-5 (bf16: 5e-2) relative to their
#: largest magnitude (the JAX test's 3e-5 at :163 is absolute for 2 rows).
TRAIN_TOL = {
    "float32": {"out": 2e-5, "lse": 2e-5, "grad": 3e-5, "tables": 3e-5},
    "bfloat16": {"out": 3e-2, "lse": 2e-5, "grad": 5e-2, "tables": 5e-2},
}
#: (B, H, S, d) of the training main path, and off-path shapes checked for
#: correctness only (ragged S, the other head dims the kernels take).
TRAIN_SHAPES = {
    "TINYSTORIES_4L": (16, 8, 256, 32),
    "GPT2_SMALL_32K": (8, 12, 1024, 64),
}
TRAIN_SHAPES_OFF = {
    "ragged S 77 d 16": (2, 3, 77, 16),
    "ragged S 200 d 128": (1, 2, 200, 128),
    "ragged S 1000 d 64": (1, 2, 1000, 64),
}


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def training_kernel_errors(torch, fa, q, k, v, g, cos, sin) -> dict:
    """Max abs error of each training kernel against autograd through its
    plain version, checked against TRAIN_TOL; returns ``{kernel: err}``."""
    dname = str(q.dtype).removeprefix("torch.")
    tol = TRAIN_TOL[dname]
    grad = torch.autograd.grad

    def leaves(*ts):
        return [t.detach().clone().requires_grad_() for t in ts]

    out, lse = fa._forward(q, k, v, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    ref = leaves(q, k, v)
    ref_grads = grad(fa.flash_attention_plain(*ref), ref, g)
    dq, dk, dv = fa._backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    errs = {
        "flash_attention": _max_err(out, ref_out),
        "lse": _max_err(lse, ref_lse.reshape(lse.shape)),
        "flash_attention_bwd_dkdv": max(_max_err(dk, ref_grads[1]), _max_err(dv, ref_grads[2])),
        "flash_attention_bwd_dq": _max_err(dq, ref_grads[0]),
    }
    limits = {"flash_attention": tol["out"], "lse": tol["lse"],
              "flash_attention_bwd_dkdv": tol["grad"], "flash_attention_bwd_dq": tol["grad"]}

    kern = leaves(q, k, v, cos, sin)
    rout = fa.FlashAttentionRope.apply(*kern)
    kgrads = grad(rout, kern, g)
    ref = leaves(q, k, v, cos, sin)
    rref = fa.flash_attention_rope_plain(*ref)
    rgrads = grad(rref, ref, g)
    torch.cuda.synchronize()
    errs["flash_attention_rope"] = _max_err(rout, rref)
    errs["rope_grads"] = max(_max_err(a, b) for a, b in zip(kgrads[:3], rgrads[:3]))
    errs["rope_tables"] = max(
        _max_err(a, b) / max(1.0, b.abs().max().item()) for a, b in zip(kgrads[3:], rgrads[3:])
    )
    limits.update(flash_attention_rope=tol["out"], rope_grads=tol["grad"],
                  rope_tables=tol["tables"])
    for t in (out, dq, dk, dv, rout, *kgrads):
        require(bool(torch.isfinite(t).all()), f"{dname} {tuple(q.shape)}: non-finite output")
    for name, err in errs.items():
        require(err <= limits[name],
                f"{name} {dname} {tuple(q.shape)}: max error {err:.3e} > {limits[name]:g}")
    return errs


def training_inputs(torch, shape, dtype, gen):
    """q, k, v, dO (std 1) and the RoPE tables at positions 0..S-1 (float32
    tables rounded to the activation type, as the model builds them)."""
    from bpe_transformer_tpu_torch.ops.rope import rope_tables

    b, h, s, d = shape
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    cos, sin = rope_tables(d, s, dtype=dtype, device="cuda")
    return q, k, v, g, cos, sin


def training_timings(torch, fa, shape, dtype, gen) -> list[dict]:
    """Kernel / plain / library ms and bound of each training kernel at one
    main-path shape (CUDA events; inputs cycled past the L2)."""
    F = torch.nn.functional
    dname = str(dtype).removeprefix("torch.")
    b, h, s, d = shape
    isz = torch.tensor([], dtype=dtype).element_size()
    bh = b * h
    pairs = bh * s * (s + 1) // 2
    elems = bh * s * d
    sets = []
    for _ in range(copies_for(4 * elems * isz)):
        q, k, v, g, cos, sin = training_inputs(torch, shape, dtype, gen)
        out, lse = fa._forward(q, k, v, with_lse=True)
        delta = (g.float() * out.float()).sum(-1).reshape(bh, s).contiguous()
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        sets.append(dict(q=q, k=k, v=v, g=g, cos=cos, sin=sin, out=out, lse=lse, delta=delta,
                         qq=qq, kk=kk, vv=vv, sdpa_out=sdpa_out))

    def sdpa_fwd_bwd(t):
        o = F.scaled_dot_product_attention(t["qq"], t["kk"], t["vv"], is_causal=True)
        return torch.autograd.grad(o, (t["qq"], t["kk"], t["vv"]), t["g"])

    def sdpa_bwd(t):
        return torch.autograd.grad(t["sdpa_out"], (t["qq"], t["kk"], t["vv"]), t["g"],
                                   retain_graph=True)

    table_bytes = 2 * s * (d // 2) * 4
    cases = [
        ("flash_attention", lambda t: fa._forward(t["q"], t["k"], t["v"], with_lse=True),
         lambda t: fa.flash_attention_plain(t["q"], t["k"], t["v"], True, return_lse=True),
         lambda t: F.scaled_dot_product_attention(t["q"], t["k"], t["v"], is_causal=True),
         4 * elems * isz + bh * s * 4, 4 * d * pairs, "fwd + lse"),
        ("flash_attention_rope",
         lambda t: fa._forward(t["q"], t["k"], t["v"], t["cos"], t["sin"], with_lse=True),
         lambda t: fa.flash_attention_rope_plain(t["q"], t["k"], t["v"], t["cos"], t["sin"],
                                                 return_lse=True),
         None, 4 * elems * isz + bh * s * 4 + table_bytes, 4 * d * pairs + 6 * elems,
         "fwd + lse, RoPE in kernel"),
        ("flash_attention_bwd_dkdv",
         lambda t: fa._launch_bwd("dkdv", t["q"], t["k"], t["v"], t["g"], t["lse"], t["delta"]),
         lambda t: fa.flash_attention_bwd_dkdv_plain(t["q"], t["k"], t["v"], t["out"], t["lse"],
                                                     t["g"]),
         sdpa_bwd, 6 * elems * isz + 2 * bh * s * 4, 8 * d * pairs, "dK, dV"),
        ("flash_attention_bwd_dq",
         lambda t: fa._launch_bwd("dq", t["q"], t["k"], t["v"], t["g"], t["lse"], t["delta"]),
         lambda t: fa.flash_attention_bwd_dq_plain(t["q"], t["k"], t["v"], t["out"], t["lse"],
                                                   t["g"]),
         sdpa_bwd, 5 * elems * isz + 2 * bh * s * 4, 6 * d * pairs, "dQ"),
    ]
    iters = 10 if s >= 1024 else 30
    one = [(t,) for t in sets]
    sdpa_fb_ms = time_ms(torch, sdpa_fwd_bwd, one, iters)
    rows = []
    for name, kern, plain, lib, nbytes, flops, what in cases:
        ms = time_ms(torch, kern, one, iters)
        plain_ms = time_ms(torch, plain, one, 3)
        lib_ms = time_ms(torch, lib, one, iters) if lib is not None else None
        byte_ms = nbytes / HBM_BYTES_S * 1e3
        op_ms = flops / PEAK_FLOPS[dname] * 1e3
        rows.append({
            "name": name, "dtype": dname, "shape": f"B={b} H={h} S={s} d={d} {what}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "sdpa_fwd_bwd_ms": sdpa_fb_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "bytes": nbytes, "flops": flops,
        })
    return rows


def phase_training_kernels(torch) -> dict:
    """Training kernels vs plain on the card; returns the bf16 rows at the
    GPT2_SMALL_32K training shape, keyed by kernel name."""
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        worst: dict[str, float] = {}
        for label, shape in {**TRAIN_SHAPES, **TRAIN_SHAPES_OFF}.items():
            errs = training_kernel_errors(torch, fa, *training_inputs(torch, shape, dtype, gen))
            log(f"training kernels {dname:8s} {label:20s} {tuple(shape)}: "
                + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0.0), err)
            if label not in TRAIN_SHAPES:
                continue
            for row in training_timings(torch, fa, shape, dtype, gen):
                row["config"] = label
                row["max_abs_err"] = errs[row["name"]]
                rows.append(row)
                lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
                log(f"kernel {row['name']:24s} {dname:8s} {row['shape']:44s} "
                    f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} library {lib} "
                    f"(SDPA fwd+bwd {row['sdpa_fwd_bwd_ms']:.4f}) "
                    f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        log(f"training kernels {dname}: largest errors {worst}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_training.json").write_text(json.dumps(rows, indent=1))
    return {
        r["name"]: r for r in rows
        if r["dtype"] == "bfloat16" and r["config"] == "GPT2_SMALL_32K"
        and r["name"] in TRAINING_KERNELS
    }


# ------------------------------------------------------------ phase 6


def phase_trajectory(torch) -> None:
    """The trained fixture's pinned 5-step AdamW trajectory, trained on the
    card in float32 through the kernels (flash, then RoPE in the kernel)."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
    from bpe_transformer_tpu_torch.models.transformer import params_from_state_dict
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    sd = {k: v for k, v in arrays.items() if not k.startswith("pin/")}
    tokens = np.load(NORTHSTAR_TOKENS)["tokens"]
    paths = (
        (dict(attention_impl="flash", ffn_impl="pallas"), "flash_attention"),
        (dict(attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas"),
         "flash_attention_rope"),
    )
    for knobs, attn_kernel in paths:
        cfg = dataclasses.replace(TS_TEST_CONFIG, **knobs)
        reset_counts()
        params = params_from_state_dict(sd, cfg.num_layers, device="cuda")
        opt_state = adamw_init(params)
        step = make_train_step(cfg, TrainHParams())
        rng = np.random.default_rng(2)
        losses = []
        for _ in range(5):
            starts = rng.integers(0, len(tokens) - cfg.context_length - 1, size=32)
            x = np.stack([tokens[s : s + cfg.context_length] for s in starts]).astype(np.int64)
            y = np.stack([tokens[s + 1 : s + cfg.context_length + 1] for s in starts])
            params, opt_state, m = step(params, opt_state, torch.as_tensor(x, device="cuda"),
                                        torch.as_tensor(y.astype(np.int64), device="cuda"))
            losses.append(float(m["loss"]))
        names = (attn_kernel, "flash_attention_bwd_dkdv", "flash_attention_bwd_dq", "swiglu")
        counts = read_counts(names)
        loss_err = float(np.abs(np.asarray(losses) - arrays["pin/traj_losses"]).max())
        head_err = float(np.abs(params["lm_head"].detach().cpu().numpy()
                                - arrays["pin/traj_lm_head"]).max())
        log(f"trajectory {knobs}: losses {losses}; max err vs pinned: losses {loss_err:.3e}, "
            f"lm_head {head_err:.3e} (tol 1e-4); launches {counts}")
        require(loss_err <= 1e-4 and head_err <= 1e-4,
                f"trajectory {knobs} differs from the pinned one: {loss_err:.3e} / {head_err:.3e}")
        require(all(n > 0 for n in counts.values()), f"a kernel was not launched: {counts}")


# ------------------------------------------------------------ phase 7


def _device_breakdown(prof, per: int):
    """``({kernel name: [us per unit, launches]}, busy us per unit)`` of the
    device events of a ``torch.profiler`` trace over ``per`` units."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / per
            entry[1] += 1
    return by_name, sum(t for t, _ in by_name.values())


def profile_step(torch, label: str, run_step, n_top: int = 8) -> dict:
    """Host-clock time of one synchronised training step and, from a
    ``torch.profiler`` trace of another, device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_step()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    by_name, busy_us = _device_breakdown(prof, 1)
    if not by_name:
        log(f"{label} step profile: {host_us:.0f} us (host clock); device time not measured "
            "(the profiler recorded no device events)")
        return {"host_us": host_us, "device_us": None}
    launches = sum(n for _, n in by_name.values())
    log(f"{label} step profile: {host_us:.0f} us per step (host clock), device busy "
        f"{busy_us:.0f} us in {launches} launches, idle share {1 - busy_us / host_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]:
        log(f"  {us:10.1f} us/step  {n:5d} launches/step  {name[:90]}")
    return {"host_us": host_us, "device_us": busy_us}


def phase_northstar(torch, smi: str) -> None:
    """benchmarks/northstar.py's protocol at TINYSTORIES_4L, float32, through
    the flash and SwiGLU kernels, from the port's own seeded init."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.checkpointing import (
        load_checkpoint,
        save_checkpoint,
        training_state,
    )
    from bpe_transformer_tpu_torch.models import TINYSTORIES_4L
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.training.train_step import (
        TrainHParams,
        make_eval_step,
        make_train_step,
    )

    seq, batch, steps, eval_every, check_at = 256, 16, 200, 25, 100
    tokens = np.load(NORTHSTAR_TOKENS)["tokens"]
    reference = json.loads(NORTHSTAR_TORCH.read_text())
    n_val = max(int(len(tokens) * 0.1), seq + 1)
    train_toks, val_toks = tokens[:-n_val], tokens[-n_val:]
    schedule = np.random.default_rng(0).integers(0, len(train_toks) - seq - 1, size=(steps, batch))

    def windows(toks, starts):
        x = np.stack([toks[s : s + seq] for s in starts]).astype(np.int64)
        y = np.stack([toks[s + 1 : s + seq + 1] for s in starts]).astype(np.int64)
        return torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")

    val = [windows(val_toks, [i * seq]) for i in range(min((len(val_toks) - 1) // seq, 8))]
    cfg = dataclasses.replace(TINYSTORIES_4L, attention_impl="flash", ffn_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    opt_state = adamw_init(params)
    step = make_train_step(cfg, TrainHParams())
    evaluate = make_eval_step(cfg)

    def val_loss() -> float:
        return float(np.mean([float(evaluate(params, x, y)) for x, y in val]))

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    curve, train_s, reloaded = [], 0.0, None
    for i in range(steps):
        x, y = windows(train_toks, schedule[i])
        if reloaded is not None:
            # The step after the round trip, from the reloaded state.
            p2, o2, m2 = step(*reloaded, x, y)
            reloaded = (float(m2["loss"]), p2["lm_head"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, x, y)
        loss = float(m["loss"])  # one sync per step, as northstar.py's parity loop
        train_s += time.perf_counter() - t0
        if reloaded is not None:
            same = reloaded[0] == loss and torch.equal(reloaded[1], params["lm_head"])
            log(f"checkpoint round trip at step {check_at}: step {i + 1} loss {loss!r} live, "
                f"{reloaded[0]!r} reloaded, lm_head identical {same}")
            require(same, "the step after a checkpoint round trip differs from the live step")
            reloaded = None
        if i + 1 == check_at:
            path = OUT_DIR / "northstar_step100.ckpt"
            OUT_DIR.mkdir(exist_ok=True)
            save_checkpoint(path, params=params, opt_state=opt_state, iteration=i + 1)
            reloaded = training_state(load_checkpoint(path), "cuda")
            path.unlink()
            path.with_name(path.name + ".crc32.json").unlink()
        if (i + 1) % eval_every == 0:
            curve.append({"step": i + 1, "train_loss": loss, "val_loss": val_loss()})
            log(f"north star step {i + 1}: {curve[-1]}")
    counts = read_counts(("flash_attention", "flash_attention_bwd_dkdv",
                          "flash_attention_bwd_dq", "swiglu"))
    peak = torch.cuda.max_memory_allocated()
    final = curve[-1]["val_loss"]
    at_check = next(c["val_loss"] for c in curve if c["step"] == check_at)
    tok_s = steps * batch * seq / train_s
    log(f"north star TINYSTORIES_4L float32: final val loss {final:.4f} vs torch-CPU reference "
        f"{reference['final_val_loss']:.4f} (delta {final - reference['final_val_loss']:+.4f}); "
        f"step {check_at} val {at_check:.4f}; {tok_s:.1f} training tok/s "
        f"({train_s / steps * 1e3:.2f} ms/step, one sync per step) on {smi}; "
        f"peak memory {peak / 2**20:.0f} MiB; launches {counts}")
    require(abs(final - reference["final_val_loss"]) <= 0.15,
            f"final val loss {final:.4f} is not within 0.15 of {reference['final_val_loss']:.4f}")
    require(final < at_check, f"final val loss {final:.4f} not below step {check_at}'s")
    require(all(n > 0 for n in counts.values()), f"a kernel was not launched: {counts}")
    x, y = windows(train_toks, schedule[0])
    profile_step(torch, "TINYSTORIES_4L", lambda: step(params, opt_state, x, y))


# ------------------------------------------------------------ phase 8


def phase_gpt2_training(torch, smi: str) -> dict:
    """GPT2_SMALL_32K training at full width: 10 steps on one seeded batch
    with exact launch counts per step."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

    cfg = dataclasses.replace(
        GPT2_SMALL_32K, attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas",
        remat_policy="save_attn",
    )
    batch, n_steps = 8, 10
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt_state = adamw_init(params)
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=n_steps)
    step = make_train_step(cfg, hparams)
    rng = np.random.default_rng(8)
    x, y = (torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, cfg.context_length)),
                            device="cuda") for _ in range(2))
    L = cfg.num_layers
    per_step = {"flash_attention_rope": L, "flash_attention_bwd_dkdv": L,
                "flash_attention_bwd_dq": L, "swiglu": 2 * L, "flash_attention": 0,
                "decode_attention": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms = [], []
    for _ in range(n_steps):
        reset_counts()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, x, y)
        losses.append(float(m["loss"]))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(per_step)
        require(counts == per_step, f"launch counts of one step {counts} != {per_step}")
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(host_ms[1:]))
    log(f"GPT2_SMALL_32K training (bf16 activations, B={batch} S={cfg.context_length}, "
        f"save_attn, RoPE in kernel): losses {[round(v, 4) for v in losses]}")
    log(f"GPT2_SMALL_32K host ms per step {[round(v, 1) for v in host_ms]} (steps 2-10 mean "
        f"{mean_ms:.1f} ms = {batch * cfg.context_length / mean_ms * 1e3:.0f} tok/s); "
        f"peak memory {peak / 2**30:.2f} GiB on {smi}; launches per step {per_step}")
    require(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    profile_step(torch, "GPT2_SMALL_32K", lambda: step(params, opt_state, x, y))
    return {name: per_step[name] * n_steps for name in TRAINING_KERNELS}


# ------------------------------------------------------------ main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "bpe_transformer_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port package beside {__file__}; run it from the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bpe_transformer_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({built})")
    for name in _build.kernel_names():
        ptxas = (_build.build_dir() / f"{name}.log")
        if ptxas.exists():
            spills = [ln.strip() for ln in ptxas.read_text().splitlines()
                      if "spill" in ln and not ln.strip().startswith("0 bytes stack")]
            log(f"  {name}: {len(spills)} instantiations with a stack frame or spills")

    t0 = time.perf_counter()
    main_rows = phase_kernels(torch)
    log(f"phase 2 kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_fixture(torch)
    log(f"phase 3 fixture float32 path: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    counts = phase_full_width(torch)
    log(f"phase 4 GPT2_SMALL_32K serving: ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    train_rows = phase_training_kernels(torch)
    log(f"phase 5 training kernels vs plain: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_trajectory(torch)
    log(f"phase 6 pinned trajectory on the card: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_northstar(torch, smi)
    log(f"phase 7 TINYSTORIES_4L north star: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    counts.update(phase_gpt2_training(torch, smi))
    log(f"phase 8 GPT2_SMALL_32K training: ok ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    for name, meta in KERNEL_META.items():
        row = main_rows.get(name) or train_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "dtype": row["dtype"], "shape": row["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    # The run drove one card, cuda:0, whatever else the host shows.
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1},
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
