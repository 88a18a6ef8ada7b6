#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one CUDA card and check it.

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
5. one JSON line listing every ported kernel, then the ``ok`` line.

Float32 matmuls run in full float32 (``allow_tf32 = False`` for cuBLAS and
cuDNN).  Per-shape kernel numbers are also written to
``chiprun_out/chip_smoke_kernels.json``.
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
}


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


def kernel_modules():
    from bpe_transformer_tpu_torch.kernels import decode_attention, flash_attention, swiglu

    return {"decode_attention": decode_attention, "flash_attention": flash_attention,
            "swiglu": swiglu}


def reset_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


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
    from torch.autograd import DeviceType
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
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / n_ticks
            entry[1] += 1
    busy_us = sum(t for t, _ in by_name.values())
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

    kernels = []
    for name, meta in KERNEL_META.items():
        row = main_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "dtype": row["dtype"], "shape": row["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
