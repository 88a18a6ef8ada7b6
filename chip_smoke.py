#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases (each failure exits non-zero and prints no ``ok`` line):

1. the card's name and power limit (``nvidia-smi``), then the build of every
   kernel in ``bpe_transformer_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and its time;
2. each serving kernel against its plain PyTorch version on the card, at
   the ``GPT2_SMALL_32K`` serving shapes, in float32 and bfloat16 (the
   paged decode kernel also with int8 pools, the int8 matmul at the tick
   and at a prefill chunk for every matrix of the model): max error against
   the stated tolerance, kernel / plain / one-library-call device times
   (CUDA graph replays; the kernel also as launched from Python), and the
   least time the card could take (the bound); the SwiGLU forward's and
   the int8 matmul's two designs (tensor cores, CUDA cores) timed side by
   side from 1 to 256 rows and the crossover m where the tensor cores win;
   and, for correctness only, at shapes off that path (other head dims,
   among them 320 and 512, which run in output-column chunks, GQA groups,
   block sizes, ragged lengths, odd d_ff, int8 rows not a multiple of 16
   bytes), with the tensor-core int8 matmul's widening of all 256 byte
   values held bit for bit;
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
   S and head dims 16, 96, 128, 256, 320 and 512, two backward calls on the
   same inputs bit-identical; with kernel / plain / SDPA times (the kernels
   also by CUDA-graph replay) and bounds; and the SwiGLU forward at the
   training m of both configs;
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
9. paged serving (``decode_attention_impl="paged"``): the fixture served by
   the paged engine at act width, with int8 KV and with int8 KV + int8
   weights, greedy tokens identical to the CPU's (and to the dense engine's
   at act width); ``GPT2_SMALL_32K`` chunked prefill + one paged decode
   step held against the plain versions in float32; a paged
   ``ServingEngine`` (8 slots, blocks of 16, chunks of 256, a 512-token
   prefill budget, a pool of four contexts) on 16 requests, 8 of them a
   shared 512-token prefix, at int8 KV + int8 weights and at act width, with
   parked admissions, prefix-cache hits and exact launch counts; a tick
   profile of each width;
10. fused sampling and speculative decoding: (a) the fused head + sample
   and verify tails (``csrc/sample.cu``) against their plain versions at
   the GPT2_SMALL_32K tick (8 rows) and verify (40 rows) shapes, float32
   and bfloat16 with heads at their width and int8, every knob, and off the
   path at other vocabularies, rows and widths: the logit workspace within
   tolerance, tokens identical to the plain chain run on the kernel's own
   logits, p_d within 2e-6, kernel / plain ms and the bound; (b) the
   fixture served by the speculative engine (one-layer draft, K 4), fused
   and unfused, at act width and int8 KV + int8 weights, greedy tokens
   identical to the CPU's and to the non-speculative engine's; (c)
   GPT2_SMALL_32K served by a speculative ``ServingEngine`` (K 4, a
   two-layer truncated draft, the fused verify tail) on phase 9c's mix at
   both widths with exact launch counts, acceptance and a spec-tick
   profile, and the same mix through the paged engine with the fused tick
   tail, whose greedy tokens must be phase 9c's;
11. the two-matrix FFNs and the GeLU kernels (``csrc/gelu.cu``): (a) the
   forward and backward kernels against their plain versions and
   ``F.gelu(approximate="tanh")`` / its backward at the tick, chunk and
   training shapes of a d_ff 3072 FFN, float32 and bfloat16, and for
   correctness at sizes with a scalar tail, an unaligned view and
   magnitudes up to 1000; (b) small seeded float32 gelu and silu models
   served on the card by the dense, paged (act, int8 KV + int8 weights)
   and speculative engines with the CPU's greedy tokens, and a 5-step AdamW
   trajectory on the card against the CPU's; (c) GPT2_SMALL_32K with
   GPT-2's 3072-wide tanh-GeLU FFN at full width: one prefill + decode
   step against the plain versions, phase 4's mix through the dense engine
   and phase 9c's through the paged engine at int8 KV + int8 weights, and
   phase 8's 10 training steps, each with exact launch counts and a
   profile;
12. ring-flash sequence-parallel training on a stacked ring of 4 ranks
   (``bpe_transformer_tpu_torch/parallel``): (a) B6, the non-causal flash
   forward with its lse and the non-causal block backward, with their
   causal twins, against the plain versions at the sp path's launch shapes
   (4 x (8, 12, 256, 64) contiguous, 4 x (8, 12, 128, 64) zig-zag),
   float32 and bfloat16, two block backward calls bit-identical, with
   kernel / plain / library ms (the kernels also by graph replay) and the
   bound;
   (b) the contiguous and zig-zag rings, forward and backward, against one
   full-length causal flash call and its gradients at (8, 12, 1024, 64);
   (c) ``make_sp_train_step`` at GPT2_SMALL_32K (phase 8's batch and
   dtypes, ``attention_impl="flash"``), contiguous and zig-zag: step 1's
   loss and gradients against the dense step's, then 10 steps on one batch
   with exact launch counts, host ms per step, a step profile and peak
   memory;
then one JSON line listing every ported kernel, and the ``ok`` line.

Float32 matmuls run in full float32 (``allow_tf32 = False`` for cuBLAS and
cuDNN).  Per-shape kernel numbers are also written as JSON under
``OUT_DIR``: ``chip_smoke_kernels.json`` (serving),
``chip_smoke_training.json`` (training), ``chip_smoke_sample.json`` (the
fused tails), ``chip_smoke_gelu.json`` (the GeLU kernels) and
``chip_smoke_sp.json`` (B6).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import threading
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
#: 1.6e-2, and the kernel and the plain version round once each).  The int8
#: matmul's output is float32 whatever x's type (bf16 x is widened exactly),
#: so both are held to 1e-4: float32 sums over up to 2048 terms of |x q| up
#: to ~130 each, taken in another order than cuBLAS's, for outputs of order 1.
TOL = {
    ("decode_attention", "float32"): 2e-5,
    ("flash_attention", "float32"): 2e-5,
    ("swiglu", "float32"): 1e-5,
    ("paged_decode_attention", "float32"): 2e-5,
    ("quant_matmul", "float32"): 1e-4,
    ("quant_matmul", "bfloat16"): 1e-4,
}
TOL_BF16 = 3e-2
#: Phase 9b: full-width float32 logits of the paged path, kernels vs plain
#: versions.  Act width keeps phase 4's 1e-4.  Under int8 KV the kernels'
#: and the plain versions' K/V rows differ by float32 rounding, and a value
#: that lands on the other side of a .5 boundary of the KV quantizer moves
#: by one int8 step (about 1% of its block's largest value); such steps
#: reach the logits, so int8 is held to 1e-3.
PAGED_LOGIT_TOL = {"act": 1e-4, "int8 KV + int8 weights": 1e-3}

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
    "paged_decode_attention": {
        "source": "bpe_transformer_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/decode_attention.py:284",
    },
    "quant_matmul": {
        "source": "bpe_transformer_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/quant_matmul.py:68",
    },
    "fused_head_sample": {
        "source": "bpe_transformer_tpu_torch/csrc/sample.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/sample.py:335",
    },
    "fused_verify_head": {
        "source": "bpe_transformer_tpu_torch/csrc/sample.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/sample.py:373",
    },
    "gelu": {
        "source": "bpe_transformer_tpu_torch/csrc/gelu.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/gelu.py:41",
    },
    # The JAX package runs the GeLU backward (its custom JVP) in XLA.
    "gelu_bwd": {
        "source": "bpe_transformer_tpu_torch/csrc/gelu.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/gelu.py:83",
    },
    # B6: the ring-flash interface, the causal=False instances.
    "flash_attention_nc": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:512",
    },
    "flash_attention_bwd_dkdv_nc": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:527",
    },
    "flash_attention_bwd_dq_nc": {
        "source": "bpe_transformer_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "bpe_transformer_tpu/kernels/pallas/flash_attention.py:527",
    },
}
SERVING_KERNELS = ("decode_attention", "flash_attention", "swiglu")
PAGED_KERNELS = ("paged_decode_attention", "quant_matmul")
TRAINING_KERNELS = ("flash_attention_rope", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- timing


def time_ms(torch, fn, input_sets, iters: int, graph: bool = False) -> float:
    """Mean ms of ``fn(*inputs)`` over ``iters`` launches on the current
    stream, cycling through ``input_sets`` (sized to exceed the 50 MB L2,
    so each launch finds its inputs cold as the serving path does).

    Between CUDA events the launches are enqueued from Python, so a small
    kernel that runs faster than its wrapper can enqueue it is timed at the
    enqueue rate.  ``graph=True`` captures the ``iters`` launches in one
    CUDA graph and times its replay instead: the device time alone."""
    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(*input_sets[i % len(input_sets)])

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(2, min(16, math.ceil(128e6 / max(nbytes, 1))))


# ------------------------------------------------------------ phase 2


def paged_inputs(torch, gen, S, H, KV, bs, nbs, d, dtype, kv_int8, pos=None, trash_slot=False):
    """q, k/v pools, shuffled tables, pos and (int8) scales for the paged
    decode kernel: every slot owns nbs blocks of a pool of S * nbs + 1
    (block 0 the trash block); ``trash_slot`` parks the last slot on block
    0, as an idle slot is."""
    dev = "cuda"
    nb = S * nbs + 1
    tables = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)[: S * nbs]
    tables = tables.reshape(S, nbs).to(torch.int32)
    if trash_slot:
        tables[-1] = 0
    if pos is None:
        pos = torch.randint(0, nbs * bs, (S,), generator=gen, device=dev)
    q = torch.randn(S, H, d, generator=gen, device=dev).to(dtype)
    if kv_int8:
        k, v = (torch.randint(-127, 128, (nb, KV, bs, d), generator=gen, device=dev)
                .to(torch.int8) for _ in range(2))
        # Scales of unit-variance K/V (max |x| / 127): dequantized values of order 1.
        ks, vs = ((torch.rand(nb, KV, generator=gen, device=dev) + 0.5) / 60 for _ in range(2))
    else:
        k, v = (torch.randn(nb, KV, bs, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        ks = vs = None
    return q, k, v, tables, pos, ks, vs


def quant_inputs(torch, gen, m, k, n, dtype):
    """x, int8 q, scale of a std-0.02 weight (quantized as ops/quant.py does,
    with one all-zero row), and the dequantized weight at x's dtype (the
    library call's operand)."""
    from bpe_transformer_tpu_torch.ops.quant import dequantize, quantize_weight

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn(n, k, generator=gen, device="cuda") * 0.02
    w[0] = 0.0
    qw = quantize_weight(w)
    return x, qw["q"], qw["scale"], dequantize(qw, dtype)


def kernel_cases(torch, dtype, gen):
    """(name, label, kernel_fn, plain_fn, library_fn or None, input_sets,
    bytes, flops[, {reference name: fn}]) at the GPT2_SMALL_32K serving
    shapes: 8 slots x 12 heads x d 64, ctx 1024, prefill buckets 16..1024,
    paged blocks of 16 (64 a slot), prefill chunks of 256, d_model 768,
    d_ff 2048, vocab 32000."""
    from bpe_transformer_tpu_torch.kernels import decode_attention as da
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import swiglu as sw
    from bpe_transformer_tpu_torch.models.decode import gather_paged_kv

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
    # paged decode attention: one tick of 8 slots x 12 heads through
    # shuffled tables, blocks of 16, 64 blocks a slot, the same ragged
    # frontiers; act-width pools, and int8 pools under bf16 q.  No one
    # PyTorch call attends through a block table (library null); the dense
    # kernel on the gathered cache is timed beside it for reference.
    S, H, bs, nbs = 8, 12, 16, 64
    for kv_int8 in (False, True) if dtype == torch.bfloat16 else (False,):
        kv_isz = 1 if kv_int8 else isz
        live_blocks = int(((pos // bs) + 1).sum())
        nbytes = (live * H * d * 2 * kv_isz + 2 * S * H * d * isz + S * 4 + live_blocks * 4
                  + (live_blocks * H * 2 * 4 if kv_int8 else 0))
        sets = [paged_inputs(torch, gen, S, H, H, bs, nbs, d, dtype, kv_int8, pos=pos)
                for _ in range(copies_for((S * nbs + 1) * H * bs * d * 2 * kv_isz))]

        def dense_on_gathered(q, k, v, t, p, ks, vs):
            return da.decode_attention(q, gather_paged_kv(k, t), gather_paged_kv(v, t), p)

        cases.append((
            "paged_decode_attention",
            f"S={S} H=KV={H} bs={bs} nbs={nbs} d={d} {'int8' if kv_int8 else 'act'} KV",
            lambda q, k, v, t, p, ks, vs: da.paged_decode_attention(
                q, k, v, t, p, k_scale=ks, v_scale=vs),
            da.paged_decode_attention_plain, None, sets, nbytes, 4 * live * H * d,
            {} if kv_int8 else {"dense_kernel_on_gathered_ms": dense_on_gathered},
        ))
    # int8 matmul: the tick (m = slots) and a prefill chunk (m = 256), for
    # every matrix shape of the model.
    for m in (8, 256):
        for k_in, n_out in ((768, 768), (768, 2048), (2048, 768), (768, 32000)):
            cases.append(quant_case(torch, gen, m, k_in, n_out, dtype))
    return cases


def quant_case(torch, gen, m, k_in, n_out, dtype) -> tuple:
    """The int8 matmul's case tuple (as :func:`kernel_cases`) at ``m`` rows
    of ``k_in -> n_out``; the library call is the product at x's dtype
    against the weight dequantized once beforehand."""
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm

    isz = torch.tensor([], dtype=dtype).element_size()
    sets = [quant_inputs(torch, gen, m, k_in, n_out, dtype)
            for _ in range(copies_for(n_out * k_in))]
    return (
        "quant_matmul", f"m={m} {k_in}->{n_out}",
        lambda x, q, s, w: qm.quant_matmul(x, q, s),
        lambda x, q, s, w: qm.quant_matmul_plain(x, q, s),
        lambda x, q, s, w: torch.matmul(x, w.t()),
        sets, m * k_in * isz + n_out * k_in + n_out * 4 + m * n_out * 4,
        2 * m * n_out * k_in,
    )


def check_other_shapes(torch) -> None:
    """Kernel vs plain at shapes off the main path that the kernels take:
    every head dim and GQA group size they instantiate, head dims between
    them (96) and above them (320, 512: output-column chunks), groups that
    are no power of two (3, 12), ragged ctx and S,
    d_ff not a multiple of the SwiGLU slice (TINYSTORIES_4L's 683), the
    widest SwiGLU register tile (d_model 2048) and wider models (2500, 4096),
    paged blocks of 8 to 64 with a slot on the trash block, and int8 weight
    rows that are not a multiple of 16 bytes.  Correctness only."""
    from bpe_transformer_tpu_torch.kernels import decode_attention as da
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")

        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

        cases = []
        # The last six are shapes the kernels once refused: head dims 96 and
        # 256 (padded to the next register width), groups of 12 and 3, and
        # head dims 320 and 512 (output-column chunks of 256) in groups of 3.
        for B, H, KV, ctx, d in ((3, 4, 4, 77, 16), (2, 8, 4, 200, 32), (2, 8, 1, 300, 128),
                                 (4, 16, 2, 64, 64), (2, 4, 4, 128, 96), (2, 12, 1, 100, 64),
                                 (3, 6, 2, 77, 32), (2, 16, 1, 50, 256), (2, 6, 2, 77, 320),
                                 (2, 6, 2, 50, 512)):
            pos = torch.randint(0, ctx, (B,), generator=gen, device="cuda")
            if d == 96:
                pos = torch.tensor([5, 100], device="cuda")
            cases.append(("decode_attention", f"B={B} H={H} KV={KV} ctx={ctx} d={d}",
                          da.decode_attention, da.decode_attention_plain,
                          (rnd(B, H, d), rnd(B, KV, ctx, d), rnd(B, KV, ctx, d), pos)))
        for shape in ((2, 3, 77, 16), (1, 2, 200, 32), (2, 1, 300, 128), (2, 64, 96),
                      (1, 2, 130, 256), (1, 2, 70, 320), (1, 1, 40, 512)):
            cases.append(("flash_attention", f"{shape}", fa.flash_attention,
                          fa.flash_attention_plain, tuple(rnd(*shape) for _ in range(3))))
        for m, dm, ff in ((5, 256, 683), (37, 64, 200), (3, 2048, 96), (5, 4096, 96),
                          (3, 2500, 200)):
            cases.append(("swiglu", f"m={m} d={dm} ff={ff}", sw.swiglu_fused, sw.swiglu_plain,
                          (rnd(m, dm), rnd(ff, dm, std=0.02), rnd(dm, ff, std=0.02),
                           rnd(ff, dm, std=0.02))))
        # Paged decode: GQA groups 2, 4 and 8, head dims 16, 32 and 128,
        # blocks of 8, 32 and 64, act and int8 pools, the last slot on trash;
        # head dims 320 and 512 in groups of 3.
        for S, H, KV, bs, nbs, d in ((3, 8, 4, 8, 16, 16), (4, 16, 4, 32, 8, 32),
                                     (2, 16, 2, 64, 4, 128), (5, 8, 1, 8, 8, 64),
                                     (2, 4, 4, 16, 8, 96), (3, 12, 1, 16, 4, 64),
                                     (3, 6, 2, 8, 8, 32), (2, 8, 2, 16, 4, 256),
                                     (2, 6, 2, 16, 4, 320), (2, 6, 2, 8, 6, 512)):
            for kv_int8 in (False, True):
                q, k, v, tb, ps, ks, vs = paged_inputs(torch, gen, S, H, KV, bs, nbs, d, dtype,
                                                       kv_int8, trash_slot=True)
                ps[0] = nbs * bs - 1
                cases.append((
                    "paged_decode_attention",
                    f"S={S} H={H} KV={KV} bs={bs} d={d} {'int8' if kv_int8 else 'act'}",
                    lambda q, k, v, t, p, ks, vs: da.paged_decode_attention(
                        q, k, v, t, p, k_scale=ks, v_scale=vs),
                    da.paged_decode_attention_plain, (q, k, v, tb, ps, ks, vs)))
        # int8 matmul: rows of 683 and 1365 bytes (d_ff of TINYSTORIES_4L
        # and GPT2_MEDIUM's 12-layer kin), m 1 and 1000, ragged d_out; in
        # bf16 the last six run on the tensor cores at each block width
        # (8 to 64 rows) with and without a split K axis, the last with a
        # partial 128-column K slice.
        for m, k_in, n_out in ((1, 683, 256), (37, 683, 300), (5, 1365, 768), (1000, 64, 100),
                               (1000, 768, 77), (13, 1024, 300), (30, 4096, 520),
                               (40, 768, 2048), (64, 256, 64), (9, 400, 130)):
            x, q, s, _ = quant_inputs(torch, gen, m, k_in, n_out, dtype)
            cases.append(("quant_matmul", f"m={m} {k_in}->{n_out}", qm.quant_matmul,
                          qm.quant_matmul_plain, (x, q, s)))
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
    quant_bytes_exact(torch)


def quant_bytes_exact(torch) -> None:
    """The tensor-core int8 matmul's widening of every int8 byte value to
    bf16, held exactly: x = I (bf16) against q holding all 256 values,
    scale 1, so y = q^T must come out bit for bit, with the K axis split
    (m 64) and whole (m 256)."""
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm

    k_in, n_out = 256, 256
    idx = torch.arange(n_out, device="cuda")[:, None] + torch.arange(k_in, device="cuda")[None, :]
    q = (idx % 256 - 128).to(torch.int8)
    scale = torch.ones(n_out, device="cuda")
    for m in (64, 256):
        x = torch.eye(m, k_in, device="cuda", dtype=torch.bfloat16)
        require(qm.quant_path(m, k_in, x.dtype) == "tensor_cores", "quant_path: bf16 not on wgmma")
        y = qm.quant_matmul(x, q, scale)
        torch.cuda.synchronize()
        require(torch.equal(y, q[:, :m].t().float()),
                f"quant_matmul m={m}: int8 bytes not widened exactly "
                f"({int((y != q[:, :m].t().float()).sum())} of {y.numel()} differ)")
    log("quant_matmul tensor cores: all 256 int8 byte values widened exactly (m 64 split, 256)")


def measure_case(torch, dtype, case) -> dict:
    """One case of :func:`kernel_cases`: the kernel against its plain
    version on two input sets (max error against ``TOL``), then kernel,
    plain and library times by CUDA-graph replay, the kernel also as
    enqueued from Python, and the bound.  Returns the row."""
    name, label, kern, plain, lib, sets, nbytes, flops, *refs = case
    dname = str(dtype).removeprefix("torch.")
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
    ms = time_ms(torch, kern, sets, iters, graph=True)
    loop_ms = time_ms(torch, kern, sets, iters)
    plain_ms = time_ms(torch, plain, sets, max(5, iters // 5), graph=True)
    lib_ms = time_ms(torch, lib, sets, iters, graph=True) if lib is not None else None
    byte_ms = nbytes / HBM_BYTES_S * 1e3
    op_ms = flops / PEAK_FLOPS[dname] * 1e3
    row = {
        "name": name, "dtype": dname, "shape": label,
        "max_abs_err": err, "tol": tol, "ms": ms, "loop_ms": loop_ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "bytes": nbytes, "flops": flops,
    }
    for ref_name, ref_fn in (refs[0] if refs else {}).items():
        row[ref_name] = time_ms(torch, ref_fn, sets, iters, graph=True)
    lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
    extra = "".join(f" {k} {row[k]:.4f}" for k in (refs[0] if refs else {}))
    log(
        f"kernel {name:22s} {dname:8s} {label:40s} err {err:.3e} (tol {tol:g}) "
        f"ms {ms:.4f} (enqueued from Python {loop_ms:.4f}) plain {plain_ms:.4f} "
        f"library {lib} bound {row['bound_ms']:.4f} ({row['bound_by']}){extra}"
    )
    require(err <= tol, f"{name} {dname} {label}: max error {err:.3e} > {tol:g}")
    return row


def crossover_sweep(torch, name: str, label: str, sets_for, run, plain, tol: float,
                    rule: str) -> list[dict]:
    """A kernel's two designs side by side in bf16 from 1 to 256 rows
    (``run(*inputs, path=...)``, CUDA-graph replays of ``sets_for(m)``,
    inputs cycled past the L2), each held against ``plain``; logs the
    crossover m, the fewest rows from which the tensor cores are at least
    as fast at every larger m of the sweep, beside the wrapper's ``rule``."""
    rows = []
    for m in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        sets = sets_for(m)
        row = {"name": name, "dtype": "bfloat16", "shape": f"m={m} {label}"}
        for path in ("tensor_cores", "cuda_cores"):
            def fwd(*inputs, path=path):
                return run(*inputs, path=path)

            err = _max_err(fwd(*sets[0]), plain(*sets[0]))
            require(err <= tol, f"{name} {path} m={m}: max error {err:.3e} > {tol:g}")
            row[f"{path}_ms"] = time_ms(torch, fwd, sets, 50, graph=True)
            row[f"{path}_err"] = err
        rows.append(row)
        log(f"{name} crossover bf16 m={m:4d} {label}: tensor cores {row['tensor_cores_ms']:.4f} "
            f"ms (err {row['tensor_cores_err']:.2e}), CUDA cores {row['cuda_cores_ms']:.4f} ms "
            f"(err {row['cuda_cores_err']:.2e})")
    wins = [r["tensor_cores_ms"] <= r["cuda_cores_ms"] for r in rows]
    first = next((i for i in range(len(rows)) if all(wins[i:])), None)
    crossover = None if first is None else int(rows[first]["shape"].split()[0][2:])
    log(f"{name} crossover m: {crossover} ({rule})")
    return rows


def swiglu_crossover(torch, gen) -> list[dict]:
    """The SwiGLU forward's two designs at the GPT2_SMALL_32K widths (d 768,
    d_ff 2048); the wrapper takes the tensor cores at every m."""
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    dm, ff, dtype = 768, 2048, torch.bfloat16

    def sets_for(m):
        return [tuple((torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)
                      for shape, std in (((m, dm), 1.0), ((ff, dm), 0.02), ((dm, ff), 0.02),
                                         ((ff, dm), 0.02)))
                for _ in range(copies_for(3 * ff * dm * 2))]

    return crossover_sweep(torch, "swiglu", f"d={dm} ff={ff}", sets_for, sw._swiglu_forward,
                           sw.swiglu_plain, TOL_BF16,
                           "the wrapper takes the tensor cores at every m")


def quant_crossover(torch, gen) -> list[dict]:
    """The int8 matmul's two designs with bf16 x at 768 -> 2048;
    :func:`quant_path` takes the tensor cores at every m."""
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm

    k_in, n_out = 768, 2048

    def sets_for(m):
        return [quant_inputs(torch, gen, m, k_in, n_out, torch.bfloat16)[:3]
                for _ in range(copies_for(n_out * k_in))]

    return crossover_sweep(torch, "quant_matmul", f"{k_in}->{n_out}", sets_for, qm.quant_matmul,
                           qm.quant_matmul_plain, TOL[("quant_matmul", "bfloat16")],
                           "quant_path takes the tensor cores at every m")


def phase_kernels(torch) -> dict:
    """Kernel vs plain on the card.  Returns the bf16 rows of the main-path
    representatives, keyed by kernel name."""
    check_other_shapes(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_cases(torch, dtype, gen):
            rows.append(measure_case(torch, dtype, case))
    rows += swiglu_crossover(torch, gen)
    rows += quant_crossover(torch, gen)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_kernels.json").write_text(json.dumps(rows, indent=1))
    main_shapes = {
        "decode_attention": "KV=12 ",
        "flash_attention": "S=1024",
        "swiglu": "m=8 ",
        "paged_decode_attention": "int8 KV",
        "quant_matmul": "m=8 768->2048",
    }
    return {
        r["name"]: r for r in rows
        if r["dtype"] == "bfloat16" and main_shapes[r["name"]] in r["shape"] and "ms" in r
    }


# ------------------------------------------------------------ phase 3


def reset_counts() -> None:
    from bpe_transformer_tpu_torch.kernels import _build

    _build.reset_launches()


def read_counts(names=SERVING_KERNELS) -> dict:
    from bpe_transformer_tpu_torch.kernels import _build

    return _build.read_launches(names)


def only(**launches) -> dict:
    """Expected launch counts: ``launches`` and 0 for every other kernel."""
    return {name: launches.get(name, 0) for name in KERNEL_META}


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
    from bpe_transformer_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(GPT2_SMALL_32K, **KERNEL_KNOBS)
    plain_cfg = dataclasses.replace(GPT2_SMALL_32K)  # every knob "xla"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    log(f"GPT2_SMALL_32K init: {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(1)
    full_width_reference(torch, params, cfg, plain_cfg, rng, "full-width")
    requests = dense_mix(rng, cfg.vocab_size)
    run = serve_dense(torch, params, cfg, requests, "full-width serving")
    counts, ticks = run["counts"], run["ticks"]
    L, P = cfg.num_layers, len(requests)
    expected = only(decode_attention=L * ticks, flash_attention=L * P, swiglu=L * (ticks + P))
    require(counts == expected, f"launch counts {counts} != expected {expected}")
    from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine

    profile_ticks(torch, SlotPoolEngine(params, cfg, slots=8, device="cuda"), cfg, rng, "dense")
    return {name: counts[name] for name in SERVING_KERNELS}, requests


def full_width_reference(torch, params, cfg, plain_cfg, rng, label: str,
                         plain_route=contextlib.nullcontext) -> None:
    """Reference check at full width: one 100-token prefill and one decode
    step through the kernels (``cfg``) vs the plain versions (``plain_cfg``,
    under ``plain_route``), in float32."""
    import dataclasses

    from bpe_transformer_tpu_torch.models.decode import decode_step, init_kv_cache, prefill

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 100)), device="cuda")
    outs = {}
    with torch.inference_mode():
        for mode, c in (("kernels", cfg), ("plain", plain_cfg)):
            c32 = dataclasses.replace(c, activation_dtype="float32")
            cache = init_kv_cache(c32, 1, device="cuda")
            with plain_route() if mode == "plain" else contextlib.nullcontext():
                lp, _ = prefill(params, prompt, c32, cache)
                ld, _ = decode_step(params, torch.argmax(lp, -1), 100, cache, c32)
            outs[mode] = (lp, ld)
    err = max((a - b).abs().max().item() for a, b in zip(outs["kernels"], outs["plain"]))
    scale = outs["plain"][0].abs().max().item()
    log(f"{label} float32 logits, kernels vs plain: max err {err:.3e} "
        f"(|logits| max {scale:.3e}, tol 1e-4)")
    require(err <= 1e-4, f"{label} logits differ by {err:.3e}")


def dense_mix(rng, vocab: int) -> list:
    """Phase 4's 16 requests: prompts of 16 to 900 tokens, half greedy, half
    temperature 0.8 / top-k 50 / top-p 0.95, 64 new tokens each."""
    from bpe_transformer_tpu_torch.serving.server import Request

    lengths = [16, 40, 100, 200, 300, 450, 600, 750, 900, 17, 64, 129, 257, 513, 800, 33]
    requests = []
    for i, n in enumerate(lengths):
        knobs = {"temperature": 0.0} if i % 2 == 0 else {
            "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": i}
        requests.append(Request(
            prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, size=n)),
            max_new_tokens=64, **knobs,
        ))
    return requests


def serve_dense(torch, params, cfg, requests, label: str) -> dict:
    """Serve ``requests`` through a dense ``ServingEngine`` with 8 slots,
    every launch count reset after a warm-up request; every request must
    finish at 64 tokens.  Returns the results, counts of every kernel,
    ticks, wall time and peak memory."""
    from bpe_transformer_tpu_torch.serving.server import ServingEngine

    with ServingEngine(params, cfg, slots=8, device="cuda") as serving:
        # Warm up outside the counted run (cuBLAS handles, allocator pools).
        serving.generate(list(range(20)), max_new_tokens=4, temperature=0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ticks0 = serving.engine.ticks
        reset_counts()
        t0 = time.perf_counter()
        handles = [serving.submit(r) for r in requests]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(tuple(KERNEL_META))
        ticks = serving.engine.ticks - ticks0
        peak = torch.cuda.max_memory_allocated()
    n_tokens = sum(len(r.token_ids) for r in results)
    prefill_s = sum(r.prefill_s for r in results)  # the worker admits one at a time
    log(f"{label}: {len(results)} requests, {n_tokens} tokens in {wall:.3f} s "
        f"= {n_tokens / wall:.1f} tok/s; {len(results)} prefills {prefill_s:.3f} s, "
        f"{ticks} ticks {wall - prefill_s:.3f} s; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {counts}")
    for req, res in zip(requests, results):
        require(res.finish_reason == "length" and len(res.token_ids) == 64,
                f"{label} request {req.request_id}: {res.finish_reason} after "
                f"{len(res.token_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in res.token_ids), "token id out of range")
    return {"results": results, "counts": counts, "ticks": ticks, "wall": wall,
            "tokens": n_tokens, "peak": peak}


def fill_slots(torch, engine, vocab: int, rng) -> None:
    """Admit 8 requests (prompts of 16 to 900 tokens, half greedy, half
    sampled, 100 new tokens each) into ``engine``'s 8 slots and run 3
    ticks."""
    for i, n in enumerate((16, 100, 200, 300, 450, 600, 750, 900)):
        knobs = {"temperature": 0.0} if i % 2 == 0 else {"temperature": 0.8, "top_k": 50}
        engine.admit(rng.integers(0, vocab, size=n), max_new_tokens=100, **knobs)
    for _ in range(3):
        engine.tick()
    torch.cuda.synchronize()


def profile_ticks(torch, engine, cfg, rng, label: str, n_ticks: int = 10) -> dict:
    """Where a full-width tick's time goes: the host-clock time of a tick
    of ``engine`` (8 slots) with all 8 slots busy, and, from a
    ``torch.profiler`` trace of as many more ticks, the device time per
    tick by kernel and the device's idle share of the tick."""
    from torch.profiler import ProfilerActivity, profile

    fill_slots(torch, engine, cfg.vocab_size, rng)
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
        log(f"{label} tick profile: {tick_us:.0f} us per tick (host clock); device time not "
            "measured (the profiler recorded no device events)")
        return {"host_us": tick_us, "device_us": None}
    launches = sum(n for _, n in by_name.values()) / n_ticks
    log(f"{label} tick profile (8 slots busy): {tick_us:.0f} us per tick (host clock), device "
        f"busy {busy_us:.0f} us per tick in {launches:.0f} launches, idle share "
        f"{1 - busy_us / tick_us:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {us:9.1f} us/tick  {n // n_ticks:4d} launches/tick  {name[:90]}")
    return {"host_us": tick_us, "device_us": busy_us}


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
    "S 64 d 96 (padded)": (2, 2, 64, 96),
    "ragged S 130 d 256": (1, 2, 130, 256),
    "ragged S 70 d 320 (chunks)": (1, 2, 70, 320),
    "S 40 d 512 (chunks)": (1, 1, 40, 512),
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
    again = fa._backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
            f"{dname} {tuple(q.shape)}: two backward calls on the same inputs differ")
    errs = {
        "flash_attention": _max_err(out, ref_out),
        "lse": _max_err(lse, ref_lse.reshape(lse.shape)),
        "flash_attention_bwd_dkdv": max(_max_err(dk, ref_grads[1]), _max_err(dv, ref_grads[2])),
        "flash_attention_bwd_dq": _max_err(dq, ref_grads[0]),
    }
    limits = {"flash_attention": tol["out"], "lse": tol["lse"],
              "flash_attention_bwd_dkdv": tol["grad"], "flash_attention_bwd_dq": tol["grad"]}

    # The RoPE forward's lse, held to the float32 statistic's tolerance in
    # bf16 too (the kernel keeps the rotated tiles above bf16 precision).
    _, rlse = fa._forward(q, k, v, cos, sin, with_lse=True)
    _, ref_rlse = fa.flash_attention_rope_plain(q, k, v, cos, sin, return_lse=True)
    errs["rope_lse"] = _max_err(rlse, ref_rlse.reshape(rlse.shape))
    limits["rope_lse"] = tol["lse"]

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
    # The backward kernels run at backward_width (bf16 d 32 at 64, as
    # _backward pads it), timed on inputs padded to it.
    width = fa.backward_width(d, dtype)
    sets = []
    for _ in range(copies_for(4 * elems * isz)):
        q, k, v, g, cos, sin = training_inputs(torch, shape, dtype, gen)
        out, lse = fa._forward(q, k, v, with_lse=True)
        delta = (g.float() * out.float()).sum(-1).reshape(bh, s).contiguous()
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        qp, kp, vp, gp = (fa._pad_head(t, width) for t in (q, k, v, g))
        sets.append(dict(q=q, k=k, v=v, g=g, cos=cos, sin=sin, out=out, lse=lse, delta=delta,
                         qq=qq, kk=kk, vv=vv, sdpa_out=sdpa_out, qp=qp, kp=kp, vp=vp, gp=gp))

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
         lambda t: fa._launch_bwd("dkdv", t["qp"], t["kp"], t["vp"], t["gp"], t["lse"],
                                  t["delta"], d=d),
         lambda t: fa.flash_attention_bwd_dkdv_plain(t["q"], t["k"], t["v"], t["out"], t["lse"],
                                                     t["g"]),
         sdpa_bwd, 6 * elems * isz + 2 * bh * s * 4, 8 * d * pairs, "dK, dV"),
        ("flash_attention_bwd_dq",
         lambda t: fa._launch_bwd("dq", t["qp"], t["kp"], t["vp"], t["gp"], t["lse"], t["delta"],
                                  d=d),
         lambda t: fa.flash_attention_bwd_dq_plain(t["q"], t["k"], t["v"], t["out"], t["lse"],
                                                   t["g"]),
         sdpa_bwd, 5 * elems * isz + 2 * bh * s * 4, 6 * d * pairs, "dQ"),
    ]
    iters = 10 if s >= 1024 else 30
    one = [(t,) for t in sets]
    sdpa_fb_ms = time_ms(torch, sdpa_fwd_bwd, one, iters)
    # PyTorch's flash backward (bf16) as one call, by graph replay: the
    # device-time yardstick of the two backward kernels together.
    lib_bwd_dev = None
    if dtype == torch.bfloat16:
        aten = torch.ops.aten

        def flash_bwd(t):
            o, l_, cq, ck, mq, mk, seed, offset, _ = t["flash"]
            return aten._scaled_dot_product_flash_attention_backward(
                t["g"], t["q"], t["k"], t["v"], o, l_, cq, ck, mq, mk, 0.0, True, seed, offset)

        try:
            for t in sets:
                t["flash"] = aten._scaled_dot_product_flash_attention(t["q"], t["k"], t["v"],
                                                                      0.0, True)
            lib_bwd_dev = time_ms(torch, flash_bwd, one, iters, graph=True)
        except (RuntimeError, TypeError) as exc:
            log(f"library flash backward not timed at {shape}: {str(exc).splitlines()[0]}")
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
        # The kernel without its Python enqueue (which the events above
        # include): device time by CUDA-graph replay.
        rows[-1]["device_ms"] = time_ms(torch, kern, one, iters, graph=True)
        if "bwd" in name:
            rows[-1]["library_device_ms"] = lib_bwd_dev
    return rows


def swiglu_training_timings(torch, gen) -> list[dict]:
    """The SwiGLU forward kernel at the training ``m`` (batch x sequence) of
    GPT2_SMALL_32K (bf16, m 8192) and TINYSTORIES_4L (float32, m 4096):
    kernel / plain / library ms (the library call is the composition phase 2
    times) and the bound, operations 6 m d d_ff at the dtype's peak."""
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    F = torch.nn.functional
    rows = []
    for config, m, dm, ff, dtype in (("GPT2_SMALL_32K", 8192, 768, 2048, torch.bfloat16),
                                     ("TINYSTORIES_4L", 4096, 256, 683, torch.float32)):
        dname = str(dtype).removeprefix("torch.")
        isz = torch.tensor([], dtype=dtype).element_size()

        def rnd(*shape, std=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

        sets = [(rnd(m, dm), rnd(ff, dm, std=0.02), rnd(dm, ff, std=0.02), rnd(ff, dm, std=0.02))
                for _ in range(copies_for((2 * m * dm + 3 * ff * dm) * isz))]
        out = sw._swiglu_forward(*sets[0])
        torch.cuda.synchronize()
        err = _max_err(out, sw.swiglu_plain(*sets[0]))
        tol = TOL.get(("swiglu", dname), TOL_BF16)
        require(err <= tol, f"swiglu {config} m={m}: max error {err:.3e} > {tol:g}")
        nbytes, flops = (2 * m * dm + 3 * ff * dm) * isz, 6 * m * dm * ff
        byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
        row = {
            "name": "swiglu", "config": config, "dtype": dname,
            "shape": f"m={m} d={dm} ff={ff} forward", "max_abs_err": err,
            "ms": time_ms(torch, sw._swiglu_forward, sets, 5),
            "plain_ms": time_ms(torch, sw.swiglu_plain, sets, 3),
            "library_ms": time_ms(
                torch, lambda x, w1, w2, w3: F.linear(F.silu(F.linear(x, w1)) * F.linear(x, w3), w2),
                sets, 5),
            "bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"kernel swiglu {dname:8s} {config} {row['shape']:30s} err {err:.3e} ms {row['ms']:.4f} "
            f"plain {row['plain_ms']:.4f} library {row['library_ms']:.4f} "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        rows.append(row)
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
                dev = f" (device {row['device_ms']:.4f})"
                if row.get("library_device_ms") is not None:
                    lib += f" (flash backward, device {row['library_device_ms']:.4f})"
                log(f"kernel {row['name']:24s} {dname:8s} {row['shape']:44s} "
                    f"ms {row['ms']:.4f}{dev} plain {row['plain_ms']:.4f} library {lib} "
                    f"(SDPA fwd+bwd {row['sdpa_fwd_bwd_ms']:.4f}) "
                    f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        log(f"training kernels {dname}: largest errors {worst}")
    rows += swiglu_training_timings(torch, gen)
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

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K

    cfg = dataclasses.replace(
        GPT2_SMALL_32K, attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas",
        remat_policy="save_attn",
    )
    L = cfg.num_layers
    per_step = only(flash_attention_rope=L, flash_attention_bwd_dkdv=L,
                    flash_attention_bwd_dq=L, swiglu=2 * L)
    run = train_full_width(torch, smi, cfg, per_step, "GPT2_SMALL_32K")
    return {name: per_step[name] * len(run["losses"]) for name in TRAINING_KERNELS}


def train_full_width(torch, smi: str, cfg, per_step: dict, label: str) -> dict:
    """10 AdamW steps of ``cfg`` from the port's seeded init on one seeded
    batch of 8 full contexts; every step's launch counts must be
    ``per_step``; the loss must fall; host ms per step, peak memory and a
    step profile."""
    import numpy as np

    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

    batch, n_steps = 8, 10
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt_state = adamw_init(params)
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=n_steps)
    step = make_train_step(cfg, hparams)
    rng = np.random.default_rng(8)
    x, y = (torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, cfg.context_length)),
                            device="cuda") for _ in range(2))
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
        require(counts == per_step, f"{label}: launch counts of one step {counts} != {per_step}")
    peak = torch.cuda.max_memory_allocated()
    mean_ms = float(np.mean(host_ms[1:]))
    log(f"{label} training (bf16 activations, B={batch} S={cfg.context_length}, "
        f"save_attn, RoPE in kernel): losses {[round(v, 4) for v in losses]}")
    log(f"{label} host ms per step {[round(v, 1) for v in host_ms]} (steps 2-10 mean "
        f"{mean_ms:.1f} ms = {batch * cfg.context_length / mean_ms * 1e3:.0f} tok/s); "
        f"peak memory {peak / 2**30:.2f} GiB on {smi}; launches per step "
        f"{ {k: v for k, v in per_step.items() if v} }")
    require(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss: {losses}")
    require(losses[-1] < losses[0],
            f"{label}: loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    profile_step(torch, label, lambda: step(params, opt_state, x, y))
    return {"losses": losses, "host_ms": host_ms, "peak": peak}


# ------------------------------------------------------------ phase 9

PAGED_KNOBS = dict(KERNEL_KNOBS, decode_attention_impl="paged")
#: (label, kv_dtype, weight_dtype) of the paged serving runs.
PAGED_WIDTHS = (("act", None, None), ("int8 KV", "int8", None), ("int8 KV + int8 weights", "int8", "int8"))


@contextlib.contextmanager
def plain_quant_matmul():
    """Route the int8 matmul to its plain version on the card (the
    reference run of phase 9b); nothing else changes."""
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm

    kernel = qm.quant_matmul
    qm.quant_matmul = qm.quant_matmul_plain
    try:
        yield
    finally:
        qm.quant_matmul = kernel


def phase_paged_fixture(torch) -> None:
    """The trained fixture in float32 served by the paged engine on the card
    at act width, with int8 KV blocks, and with int8 KV and int8 weights:
    greedy tokens identical to the same run on the CPU, and at act width to
    the dense engine's on the card."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
    from bpe_transformer_tpu_torch.models.transformer import params_from_state_dict
    from bpe_transformer_tpu_torch.serving.server import ServingEngine

    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    sd = {k: v for k, v in arrays.items() if not k.startswith("pin/")}
    cfg = dataclasses.replace(TS_TEST_CONFIG, **PAGED_KNOBS)
    ids = arrays["pin/input_ids"]
    rng = np.random.default_rng(3)
    prompts = [list(ids[i, : 3 + 3 * i]) for i in range(4)]
    prompts += [list(ids[0, :8]) + [int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
                for n in (1, 4, 7)]  # a shared two-block prefix

    def serve(device, **kw):
        with ServingEngine(params_from_state_dict(sd, cfg.num_layers, device=device), cfg,
                           slots=3, min_bucket=8, device=device, **kw) as serving:
            results = serving.run_batch(prompts, max_new_tokens=16, temperature=0.0)
        return [list(r.token_ids) for r in results]

    dense = serve("cuda")
    reset_counts()
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS:
        kw = dict(paged=True, block_size=4, prefill_chunk=8, kv_dtype=kv_dtype,
                  weight_dtype=weight_dtype)
        card, cpu = serve("cuda", **kw), serve("cpu", **kw)
        log(f"fixture paged {label}: greedy tokens (card) {card}")
        require(card == cpu, f"paged {label}: card tokens {card} differ from cpu {cpu}")
        if kv_dtype is None:
            require(card == dense, f"paged act tokens {card} differ from dense {dense}")
    counts = read_counts(PAGED_KERNELS)
    log(f"fixture paged launches: {counts}")
    require(all(n > 0 for n in counts.values()), f"a kernel was not launched: {counts}")


def phase_paged_full_width(torch, smi: str) -> dict:
    """GPT2_SMALL_32K paged serving at full depth and width: the chunked
    prefill and a paged decode step held against the plain versions in
    float32, then a paged ServingEngine on a mixed load with a shared
    prefix, at int8 KV + int8 weights and at act width, with exact launch
    counts, and a tick profile of each.  Returns the int8 run's counts of
    the paged kernels, the requests, and the act run's results (phase 10c
    serves the same mix)."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.decode import (
        init_kv_pool,
        paged_chunk_prefill,
        paged_decode_step,
    )
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.serving.engine import prepare_serving_weights
    from bpe_transformer_tpu_torch.serving.kvpool import PagedEngine

    cfg = dataclasses.replace(GPT2_SMALL_32K, **PAGED_KNOBS)
    plain_cfg = dataclasses.replace(GPT2_SMALL_32K)  # every knob "xla"
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    L, bs = cfg.num_layers, 16
    nbs = cfg.context_length // bs

    # (b) A 300-token prompt in two chunks (256 + 44) and one decode step,
    # kernels vs plain versions, float32.
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, size=300)
    tables = torch.zeros((1, nbs), dtype=torch.int32, device="cuda")
    tables[0, :20] = torch.randperm(40, device="cuda")[:20] + 1
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS[::2]:
        outs = {}
        for mode, c in (("kernels", cfg), ("plain", plain_cfg)):
            c32 = dataclasses.replace(c, activation_dtype="float32")
            p32, head, *_ = prepare_serving_weights(params, c32, weight_dtype, "cuda")
            pool = init_kv_pool(c32, 41, bs, kv_dtype=kv_dtype, device="cuda")
            with torch.inference_mode(), (
                    plain_quant_matmul() if mode == "plain" else contextlib.nullcontext()):
                got = []
                for start, n, bucket in ((0, 256, 256), (256, 44, 64)):
                    chunk = np.zeros((1, bucket), np.int64)
                    chunk[0, :n] = prompt[start:start + n]
                    logits, _ = paged_chunk_prefill(
                        p32, torch.as_tensor(chunk, device="cuda"), start, n, tables[0], pool,
                        c32, lm_head=head, block_size=bs)
                    got.append(logits)
                logits, _ = paged_decode_step(
                    p32, torch.argmax(got[-1], -1), torch.tensor([300], device="cuda"), pool,
                    tables, c32, lm_head=head, block_size=bs)
                outs[mode] = got + [logits]
        err = max((a - b).abs().max().item() for a, b in zip(outs["kernels"], outs["plain"]))
        tol = PAGED_LOGIT_TOL[label]
        log(f"full-width paged float32 {label}: chunk + chunk + decode logits, kernels vs plain: "
            f"max err {err:.3e} (|logits| max {outs['plain'][0].abs().max().item():.3e}, "
            f"tol {tol:g})")
        require(err <= tol, f"full-width paged {label} logits differ by {err:.3e}")

    # (c) The paged ServingEngine: 16 requests, 8 of them a shared 512-token
    # prefix and a suffix of their own, half greedy, half top-k 50 / top-p
    # 0.95, 64 new tokens each, a pool of four full contexts' blocks.
    requests = paged_mix(rng, cfg.vocab_size)
    int8_counts, act_results = None, None
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS[::-2]:
        run = serve_mix(torch, params, cfg, requests, smi, f"paged serving {label}",
                        kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        counts, steps = run["counts"], run["ticks"] + run["chunks"]
        if weight_dtype == "int8":
            expected = only(paged_decode_attention=L * run["ticks"],
                            quant_matmul=(7 * L + 1) * steps)
            int8_counts = {k: counts[k] for k in PAGED_KERNELS}
        else:
            expected = only(paged_decode_attention=L * run["ticks"], swiglu=L * steps)
            act_results = run["results"]
        require(counts == expected, f"{label}: launch counts {counts} != expected {expected}")

    # (d) A tick of each width with 8 slots busy.
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS[::-2]:
        engine = PagedEngine(params, cfg, slots=8, block_size=bs, prefill_chunk=256,
                             kv_dtype=kv_dtype, weight_dtype=weight_dtype, device="cuda")
        profile_ticks(torch, engine, cfg, rng, f"paged {label}")
        del engine
    return int8_counts, requests, act_results


def paged_mix(rng, vocab: int) -> list:
    """Phase 9c's 16 requests: 8 of them a shared 512-token prefix and a
    suffix of 16-388 tokens, the rest 17-900 tokens of their own; half
    greedy, half temperature 0.8 / top-k 50 / top-p 0.95; 64 new tokens."""
    from bpe_transformer_tpu_torch.serving.server import Request

    shared = [int(t) for t in rng.integers(0, vocab, size=512)]
    suffixes = iter((16, 40, 100, 160, 220, 280, 340, 388))
    own = iter((900, 800, 513, 257, 129, 64, 33, 17))
    requests = []
    for i in range(16):
        ids = (shared + [int(t) for t in rng.integers(0, vocab, size=next(suffixes))]
               if i % 2 == 0 else [int(t) for t in rng.integers(0, vocab, size=next(own))])
        knobs = {"temperature": 0.0} if (i // 2) % 2 == 0 else {
            "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": i}
        requests.append(Request(prompt_ids=tuple(ids), max_new_tokens=64, **knobs))
    return requests


def serve_mix(torch, params, cfg, requests, smi: str, label: str, on_engine=None,
              **engine_kw) -> dict:
    """Serve ``requests`` through a paged ``ServingEngine`` with phase 9c's
    pool (four full contexts), blocks of 16, chunks of 256 and a 512-token
    prefill budget, the first admission held until every request is queued
    (so the schedule repeats run to run).  Launch counts are reset after a
    warm-up request; every request must finish at 64 tokens.  Returns the
    results, counts, ticks, chunks, gauges and timings."""
    from bpe_transformer_tpu_torch.serving.kvpool import NoFreeBlocksError
    from bpe_transformer_tpu_torch.serving.server import ServingEngine

    bs = 16
    with ServingEngine(params, cfg, paged=True, slots=8, block_size=bs, prefill_chunk=256,
                       prefill_token_budget=512,
                       num_kv_blocks=4 * (cfg.context_length // bs) + 1, device="cuda",
                       **engine_kw) as serving:
        engine = serving.engine
        # Warm up outside the counted run (cuBLAS handles, allocator pools).
        serving.generate(list(range(20)), max_new_tokens=4, temperature=0.0)
        parked, chunks, all_queued = [], [0], threading.Event()
        begin, prefill_step = engine.begin, engine.prefill_step

        def counting_begin(prompt_ids, **kw):
            all_queued.wait(timeout=60)  # the first admissions see the whole load
            try:
                return begin(prompt_ids, **kw)
            except NoFreeBlocksError:
                parked.append(kw["request_id"])
                raise

        def counting_prefill_step(slot):
            chunks[0] += 1
            return prefill_step(slot)

        engine.begin, engine.prefill_step = counting_begin, counting_prefill_step
        if on_engine is not None:
            on_engine(engine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ticks0 = engine.ticks
        base_gauges = engine.gauges()
        reset_counts()
        t0 = time.perf_counter()
        handles = [serving.submit(r) for r in requests]
        all_queued.set()
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(tuple(KERNEL_META))
        ticks = engine.ticks - ticks0
        gauges = engine.gauges()
        peak = torch.cuda.max_memory_allocated()
        kv_pool_bytes, tick_bytes = engine.kv_pool_bytes, engine.tick_weight_bytes
    n_tokens = sum(len(r.token_ids) for r in results)
    log(f"{label}: {len(results)} requests, {n_tokens} tokens in {wall:.3f} s "
        f"= {n_tokens / wall:.1f} tok/s; {chunks[0]} chunks, {ticks} ticks; "
        f"{len(set(parked))} requests parked; prefix cache hits "
        f"{gauges['prefix_cache_hits'] - base_gauges['prefix_cache_hits']} tokens (rate "
        f"{gauges['prefix_hit_rate']}); kv_pool_bytes {kv_pool_bytes}, tick_weight_bytes "
        f"{tick_bytes}, peak memory {peak / 2**30:.2f} GiB on {smi}; launches {counts}")
    for req, res in zip(requests, results):
        require(res.finish_reason == "length" and len(res.token_ids) == 64,
                f"{label} request {req.request_id}: {res.finish_reason} after "
                f"{len(res.token_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in res.token_ids), "token id out of range")
    require(gauges["prefix_cache_hits"] > 0, f"{label}: no prefix-cache hit")
    require(parked, f"{label}: no request parked")
    return {"results": results, "counts": counts, "ticks": ticks, "chunks": chunks[0],
            "gauges": gauges, "wall": wall, "tokens": n_tokens}


# ------------------------------------------------------------ phase 10

SAMPLE_KERNELS = ("fused_head_sample", "fused_verify_head")
#: The fused tails' float32 logit workspace against the plain head_logits:
#: float32 products of the same values (bf16 and int8 widen exactly) summed in
#: another order than cuBLAS's, for logits of order 1, as the int8 matmul.
SAMPLE_LOGIT_TOL = 1e-4
#: p_d of the verify tail: tests/test_quant.py's bound for the TPU kernel.
PD_TOL = 2e-6
#: Per-row knobs (temperature, top_k, top_p) cycled over the rows: greedy,
#: temperature only, the serving mix, top-k 1 and 5, top-p 0.3 and 0 (the
#: argmax and its ties), top-k 40 with top-p 0.9.
KNOB_MIX = ((0.0, 0, 2.0), (1.0, 0, 2.0), (0.8, 50, 0.95), (1.3, 1, 0.5), (0.7, 5, 2.0),
            (1.0, 0, 0.3), (0.5, 0, 0.0), (1.0, 40, 0.9))
#: Phase 9c's serving mix: greedy and temperature 0.8 / top-k 50 / top-p 0.95.
SERVING_MIX = ((0.0, 0, 2.0), (0.8, 50, 0.95))


def sample_inputs(torch, gen, rows, vocab, d, dtype, head_kind, mix, copies=1):
    """``copies`` input sets for the fused tails: hidden (rows, d) at
    ``dtype`` (rms-normed scale), the head (std 0.02, at ``dtype`` or int8
    quantized, or float32 for ``head_kind="f32"``), knobs cycled from
    ``mix``, gumbel noise, and for verify a judged token and a softmax q per
    row; plus a (rows, vocab) float32 logit workspace."""
    from bpe_transformer_tpu_torch.ops.quant import quantize_weight

    dev = "cuda"
    knobs = [mix[i % len(mix)] for i in range(rows)]
    temps = torch.tensor([k[0] for k in knobs], device=dev)
    top_ks = torch.tensor([k[1] for k in knobs], dtype=torch.int32, device=dev)
    top_ps = torch.tensor([k[2] for k in knobs], device=dev)
    sets = []
    for _ in range(copies):
        w = torch.randn(vocab, d, generator=gen, device=dev) * 0.02
        head = (quantize_weight(w) if head_kind == "int8" else w if head_kind == "f32"
                else w.to(dtype))
        u = torch.rand(rows, vocab, generator=gen, device=dev).clamp(min=1e-20)
        sets.append(dict(
            hidden=torch.randn(rows, d, generator=gen, device=dev).to(dtype), head=head,
            temps=temps, top_ks=top_ks, top_ps=top_ps, gumbel=-torch.log(-torch.log(u)),
            judge=torch.randint(0, vocab, (rows,), generator=gen, device=dev, dtype=torch.int32),
            q=torch.softmax(torch.randn(rows, vocab, generator=gen, device=dev) * 2, dim=-1),
            ws=torch.empty(rows, vocab, device=dev),
        ))
    return sets


def nucleus_edge(logits, t, temp, top_k, top_p) -> bool:
    """Whether token ``t`` of one row sits at the nucleus edge of the plain
    filter: the sorted mass before it within 1e-5 of ``top_p`` (there the
    kernel's mass sum, taken in another order, may keep or drop it)."""
    import torch

    from bpe_transformer_tpu_torch.serving.engine import filter_logits

    row = logits[None].float()
    masked = filter_logits(row, torch.tensor([temp], device=row.device),
                           torch.tensor([top_k], device=row.device),
                           torch.tensor([2.0], device=row.device))[0]
    scaled = masked[t]
    probs = torch.softmax(masked, dim=-1)
    before = probs[masked > scaled].sum().item()
    return abs(before - top_p) < 1e-5 or abs(before + probs[t].item() - top_p) < 1e-5


def check_sample_case(torch, inp, what: str) -> dict:
    """Launch both fused tails on one input set and hold them against the
    plain versions: the logit workspace against head_logits, and the tokens
    (p_d within PD_TOL) against the plain chains run on the kernel's own
    logits.  Returns the largest errors."""
    from bpe_transformer_tpu_torch.kernels import sample as smp
    from bpe_transformer_tpu_torch.ops.core import head_logits
    from bpe_transformer_tpu_torch.serving.engine import sample_tokens

    knobs = (inp["temps"], inp["top_ks"], inp["top_ps"])
    ws = inp["ws"]
    tok = smp.fused_head_sample(inp["hidden"], inp["head"], *knobs, inp["gumbel"], logits_out=ws)
    torch.cuda.synchronize()
    logit_err = (ws - head_logits(inp["hidden"], inp["head"])).abs().max().item()
    require(logit_err <= SAMPLE_LOGIT_TOL,
            f"{what}: logit workspace error {logit_err:.3e} > {SAMPLE_LOGIT_TOL:g}")
    ref = sample_tokens(ws, inp["gumbel"], *knobs)
    edges = 0
    for r in torch.nonzero(tok != ref).flatten().tolist():
        temp, top_k, top_p = (float(inp["temps"][r]), int(inp["top_ks"][r]),
                              float(inp["top_ps"][r]))
        at_edge = temp > 0 and any(nucleus_edge(ws[r], int(t), temp, top_k, top_p)
                                   for t in (tok[r], ref[r]))
        require(at_edge, f"{what}: row {r} token {int(tok[r])} != plain {int(ref[r])}")
        edges += 1
    greedy, p_d, bonus = smp.fused_verify_head(inp["hidden"], inp["head"], *knobs, inp["judge"],
                                               inp["q"], inp["gumbel"], logits_out=ws)
    torch.cuda.synchronize()
    r_greedy, r_pd, r_bonus = smp.verify_rows(ws, *knobs, inp["judge"], inp["q"], inp["gumbel"])
    pd_err = (p_d - r_pd).abs().max().item()
    require(torch.equal(greedy, r_greedy), f"{what}: verify greedy tokens differ")
    require(pd_err <= PD_TOL, f"{what}: p_d error {pd_err:.3e} > {PD_TOL:g}")
    bad = torch.nonzero(bonus != r_bonus).flatten().tolist()
    require(not bad, f"{what}: verify bonus tokens differ from the plain ones in rows {bad}")
    return {"logit_err": logit_err, "pd_err": pd_err, "edge_flips": edges}


def phase_sample_kernels(torch) -> dict:
    """10a: the fused head + sample (B9) and verify (B10) tails against their
    plain versions on the card, at the GPT2_SMALL_32K tick (8 rows) and
    verify (40 rows, K 4) shapes, float32 and bfloat16 hidden states with
    heads at their width and int8, every knob of KNOB_MIX; off the path at
    vocabularies of 257, 101 and 10000, rows 1, 3 and 33, a bf16 hidden
    state against a float32 head, and widths whose rows are not a multiple
    of 16 bytes.  Then kernel / plain ms (CUDA graph replay) and the bound
    at the main shapes.  Returns the bf16 rows of the main shapes."""
    from bpe_transformer_tpu_torch.kernels import sample as smp

    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = {"logit_err": 0.0, "pd_err": 0.0, "edge_flips": 0}
    shapes = [(8, 32000, 768), (40, 32000, 768), (1, 257, 64), (3, 101, 32), (33, 10000, 256),
              (3, 101, 100)]
    n = 0
    for rows, vocab, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for head_kind in ("act", "int8") + (("f32",) if dtype == torch.bfloat16 else ()):
                what = f"R={rows} V={vocab} d={d} {str(dtype)[6:]} {head_kind} head"
                for key, err in check_sample_case(torch, sample_inputs(
                        torch, gen, rows, vocab, d, dtype, head_kind, KNOB_MIX)[0], what).items():
                    worst[key] = max(worst[key], err) if key != "edge_flips" else worst[key] + err
                n += 1
    log(f"fused sample/verify tails vs plain: {n} cases, tokens identical (nucleus-edge flips "
        f"{worst['edge_flips']}), largest logit error {worst['logit_err']:.3e} (tol "
        f"{SAMPLE_LOGIT_TOL:g}), p_d {worst['pd_err']:.3e} (tol {PD_TOL:g})")

    rows_out, main = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        isz = torch.tensor([], dtype=dtype).element_size()
        for head_kind in ("act", "int8"):
            for name, rows in (("fused_head_sample", 8), ("fused_verify_head", 40)):
                vocab, d = 32000, 768
                head_bytes = vocab * d * isz if head_kind == "act" else vocab * (d + 4)
                sets = sample_inputs(torch, gen, rows, vocab, d, dtype, head_kind, SERVING_MIX,
                                     copies=copies_for(head_bytes))
                err = check_sample_case(torch, sets[0], f"{name} R={rows} {dname} {head_kind}")
                if name == "fused_head_sample":
                    def kern(t):
                        return smp.fused_head_sample(t["hidden"], t["head"], t["temps"],
                                                     t["top_ks"], t["top_ps"], t["gumbel"],
                                                     logits_out=t["ws"])

                    def plain(t):
                        return smp.fused_head_sample_plain(t["hidden"], t["head"], t["temps"],
                                                           t["top_ks"], t["top_ps"], t["gumbel"])
                    # hidden, head, knobs and gumbel in; tokens out.
                    nbytes = rows * d * isz + head_bytes + rows * 12 + rows * vocab * 4 + rows * 8
                else:
                    def kern(t):
                        return smp.fused_verify_head(t["hidden"], t["head"], t["temps"],
                                                     t["top_ks"], t["top_ps"], t["judge"], t["q"],
                                                     t["gumbel"], logits_out=t["ws"])

                    def plain(t):
                        return smp.fused_verify_head_plain(t["hidden"], t["head"], t["temps"],
                                                           t["top_ks"], t["top_ps"], t["judge"],
                                                           t["q"], t["gumbel"])
                    # ... and judge and q in; greedy, p_d and bonus out.
                    nbytes = (rows * d * isz + head_bytes + rows * 16 + 2 * rows * vocab * 4
                              + rows * 20)
                flops = 2 * rows * vocab * d
                one = [(t,) for t in sets]
                ms = time_ms(torch, kern, one, 20, graph=True)
                plain_ms = time_ms(torch, plain, one, 10, graph=True)
                # All rows greedy: the finalize takes one pass per row, so
                # this is about the projection's time alone.
                greedy = [(dict(t, temps=torch.zeros_like(t["temps"])),) for t in sets]
                greedy_ms = time_ms(torch, kern, greedy, 20, graph=True)
                byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
                row = {
                    "name": name, "dtype": dname, "shape": f"R={rows} V={vocab} d={d} "
                    f"{'int8' if head_kind == 'int8' else dname} head, serving knobs",
                    "max_abs_err": err["pd_err"] if name == "fused_verify_head"
                    else err["logit_err"], "logit_err": err["logit_err"], "ms": ms,
                    "plain_ms": plain_ms, "greedy_rows_ms": greedy_ms, "library_ms": None,
                    "bound_ms": max(byte_ms, op_ms),
                    "bound_by": "bytes" if byte_ms >= op_ms else "operations", "bytes": nbytes,
                    "flops": flops,
                }
                rows_out.append(row)
                log(f"kernel {name:18s} {dname:8s} {row['shape']:44s} logit err "
                    f"{err['logit_err']:.3e} p_d err {err['pd_err']:.3e} ms {ms:.4f} (all rows "
                    f"greedy {greedy_ms:.4f}) plain {plain_ms:.4f} library null bound "
                    f"{row['bound_ms']:.4f} ({row['bound_by']})")
                if dname == "bfloat16" and head_kind == "act":
                    main[name] = row
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_sample.json").write_text(json.dumps(rows_out, indent=1))
    return main


def phase_spec_fixture(torch) -> None:
    """10b: the trained fixture in float32 served by the speculative engine
    (a one-layer truncated draft, K 4, fused and unfused; and a full-depth
    draft), at act width and at int8 KV + int8 weights: greedy tokens
    identical to the same run on the CPU and to the non-speculative paged
    engine's on the card."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
    from bpe_transformer_tpu_torch.models.transformer import params_from_state_dict
    from bpe_transformer_tpu_torch.serving.server import ServingEngine
    from bpe_transformer_tpu_torch.serving.spec import DraftSpec

    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    sd = {k: v for k, v in arrays.items() if not k.startswith("pin/")}
    cfg = dataclasses.replace(TS_TEST_CONFIG, **PAGED_KNOBS)
    ids = arrays["pin/input_ids"]
    rng = np.random.default_rng(3)
    prompts = [list(ids[i, : 3 + 3 * i]) for i in range(4)]
    prompts += [list(ids[0, :8]) + [int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
                for n in (1, 4, 7)]  # a shared two-block prefix

    def serve(device, **kw):
        with ServingEngine(params_from_state_dict(sd, cfg.num_layers, device=device), cfg,
                           slots=3, min_bucket=8, paged=True, block_size=4, prefill_chunk=8,
                           device=device, **kw) as serving:
            results = serving.run_batch(prompts, max_new_tokens=16, temperature=0.0)
            gauges = serving.engine.gauges()
        return [list(r.token_ids) for r in results], gauges

    reset_counts()
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS[::2]:
        widths = dict(kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        plain, _ = serve("cuda", **widths)
        # A one-layer draft, and a full-depth one (the target itself: nearly
        # every proposal is accepted, so windows of K+1 tokens and rewinds
        # across blocks run too).
        for fused, layers in ((False, 1), (True, 1), (True, cfg.num_layers)):
            kw = dict(widths, speculate_k=4, draft_spec=DraftSpec(truncate_layers=layers),
                      fused_sampling=fused)
            (card, gauges), (cpu, _) = serve("cuda", **kw), serve("cpu", **kw)
            what = f"fixture spec {label} fused={fused} draft layers={layers}"
            log(f"{what}: accept rate {gauges['spec_accept_rate']}, "
                f"{gauges['spec_tokens_per_target_step']} tokens per target step; "
                f"greedy tokens (card) {card}")
            require(card == cpu, f"{what}: card tokens {card} != cpu {cpu}")
            require(card == plain, f"{what}: tokens {card} != the non-speculative engine's "
                    f"{plain}")
    counts = read_counts(SAMPLE_KERNELS + PAGED_KERNELS)
    log(f"fixture spec launches: {counts}")
    require(counts["fused_verify_head"] > 0 and counts["paged_decode_attention"] > 0
            and counts["quant_matmul"] > 0, f"a kernel was not launched: {counts}")


def phase_spec_full_width(torch, smi: str, requests, unfused_results) -> dict:
    """10c: GPT2_SMALL_32K (bf16, ctx 1024, 12 layers) served by the
    speculative ServingEngine (paged, K 4, a two-layer truncated draft, the
    fused verify tail) on phase 9c's pool, chunks and 16-request mix, at act
    width and at int8 KV + int8 weights, with exact launch counts and a
    spec-tick profile; then the same mix through a non-speculative paged
    engine with the fused tick tail, whose greedy requests must give phase
    9c's unfused tokens.  Returns the launches of B9 and B10."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.serving.spec import DraftSpec, SpecEngine

    cfg = dataclasses.replace(GPT2_SMALL_32K, **PAGED_KNOBS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    L, K, draft_layers = cfg.num_layers, 4, 2
    spec_kw = dict(speculate_k=K, draft_spec=DraftSpec(truncate_layers=draft_layers),
                   fused_sampling=True)
    out = {}
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS[::-2]:
        run = serve_mix(torch, params, cfg, requests, smi, f"spec serving {label}",
                        kv_dtype=kv_dtype, weight_dtype=weight_dtype, **spec_kw)
        g, ticks, chunks = run["gauges"], run["ticks"], run["chunks"]
        prefills = len(requests)  # every request decodes on, so its draft prefills once
        if weight_dtype == "int8":
            # Chunks: 7 L + 1 matmuls; draft prefill 7 per layer + the head;
            # a tick: K draft steps with the head, one without, and the
            # target's 7 L (its head is in the fused verify kernel).
            per_tick = K * (7 * draft_layers + 1) + 7 * draft_layers + 7 * L
            expected = only(quant_matmul=(7 * L + 1) * chunks
                            + (7 * draft_layers + 1) * prefills + per_tick * ticks,
                            fused_verify_head=ticks)
        else:
            # The draft runs the plain paths; the target's FFN is the SwiGLU
            # kernel in every chunk and verify pass.
            expected = only(swiglu=L * (chunks + ticks), fused_verify_head=ticks)
        log(f"spec serving {label}: accept rate {g['spec_accept_rate']}, "
            f"{g['spec_tokens_per_target_step']} tokens per target step, draft share of the "
            f"tick {g['spec_draft_frac']}, rewound {g['spec_rewound_tokens']} positions")
        require(run["counts"] == expected,
                f"spec {label}: launch counts {run['counts']} != expected {expected}")
        out["fused_verify_head"] = run["counts"]["fused_verify_head"]

    # The fused tick tail on the plain paged engine (act width): greedy
    # requests give phase 9c's unfused tokens.  Each tick's top-2 logit
    # margins are kept on the card by slot (read after the run, so the
    # ticks take no extra sync), so a divergence can be explained.
    ticks_gaps = []

    def record_margins(engine):
        fused_sample = engine._fused_sample

        def recording(hidden, live):
            tokens = fused_sample(hidden, live)
            top2 = torch.topk(engine._logits_ws, 2, dim=-1).values
            owners = [(slot, engine._slots[slot].request_id, engine._slots[slot].generated)
                      for slot in live]
            ticks_gaps.append((top2[:, 0] - top2[:, 1], owners))
            return tokens

        engine._fused_sample = recording

    run = serve_mix(torch, params, cfg, requests, smi, "paged serving act, fused tick tail",
                    on_engine=record_margins, fused_sampling=True)
    margins = {}
    for gap, owners in ticks_gaps:
        gap = gap.tolist()
        for slot, request_id, generated in owners:
            margins[(request_id, generated)] = gap[slot]
    require(run["counts"] == only(paged_decode_attention=L * run["ticks"],
                                  swiglu=L * (run["ticks"] + run["chunks"]),
                                  fused_head_sample=run["ticks"]),
            f"fused paged: launch counts {run['counts']}")
    out["fused_head_sample"] = run["counts"]["fused_head_sample"]
    for req, res, ref in zip(requests, run["results"], unfused_results):
        if req.temperature != 0.0 or res.token_ids == ref.token_ids:
            continue
        pos = next(i for i, (a, b) in enumerate(zip(res.token_ids, ref.token_ids)) if a != b)
        gap = margins.get((req.request_id, pos))
        log(f"fused paged request {req.request_id}: greedy tokens diverge at {pos}; top-2 logit "
            f"margin there {gap}")
        require(gap is not None and gap < SAMPLE_LOGIT_TOL,
                f"fused paged greedy tokens diverge at {pos} with a top-2 margin of {gap}")

    # A spec tick of each width with 8 slots busy.
    for label, kv_dtype, weight_dtype in PAGED_WIDTHS[::-2]:
        engine = SpecEngine(params, cfg, draft=DraftSpec(truncate_layers=draft_layers),
                            speculate_k=K, slots=8, block_size=16, prefill_chunk=256,
                            kv_dtype=kv_dtype, weight_dtype=weight_dtype, fused_sampling=True,
                            device="cuda")
        profile_ticks(torch, engine, cfg, np.random.default_rng(11), f"spec {label}")
        log(f"spec {label} tick profile gauges: {engine.spec_gauges()}")
        del engine
    return out


# ------------------------------------------------------------ phase 11

#: The GeLU kernels against their plain versions on the card.  float32:
#: 1e-5 absolute, as SwiGLU (the same float32 operations in the same order,
#: no FMA; the kernel's expf/tanhf and PyTorch's exp/tanh may differ in the
#: last place, which 1 + tanh amplifies where it cancels, so the bound is
#: absolute, at outputs up to ~15).  bfloat16: within one bf16 ulp of the
#: plain result, element by element (both round one float32 result once,
#: and a last-place difference may cross a rounding boundary).
GELU_TOL_F32 = 1e-5
#: Float32 operations per element of the forward and the backward, as
#: csrc/gelu.cu does them (exp and tanh one each).  The math runs on the
#: CUDA cores in float32 whatever the storage type, so the bound uses the
#: float32 rate for both types.
GELU_FLOPS = {"gelu": 14, "gelu_bwd": 19}
#: This slice's model: GPT2_SMALL_32K with GPT-2 small's own 4 x d_model
#: tanh-GeLU FFN.  2 * 3072 == 3 * 2048, so its FFN has the used
#: parameters, FLOPs and streamed bytes of the SwiGLU GPT2_SMALL_32K of
#: phases 4, 8 and 9c; the unread w3 (768 x 3072 a layer) comes on top.
GELU_GPT2 = dict(ffn_type="gelu", d_ff=3072)


def gelu_error(torch, out, ref) -> tuple[float, float]:
    """``(max abs error, max error in units of the tolerance)`` of a GeLU
    kernel's output against its plain version's."""
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return diff.max().item(), diff.max().item() / GELU_TOL_F32
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0**-126))) - 7)
    return diff.max().item(), (diff / ulp).max().item()


def interleaved_ticks(torch, engines: dict, vocab: int, rng, label: str,
                      n_ticks: int = 10) -> dict:
    """Host-clock us per tick of two engines with 8 slots busy, timed in
    blocks of ``n_ticks`` in the order A B B A, so that a drift of the
    host's speed during the call falls on both alike."""
    for engine in engines.values():
        fill_slots(torch, engine, vocab, rng)
    names = list(engines)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            engines[name].tick()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e6 / n_ticks)
    log(f"{label}, host us per tick (8 slots busy), blocks of {n_ticks} ticks A B B A: "
        + "; ".join(f"{name} {[round(t) for t in ts]}" for name, ts in times.items()))
    return times


@contextlib.contextmanager
def plain_gelu():
    """Route the GeLU forward to its plain version on the card (the
    reference run of phase 11c); nothing else changes."""
    from bpe_transformer_tpu_torch.kernels import gelu as ge

    kernel = ge._gelu_forward
    ge._gelu_forward = ge.gelu_plain
    try:
        yield
    finally:
        ge._gelu_forward = kernel


def gelu_cases(torch, dtype, gen) -> list:
    """(name, label, kernel, plain, library, input sets, bytes, flops) of
    the GeLU forward and backward at the GeLU GPT2_SMALL_32K's FFN widths:
    the tick (8 x 3072), a prefill chunk (256 x 3072) and a training step
    (8 x 1024 tokens x 3072), on 3 N(0, 1) values."""
    from bpe_transformer_tpu_torch.kernels import gelu as ge

    F = torch.nn.functional
    isz = torch.tensor([], dtype=dtype).element_size()

    def rnd(m, std):
        return (torch.randn(m, 3072, generator=gen, device="cuda") * std).to(dtype)

    cases = []
    for m in (8, 256, 8192):
        n = m * 3072
        cases.append((
            "gelu", f"m={m} ff=3072", ge._gelu_forward, ge.gelu_plain,
            lambda x: F.gelu(x, approximate="tanh"),
            [(rnd(m, 3.0),) for _ in range(copies_for(2 * n * isz))],
            2 * n * isz, GELU_FLOPS["gelu"] * n,
        ))
        cases.append((
            "gelu_bwd", f"m={m} ff=3072", ge._gelu_backward, ge.gelu_bwd_plain,
            lambda x, g: torch.ops.aten.gelu_backward(g, x, approximate="tanh"),
            [(rnd(m, 3.0), rnd(m, 1.0)) for _ in range(copies_for(3 * n * isz))],
            3 * n * isz, GELU_FLOPS["gelu_bwd"] * n,
        ))
    return cases


def check_gelu_other_shapes(torch) -> None:
    """The GeLU kernels off the main path, for correctness: sizes that leave
    a scalar tail after the 16-byte vectors (1 to 24,581 elements), a view
    that starts off a 16-byte boundary, and the large magnitudes of
    tests/test_kernels.py (gelu(11) == 11, gelu(-1000) == 0, no NaN)."""
    from bpe_transformer_tpu_torch.kernels import gelu as ge

    gen = torch.Generator(device="cuda").manual_seed(2)
    big = [11.0, 50.0, 1000.0, -11.0, -50.0, -1000.0, 0.0]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        worst, n_cases = 0.0, 0
        inputs = [(torch.randn(n, generator=gen, device="cuda") * 3).to(dtype)
                  for n in (1, 7, 9, 4097, 3 * 1001, 8 * 3072 + 5)]
        inputs.append((torch.randn(4101, generator=gen, device="cuda") * 3).to(dtype)[1:])
        inputs.append(torch.tensor(big, device="cuda").to(dtype))
        for x in inputs:
            g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            for name, out, ref in (("gelu", ge._gelu_forward(x), ge.gelu_plain(x)),
                                   ("gelu_bwd", ge._gelu_backward(x, g),
                                    ge.gelu_bwd_plain(x, g))):
                torch.cuda.synchronize()
                err, rel = gelu_error(torch, out, ref)
                require(out.shape == ref.shape and out.dtype == ref.dtype
                        and bool(torch.isfinite(out).all()) and rel <= 1,
                        f"{name} {dname} n={x.numel()}: max error {err:.3e} "
                        f"({rel:.2f} of the tolerance)")
                worst, n_cases = max(worst, rel), n_cases + 1
        y = ge._gelu_forward(inputs[-1]).float().tolist()
        require(y == big[:3] + [0.0] * 4, f"gelu {dname} at large magnitudes: {y}")
        log(f"gelu kernels off the main path, {dname}: {n_cases} cases within tolerance "
            f"(largest error {worst:.3f} of its tolerance); gelu({big}) = {y}")


def phase_gelu_kernels(torch) -> dict:
    """11a: the GeLU forward and backward kernels against their plain
    versions and one library call each, float32 and bfloat16, with device
    times by CUDA-graph replay (inputs cycled past the L2) and the bound;
    and the int8 matmul at the GeLU FFN's shapes, as phase 2 holds it.
    Returns the GeLU kernels' bf16 rows at the training shape, keyed by
    kernel name."""
    check_gelu_other_shapes(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for name, label, kern, plain, lib, sets, nbytes, flops in gelu_cases(torch, dtype, gen):
            errs = []
            for inputs in sets[:2]:
                out = kern(*inputs)
                torch.cuda.synchronize()
                ref = plain(*inputs)
                require(out.shape == ref.shape and out.dtype == ref.dtype
                        and bool(torch.isfinite(out).all()), f"{name} {label}: bad output")
                errs.append(gelu_error(torch, out, ref))
            err, rel = max(e for e, _ in errs), max(r for _, r in errs)
            ms = time_ms(torch, kern, sets, 50, graph=True)
            loop_ms = time_ms(torch, kern, sets, 50)
            plain_ms = time_ms(torch, plain, sets, 10, graph=True)
            lib_ms = time_ms(torch, lib, sets, 50, graph=True)
            byte_ms = nbytes / HBM_BYTES_S * 1e3
            op_ms = flops / PEAK_FLOPS["float32"] * 1e3
            tol = GELU_TOL_F32 if dtype == torch.float32 else "1 bf16 ulp"
            row = {
                "name": name, "dtype": dname, "shape": label, "max_abs_err": err,
                "tol": tol, "err_over_tol": rel, "ms": ms, "loop_ms": loop_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "bytes": nbytes, "flops": flops,
            }
            rows.append(row)
            log(f"kernel {name:8s} {dname:8s} {label:14s} err {err:.3e} ({rel:.3f} of tol "
                f"{tol}) ms {ms:.4f} (enqueued from Python {loop_ms:.4f}) plain {plain_ms:.4f} "
                f"library {lib_ms:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']})")
            require(rel <= 1, f"{name} {dname} {label}: max error {err:.3e} over {tol}")
    # B8 at the int8 GeLU FFN's shapes: the down projection reduces over
    # K = 3072, which _splits cuts into slices for the tick's m = 8.
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm

    nsplit, per = qm._splits(8, 768, 3072, torch.device("cuda"))
    log(f"quant_matmul m=8 3072->768: the reduction in {nsplit} slices of {per} columns")
    for dtype in (torch.float32, torch.bfloat16):
        for m in (8, 256):
            for k_in, n_out in ((768, 3072), (3072, 768)):
                rows.append(measure_case(torch, dtype,
                                         quant_case(torch, gen, m, k_in, n_out, dtype)))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_gelu.json").write_text(json.dumps(rows, indent=1))
    return {r["name"]: r for r in rows
            if r["name"].startswith("gelu") and r["dtype"] == "bfloat16"
            and "m=8192" in r["shape"]}


def scaled_params(torch, cfg, seed: int, scale: float = 1.0) -> dict:
    """The port's seeded init of ``cfg`` on the CPU, matrices times
    ``scale`` (norm gains stay 1)."""
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.tree import tree_map

    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return tree_map(lambda t: t * scale if t.ndim == 2 else t, params)


def phase_ffn_small(torch) -> None:
    """11b: small seeded float32 models with a gelu and with a silu FFN
    (TS_TEST_CONFIG at vocab 512 and ctx 64; matrices at 8 times the init
    scale, so that logits are of order 1 and greedy margins far above
    rounding): greedy tokens served on the card by the dense engine, the
    paged engine at act width and at int8 KV + int8 weights, and the
    speculative engine (a one-layer truncated draft, K 2) identical to the
    same requests served on the CPU; then a 5-step AdamW trajectory (flash,
    save_attn) trained on the card against the CPU's, losses and every leaf
    within 1e-4 (phase 6's tolerance)."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.serving.server import ServingEngine
    from bpe_transformer_tpu_torch.serving.spec import DraftSpec
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step
    from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map

    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(0, 512, size=n)] for n in (3, 7, 12, 5, 20, 9)]
    widths = (("dense", {}),
              ("paged act", dict(paged=True, block_size=4, prefill_chunk=8)),
              ("paged int8 KV + int8 weights", dict(paged=True, block_size=4, prefill_chunk=8,
                                                    kv_dtype="int8", weight_dtype="int8")),
              ("spec", dict(paged=True, block_size=4, prefill_chunk=8, speculate_k=2,
                            draft_spec=DraftSpec(truncate_layers=1))))
    for ffn_type in ("gelu", "silu"):
        cfg = dataclasses.replace(TS_TEST_CONFIG, vocab_size=512, context_length=64,
                                  ffn_type=ffn_type, **PAGED_KNOBS)
        base = scaled_params(torch, cfg, seed=5, scale=8.0)
        reset_counts()
        served = {}
        for label, kw in widths:
            for device in ("cuda", "cpu"):
                params = tree_map(lambda t: t.to(device), base)
                with ServingEngine(params, cfg, slots=3, min_bucket=8, device=device,
                                   **kw) as serving:
                    results = serving.run_batch(prompts, max_new_tokens=16, temperature=0.0)
                served[label, device] = [list(r.token_ids) for r in results]
            require(served[label, "cuda"] == served[label, "cpu"],
                    f"{ffn_type} {label}: card tokens {served[label, 'cuda']} differ from cpu "
                    f"{served[label, 'cpu']}")
            if "int8" not in label:
                require(served[label, "cuda"] == served["dense", "cuda"],
                        f"{ffn_type} {label}: tokens differ from the dense engine's")
        counts = read_counts(tuple(KERNEL_META))
        log(f"small {ffn_type} model: greedy tokens identical card == CPU over "
            f"{[w for w, _ in widths]}; launches {counts}")
        require((counts["gelu"] > 0) == (ffn_type == "gelu") and counts["swiglu"] == 0
                and counts["quant_matmul"] > 0, f"{ffn_type}: launches {counts}")

        tcfg = dataclasses.replace(cfg, attention_impl="flash", remat_policy="save_attn")
        hparams = TrainHParams(max_learning_rate=1e-3, warmup_iters=1, cosine_cycle_iters=5,
                               weight_decay=0.1)
        init = scaled_params(torch, tcfg, seed=6)
        batches = [tuple(rng.integers(0, 512, size=(8, 64)) for _ in range(2))
                   for _ in range(5)]
        runs = {}
        for device in ("cuda", "cpu"):
            params = tree_map(lambda t: t.to(device), init)
            opt_state = adamw_init(params)
            step = make_train_step(tcfg, hparams)
            losses = []
            for x, y in batches:
                params, opt_state, m = step(params, opt_state, torch.as_tensor(x, device=device),
                                            torch.as_tensor(y, device=device))
                losses.append(float(m["loss"]))
            runs[device] = (losses, tree_leaves(params))
        loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
        leaf_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                       for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
        log(f"small {ffn_type} model, 5 AdamW steps card vs CPU: losses "
            f"{[round(v, 5) for v in runs['cuda'][0]]}, max loss error {loss_err:.2e}, max "
            f"leaf error {leaf_err:.2e} (tol 1e-4)")
        require(loss_err <= 1e-4 and leaf_err <= 1e-4,
                f"{ffn_type} trajectory: loss error {loss_err:.2e}, leaf error {leaf_err:.2e}")


def phase_gelu_full_width(torch, smi: str, dense_requests, paged_requests) -> dict:
    """11c: the GeLU GPT2_SMALL_32K (bf16, d_ff 3072) at full depth and
    width: one prefill + decode step against the plain versions in float32;
    phase 4's mix through the dense ServingEngine and phase 9c's through
    the paged one at int8 KV + int8 weights, with exact launch counts and a
    tick profile each; the GeLU and the SwiGLU model's ticks timed in turns
    on both engines; then phase 8's 10 training steps (RoPE in the kernel,
    save_attn) with exact launch counts per step.  Returns the GeLU
    kernels' launches over the serving and training runs."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine
    from bpe_transformer_tpu_torch.serving.kvpool import PagedEngine

    cfg = dataclasses.replace(GPT2_SMALL_32K, **GELU_GPT2, **KERNEL_KNOBS)
    plain_cfg = dataclasses.replace(GPT2_SMALL_32K, **GELU_GPT2)  # every knob "xla"
    L = cfg.num_layers
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(12)
    full_width_reference(torch, params, cfg, plain_cfg, rng, "GeLU full-width",
                         plain_route=plain_gelu)

    run = serve_dense(torch, params, cfg, dense_requests, "GeLU dense serving")
    P, ticks = len(dense_requests), run["ticks"]
    expected = only(decode_attention=L * ticks, flash_attention=L * P, gelu=L * (ticks + P))
    require(run["counts"] == expected, f"GeLU dense: launch counts {run['counts']} != {expected}")
    gelu_launches = run["counts"]["gelu"]
    profile_ticks(torch, SlotPoolEngine(params, cfg, slots=8, device="cuda"), cfg, rng,
                  "GeLU dense")

    pcfg = dataclasses.replace(cfg, **PAGED_KNOBS)
    run = serve_mix(torch, params, pcfg, paged_requests, smi,
                    "GeLU paged serving int8 KV + int8 weights", kv_dtype="int8",
                    weight_dtype="int8")
    steps = run["ticks"] + run["chunks"]
    expected = only(paged_decode_attention=L * run["ticks"], quant_matmul=(6 * L + 1) * steps,
                    gelu=L * steps)
    require(run["counts"] == expected, f"GeLU paged: launch counts {run['counts']} != {expected}")
    gelu_launches += run["counts"]["gelu"]
    engine = PagedEngine(params, pcfg, slots=8, block_size=16, prefill_chunk=256,
                         kv_dtype="int8", weight_dtype="int8", device="cuda")
    profile_ticks(torch, engine, pcfg, rng, "GeLU paged int8 KV + int8 weights")
    del engine

    # The GeLU and the SwiGLU model's ticks in one stretch of the call.
    scfg = dataclasses.replace(GPT2_SMALL_32K, **KERNEL_KNOBS)
    swiglu_params = init_params(scfg, torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    interleaved_ticks(torch, {
        "SwiGLU": SlotPoolEngine(swiglu_params, scfg, slots=8, device="cuda"),
        "GeLU": SlotPoolEngine(params, cfg, slots=8, device="cuda"),
    }, cfg.vocab_size, rng, "dense tick, SwiGLU d_ff 2048 vs GeLU d_ff 3072")
    paged_kw = dict(slots=8, block_size=16, prefill_chunk=256, kv_dtype="int8",
                    weight_dtype="int8", device="cuda")
    interleaved_ticks(torch, {
        "SwiGLU": PagedEngine(swiglu_params, dataclasses.replace(scfg, **PAGED_KNOBS),
                              **paged_kw),
        "GeLU": PagedEngine(params, pcfg, **paged_kw),
    }, cfg.vocab_size, rng, "paged int8 KV + int8 weights tick, SwiGLU vs GeLU")
    del params, swiglu_params

    tcfg = dataclasses.replace(
        GPT2_SMALL_32K, **GELU_GPT2, attention_impl="flash_fused", flash_fused_min_seq=0,
        remat_policy="save_attn",
    )
    # save_attn re-runs the FFN half (the GeLU forward) in the backward.
    per_step = only(flash_attention_rope=L, flash_attention_bwd_dkdv=L,
                    flash_attention_bwd_dq=L, gelu=2 * L, gelu_bwd=L)
    run = train_full_width(torch, smi, tcfg, per_step, "GeLU GPT2_SMALL_32K")
    n_steps = len(run["losses"])
    return {"gelu": gelu_launches + per_step["gelu"] * n_steps,
            "gelu_bwd": per_step["gelu_bwd"] * n_steps}


# ------------------------------------------------------------ phase 12

#: The ring-flash interface (B6): the non-causal forward with its lse and the
#: non-causal block backward, counted apart from the causal launches.
RING_KERNELS = ("flash_attention_nc", "flash_attention_bwd_dkdv_nc", "flash_attention_bwd_dq_nc")
#: Ring ranks of the sequence-parallel path: GPT2_SMALL_32K's 1024-token
#: context cut into 4 shards of 256 (zig-zag chunks of 128).
SP_RANKS = 4


def _sp_shards(torch, x, n: int, zigzag: bool):
    """(B, H, S, D) -> (n, B, H, S/n, D) ring shards, zig-zag laid out when
    asked; and the inverse."""
    from bpe_transformer_tpu_torch.parallel import zigzag_indices

    b, h, s, d = x.shape
    if zigzag:
        x = x[..., zigzag_indices(s, n).to(x.device), :]
    return x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()


def _sp_unshard(torch, x, zigzag: bool):
    from bpe_transformer_tpu_torch.parallel import zigzag_inverse_indices

    n, b, h, sl, d = x.shape
    out = x.permute(1, 2, 0, 3, 4).reshape(b, h, n * sl, d)
    if zigzag:
        out = out[..., zigzag_inverse_indices(n * sl, n).to(x.device), :]
    return out


def ring_kernel_errors(torch, fa, q, k, v, g) -> dict:
    """B6 against its plain versions: the forward with lse and the block
    backward, causal and non-causal, given the global out and lse of the
    same call; checked against TRAIN_TOL."""
    dname = str(q.dtype).removeprefix("torch.")
    tol = TRAIN_TOL[dname]
    errs = {}
    for causal in (False, True):
        out, lse = fa.flash_attention_with_lse(q, k, v, causal)
        grads = fa.flash_attention_block_bwd(q, k, v, out, lse, g, causal)
        again = fa.flash_attention_block_bwd(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"B6 {dname} {tuple(q.shape)} causal={causal}: two block backward calls differ")
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal, return_lse=True)
        ref = (fa.flash_attention_bwd_dq_plain(q, k, v, out, lse, g, causal),
               *fa.flash_attention_bwd_dkdv_plain(q, k, v, out, lse, g, causal))
        for t in (out, lse, *grads):
            require(bool(torch.isfinite(t).all()), f"B6 {dname} {tuple(q.shape)}: non-finite")
        tag = "" if causal else "_nc"
        for name, err, limit in (
            (f"flash_attention{tag}", _max_err(out, ref_out), tol["out"]),
            (f"lse{tag}", _max_err(lse, ref_lse), tol["lse"]),
            (f"flash_attention_bwd_dq{tag}", _max_err(grads[0], ref[0]), tol["grad"]),
            (f"flash_attention_bwd_dkdv{tag}",
             max(_max_err(grads[1], ref[1]), _max_err(grads[2], ref[2])), tol["grad"]),
        ):
            require(err <= limit,
                    f"{name} {dname} {tuple(q.shape)}: max error {err:.3e} > {limit:g}")
            errs[name] = err
    return errs


def ring_kernel_timings(torch, fa, shape, gen) -> list[dict]:
    """bf16 kernel / plain / library ms and bound of the three non-causal
    kernels at one launch shape of the sp path (CUDA events, inputs cycled
    past the L2).  The library calls are PyTorch's flash attention with its
    lse and its backward on the global out and lse (timed only)."""
    dtype = torch.bfloat16
    *batch, s, d = shape
    bh = math.prod(batch)
    elems = bh * s * d
    pairs = bh * s * s  # non-causal: every (query, key) pair
    aten = torch.ops.aten
    sets = []
    for _ in range(copies_for(4 * elems * 2)):
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        out, lse = fa.flash_attention_with_lse(q, k, v, False)
        delta = (g.float() * out.float()).sum(-1).contiguous()
        sets.append(dict(q=q, k=k, v=v, g=g, out=out, lse=lse, delta=delta,
                         q4=q.reshape(-1, *shape[-3:]), k4=k.reshape(-1, *shape[-3:]),
                         v4=v.reshape(-1, *shape[-3:]), g4=g.reshape(-1, *shape[-3:])))
    lib_fwd = lib_bwd = None
    try:
        for t in sets:
            t["lib"] = aten._scaled_dot_product_flash_attention(t["q4"], t["k4"], t["v4"], 0.0,
                                                                 False)

        def lib_fwd(t):
            return aten._scaled_dot_product_flash_attention(t["q4"], t["k4"], t["v4"], 0.0, False)

        def lib_bwd(t):
            o, l_, cq, ck, mq, mk, seed, offset, _ = t["lib"]
            return aten._scaled_dot_product_flash_attention_backward(
                t["g4"], t["q4"], t["k4"], t["v4"], o, l_, cq, ck, mq, mk, 0.0, False, seed,
                offset)

        lib_bwd(sets[0])
    except (RuntimeError, TypeError) as exc:
        log(f"library flash attention not timed at {shape}: {str(exc).splitlines()[0]}")
        lib_fwd = lib_bwd = None
    cases = [
        ("flash_attention_nc",
         lambda t: fa._forward(t["q"], t["k"], t["v"], with_lse=True, causal=False),
         lambda t: fa.flash_attention_plain(t["q"], t["k"], t["v"], False, return_lse=True),
         lib_fwd, 4 * elems * 2 + bh * s * 4, 4 * d * pairs, "fwd + lse"),
        ("flash_attention_bwd_dkdv_nc",
         lambda t: fa._launch_bwd("dkdv", t["q"], t["k"], t["v"], t["g"], t["lse"], t["delta"],
                                  False),
         lambda t: fa.flash_attention_bwd_dkdv_plain(t["q"], t["k"], t["v"], t["out"], t["lse"],
                                                     t["g"], False),
         lib_bwd, 6 * elems * 2 + 2 * bh * s * 4, 8 * d * pairs, "dK, dV"),
        ("flash_attention_bwd_dq_nc",
         lambda t: fa._launch_bwd("dq", t["q"], t["k"], t["v"], t["g"], t["lse"], t["delta"],
                                  False),
         lambda t: fa.flash_attention_bwd_dq_plain(t["q"], t["k"], t["v"], t["out"], t["lse"],
                                                   t["g"], False),
         lib_bwd, 5 * elems * 2 + 2 * bh * s * 4, 6 * d * pairs, "dQ"),
    ]
    one = [(t,) for t in sets]
    rows = []
    for name, kern, plain, lib, nbytes, flops, what in cases:
        ms = time_ms(torch, kern, one, 20)
        plain_ms = time_ms(torch, plain, one, 3)
        lib_ms = time_ms(torch, lib, one, 20) if lib is not None else None
        byte_ms = nbytes / HBM_BYTES_S * 1e3
        op_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        rows.append({
            "name": name, "dtype": "bfloat16", "shape": f"{tuple(shape)} {what}", "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "bytes": nbytes,
            "flops": flops,
        })
        # Without the Python enqueue: device time by CUDA-graph replay, the
        # library call's too.
        rows[-1]["device_ms"] = time_ms(torch, kern, one, 20, graph=True)
        dev = f" (device {rows[-1]['device_ms']:.4f})"
        lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        if lib is not None:
            try:
                rows[-1]["library_device_ms"] = time_ms(torch, lib, one, 20, graph=True)
                lib_s += f" (device {rows[-1]['library_device_ms']:.4f})"
            except (RuntimeError, TypeError) as exc:
                log(f"library call not captured at {shape}: {str(exc).splitlines()[0]}")
        log(f"kernel {name:28s} bfloat16 {rows[-1]['shape']:36s} ms {ms:.4f}{dev} plain "
            f"{plain_ms:.4f} library {lib_s} bound {rows[-1]['bound_ms']:.4f} "
            f"({rows[-1]['bound_by']})")
    return rows


def ring_vs_full(torch, gen) -> None:
    """12b: the stacked rings (contiguous and zig-zag, SP_RANKS ranks),
    forward and backward, against one full-length causal flash attention
    (B2/B4) and its gradients on (8, 12, 1024, 64)."""
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.parallel import (
        StackedRing,
        ring_flash_attention,
        zigzag_ring_flash_attention,
    )

    ring = StackedRing(SP_RANKS)
    shape = TRAIN_SHAPES["GPT2_SMALL_32K"]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        tol = TRAIN_TOL[dname]
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention(*leaves)
        ref_grads = torch.autograd.grad(ref, leaves, g)
        for zigzag, fn in ((False, ring_flash_attention), (True, zigzag_ring_flash_attention)):
            shards = [_sp_shards(torch, t, SP_RANKS, zigzag).requires_grad_() for t in (q, k, v)]
            out = fn(*shards, ring)
            grads = torch.autograd.grad(out, shards, _sp_shards(torch, g, SP_RANKS, zigzag))
            torch.cuda.synchronize()
            err = _max_err(_sp_unshard(torch, out, zigzag), ref)
            gerr = max(_max_err(_sp_unshard(torch, a, zigzag), b) for a, b in zip(grads, ref_grads))
            label = "zig-zag" if zigzag else "contiguous"
            log(f"ring flash {label} {dname} {shape} on {SP_RANKS} ranks vs full causal flash: "
                f"out {err:.3e} (tol {tol['out']:g}) grads {gerr:.3e} (tol {tol['grad']:g})")
            require(err <= tol["out"] and gerr <= tol["grad"],
                    f"ring flash {label} {dname}: out {err:.3e} grads {gerr:.3e}")


def sp_launches_per_step(L: int, n: int, zigzag: bool) -> dict:
    """Launches of one sp step, from the ring code's structure: per layer
    and per kernel, contiguous runs 1 causal + (n - 1) non-causal calls,
    zig-zag 2 causal + 1 + 2 (n - 1) non-causal (three sub-blocks on the
    diagonal step, two on every other); the backward repeats the forward's
    calls with the block backward (one dK/dV and one dQ launch each);
    save_attn runs the SwiGLU forward twice per layer."""
    causal, nc = (2, 1 + 2 * (n - 1)) if zigzag else (1, n - 1)
    return only(flash_attention=causal * L, flash_attention_nc=nc * L,
                flash_attention_bwd_dkdv=causal * L, flash_attention_bwd_dkdv_nc=nc * L,
                flash_attention_bwd_dq=causal * L, flash_attention_bwd_dq_nc=nc * L,
                swiglu=2 * L)


def sp_full_width(torch, smi: str) -> dict:
    """12c: make_sp_train_step at GPT2_SMALL_32K (bf16 activations, float32
    masters, save_attn, SP_RANKS shards), contiguous and zig-zag: step 1's
    loss and gradients against the dense step's, then 10 steps on one batch
    with exact launch counts per step, host ms per step, a step profile and
    peak memory."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.parallel import (
        StackedRing,
        make_sp_grad_fn,
        make_sp_train_step,
        shard_sp_batch,
    )
    from bpe_transformer_tpu_torch.training.train_step import (
        TrainHParams,
        make_loss_fn,
        value_and_grad,
    )
    from bpe_transformer_tpu_torch.tree import tree_leaves

    cfg = dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash", ffn_impl="pallas",
                              remat_policy="save_attn")
    ring = StackedRing(SP_RANKS)
    batch, n_steps = 8, 10
    rng = np.random.default_rng(8)
    x, y = (rng.integers(0, cfg.vocab_size, size=(batch, cfg.context_length)) for _ in range(2))
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=n_steps)
    tol = TRAIN_TOL["bfloat16"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    dense_loss, dense_grads = value_and_grad(make_loss_fn(cfg))(
        params, torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda"))
    dense_grads = tree_leaves(dense_grads)
    totals = dict.fromkeys(RING_KERNELS, 0)
    for zigzag in (False, True):
        label = f"GPT2_SMALL_32K sp {'zig-zag' if zigzag else 'contiguous'} x{SP_RANKS}"
        xs, ys = shard_sp_batch((x, y), ring, zigzag=zigzag, device="cuda")
        loss, grads = make_sp_grad_fn(cfg, ring, zigzag)(params, xs, ys)
        grads = tree_leaves(grads)
        loss_err = abs(float(loss) - float(dense_loss))
        grad_err = max(_max_err(a, b) for a, b in zip(grads, dense_grads, strict=True))
        rel_err = max(float((a - b).norm() / b.norm().clamp(min=1e-30))
                      for a, b in zip(grads, dense_grads))
        log(f"{label} step 1 vs the dense step: loss {float(loss):.6f} vs "
            f"{float(dense_loss):.6f} (|d| {loss_err:.3e}, tol {tol['out']:g}); grads max "
            f"abs error {grad_err:.3e} (tol {tol['grad']:g}), largest per-leaf relative "
            f"error {rel_err:.3e}")
        # The bf16 gradient tolerance is also held relative to each leaf's
        # norm: most weight gradients are far below it in absolute terms.
        require(loss_err <= tol["out"] and grad_err <= tol["grad"] and rel_err <= tol["grad"],
                f"{label}: step 1 disagrees with the dense step")
        del grads
        per_step = sp_launches_per_step(cfg.num_layers, SP_RANKS, zigzag)
        p = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        opt_state = adamw_init(p)
        step = make_sp_train_step(cfg, hparams, ring, zigzag=zigzag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, host_ms = [], []
        for _ in range(n_steps):
            reset_counts()
            t0 = time.perf_counter()
            p, opt_state, m = step(p, opt_state, xs, ys)
            losses.append(float(m["loss"]))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts(per_step)
            require(counts == per_step, f"{label}: launch counts of one step {counts} != {per_step}")
            for name in RING_KERNELS:
                totals[name] += counts[name]
        peak = torch.cuda.max_memory_allocated()
        mean_ms = float(np.mean(host_ms[1:]))
        log(f"{label} (bf16 activations, B={batch} S={cfg.context_length}, save_attn): losses "
            f"{[round(v, 4) for v in losses]}")
        log(f"{label} host ms per step {[round(v, 1) for v in host_ms]} (steps 2-10 mean "
            f"{mean_ms:.1f} ms = {batch * cfg.context_length / mean_ms * 1e3:.0f} tok/s); peak "
            f"memory {peak / 2**30:.2f} GiB on {smi}; launches per step "
            f"{ {k: v for k, v in per_step.items() if v} }")
        require(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss: {losses}")
        require(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
        profile_step(torch, label, lambda: step(p, opt_state, xs, ys))
        del p, opt_state, step
    return totals


def phase_sp(torch, smi: str) -> tuple[dict, dict]:
    """Phase 12: B6 vs plain at the sp launch shapes (12a), the stacked rings
    vs full causal flash (12b), and the sp train step at full width (12c).
    Returns the bf16 rows of the three non-causal kernels at the contiguous
    launch shape, and their launch counts over 12c's steps."""
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(12)
    b, h, s, d = TRAIN_SHAPES["GPT2_SMALL_32K"]
    shard = (SP_RANKS, b, h, s // SP_RANKS, d)
    half = (SP_RANKS, b, h, s // SP_RANKS // 2, d)
    # Correctness only: a ragged shard at head dim 96 (bf16 runs it at
    # width 128 on the tensor cores, with padded lse/delta rows).
    ragged = (2, 3, 77, 96)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for shape in (shard, half, ragged):
            errs = ring_kernel_errors(torch, fa, *(
                torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(4)))
            log(f"B6 {dname:8s} {shape}: " + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            if dtype == torch.bfloat16 and shape != ragged:
                for row in ring_kernel_timings(torch, fa, shape, gen):
                    row["max_abs_err"] = errs[row["name"]]
                    rows.append(row)
    ring_vs_full(torch, gen)
    totals = sp_full_width(torch, smi)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_sp.json").write_text(json.dumps(rows, indent=1))
    main = {r["name"]: r for r in rows if r["shape"].startswith(str(shard))}
    return main, totals


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
    counts, dense_requests = phase_full_width(torch)
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
    t0 = time.perf_counter()
    phase_paged_fixture(torch)
    paged_counts, requests, unfused_results = phase_paged_full_width(torch, smi)
    counts.update(paged_counts)
    log(f"phase 9 paged serving: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sample_main = phase_sample_kernels(torch)
    phase_spec_fixture(torch)
    counts.update(phase_spec_full_width(torch, smi, requests, unfused_results))
    log(f"phase 10 fused sampling and speculative decoding: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    gelu_main = phase_gelu_kernels(torch)
    phase_ffn_small(torch)
    counts.update(phase_gelu_full_width(torch, smi, dense_requests, requests))
    log(f"phase 11 two-matrix FFNs and the GeLU kernels: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sp_main, sp_counts = phase_sp(torch, smi)
    counts.update(sp_counts)
    log(f"phase 12 ring-flash sequence-parallel training: ok ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    for name, meta in KERNEL_META.items():
        row = (main_rows.get(name) or sample_main.get(name) or gelu_main.get(name)
               or sp_main.get(name) or train_rows[name])
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
