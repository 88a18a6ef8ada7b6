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
   B1 and B7 also two calls bit-identical; and, for correctness only, at
   shapes off that path (other head dims, among them 320 and 512, which run
   in output-column chunks, GQA groups, block sizes, ragged lengths, odd
   d_ff, int8 rows not a multiple of 16 bytes; for B1 frontiers at 0 and
   on a span boundary +-1, ctx 1000, 4096 and 8192, batches of 1 and 64,
   bf16 head dims 17 and 40, int32 and int64 frontiers; for B7 pool blocks
   of 1 to 128 keys, frontiers at 0 and at span and pool-block boundaries
   +-1, ctx 4096 and 8192, groups of 3 and 16 heads on 4, head dims 17, 40
   and 320, float32, bf16 and int8 pools, with the trash block 0 holding
   NaN and every table entry past a frontier on it; two calls
   bit-identical), with the tensor-core int8 matmul's widening of all 256
   byte values held bit for bit;
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
   logits, p_d within 2e-6, two calls bit-identical, kernel / plain ms,
   each launch's own device time (projection, finalize) from a profile,
   and the bound; (b) the
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
   training shapes of a d_ff 3072 FFN, float32 and bfloat16 (with the
   elements that differ from the plain version counted), and for
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
13. the port served as a user runs it, through its CLI: (a)
   ``train-tokenizer`` on the repo's markdown (vocabulary 2000,
   ``<|endoftext|>``), encode/decode byte-exact with no ``regex`` imported,
   ``tokenize``; (b) ``serve`` on a seeded ``GPT2_SMALL_32K`` checkpoint
   (bf16, the kernel knobs) in a subprocess answering 16 concurrent text
   requests over HTTP (half greedy, half top-k 50 / top-p 0.95, 64 new
   tokens), ``/healthz``, ``/metrics`` and ``/statusz`` read (HBM fields,
   the card's name, the decode roofline's peaks), a clean SIGTERM drain and
   a schema-valid telemetry JSONL; the same requests in-process, greedy ids
   equal to the server's, B1, B2 and B3 launched and nothing else; (c) the
   same with ``--paged --kv-dtype int8 --weight-dtype int8
   --fused-sampling --decode-attention paged`` on 8 requests, B7, B8 and B9
   launched; (d) ``generate`` against ``generate_ids`` and ``eval`` against
   the in-process loss; the HTTP and in-process tok/s and TTFT are printed
   with the card's name and power limit;
14. the serving fleet (KV migration, prefill/decode roles, drain
   evacuation, the router and the fleet tools) at ``GPT2_SMALL_32K`` with
   int8 KV + int8 weights, the fused tick tail and blocks of 16: (a) two
   in-process ``PagedEngine``s on phase 9c's first 8 requests, 4 moved
   mid-decode and 2 mid-prefill through the zlib wire format, every
   request's tokens (greedy and seeded sampled) equal to one engine's that
   never migrated, B7, B8 and B9 launched and nothing else; then the
   speculative engine (K 4, a two-layer draft) migrating greedy requests,
   B10 launched; raw and zlib bytes, export and import ms per session;
   (b) ``serve --role prefill``, two ``serve --role decode`` and ``route
   --prefill-threshold 256`` as subprocesses on the card answering phase
   13's 16 text requests (greedy ids equal to one in-process engine's, no
   failed request, migrations counted on both sides); a burst of 8
   requests with 256 new tokens (half sent to A, half through the router)
   during which decode replica A, started
   with ``--evacuate-to`` B, gets SIGTERM and evacuates its sessions (no
   failed request, greedy ids equal, "drained cleanly"); a prefill replica
   restarted with ``BT_FAULTS`` ``corrupt_payload``, whose payload B
   refuses with a 400 and whose clean re-export, sent twice under one
   ``X-Idempotency-Key``, B grafts once; (c) ``fleet --once``
   (schema-valid fleet and SLO records), ``control`` observe-only over a
   running ``fleet`` for a few ticks, ``incident`` over the flight
   recorders; fleet tok/s and TTFT beside one replica's;
15. the training loop as a user runs it, at ``GPT2_SMALL_32K`` with phase
   8's knobs on a seeded Zipf-distributed uint16 token file: (a) ``train``
   in-process with every tap (the JSONL stream, health stats, dynamics
   every 4 steps, the watchdog, checkpoints every 4 kept 2 deep, prefetch
   2, async checkpoints) for 16 steps with eval every 8: the stream valid
   against the schema, health and dynamics records present, the loss
   finite and falling, launches equal to 16 of phase 8's steps plus the
   eval batches' own, 2 snapshots and a ``latest.ckpt`` symlink, then
   ``verify-checkpoint``, ``report --trace`` and ``monitor --once``; (b)
   ``torch.cuda.set_sync_debug_mode`` counts of the plain, health and
   dynamics steps and of the loop with prefetch 0 and 2 (no tap may add a
   sync), and each step's device time from ``torch.profiler`` and peak
   device memory; (c)
   ``nan_at_step`` 5 under the rollback policy (the event localised to a
   tensor at step 6, the rollback to step 4, a finite end), and ``raise`` in a
   subprocess (a non-zero exit, the dump in the stream); (d) ``train`` as a
   subprocess preempted at step 6 (exit 75, an emergency snapshot), then
   ``--resume`` to step 8 against an uninterrupted run (1e-5 relative);
   (e) ``--supervise`` with a child killed at step 6 ((d) and (e) at 2 of
   the 12 layers, full width, so that their checkpoints are 0.76 GB, not
   1.61); (f) ``--inner-steps
   4`` against 1, and a read fault under prefetch 2 surfacing on the main
   thread; (g) host ms a step of the plain loop, each tap, inner steps and
   prefetch, the sync and async checkpoint stalls, the emergency save and
   the phase's wall time;
16. the MoE family at ``TINYSTORIES_MOE`` width (12 layers, d 512, 8
   experts, top-2, capacity factor 1.25): (a) ``switch_ffn`` on 16 x 512
   tokens in float32 and bfloat16, the gather and einsum dispatches
   against each other, the card's routing against the CPU's on the same
   inputs (a token may change its experts only at a router near-tie), the
   outputs of the tokens routed alike against the CPU's, the drop share,
   and each dispatch's ms split into router, dispatch, experts and
   combine, as launched and by CUDA-graph replay; (b) ``train`` (the loop) for 10 steps at batch 16 x 512 with
   RoPE in the flash kernel and health stats: the loss falling,
   ``moe_aux`` in the stream, exact launches (B5 and B4's pair, no
   SwiGLU, GeLU or int8 kernel), the checkpoint through
   ``verify-checkpoint``, and the gather and einsum steps' synchronising
   calls (none allowed), host and device ms, device time by kernel and by
   MoE stage, peak memory and the stream's MFU; (c) ``make_sp_train_step`` on a stacked ring of 4 with the
   ring-flash kernels: step 1 against the dense step with no drop and the
   aux weight 0, then 3 steps with exact B6 launches; (d) (b)'s checkpoint
   served with the fused tick tail by the dense, paged (act and int8 KV)
   and speculative engines on 8 greedy requests: the same tokens from
   every engine at act width, int8 KV's agreement, exact launches, tok/s
   and TTFT; ``generate --temperature 0`` gives the dense engine's tokens
   and ``serve --weight-dtype int8`` exits 2;
17. the rest of the one-card surface at ``GPT2_SMALL_32K`` width: (a) the
   native (C++) tokenizer engine, available on the card's host, trains phase
   13's corpus (required to run natively) to the Python path's
   (``BT_NATIVE=0``) vocabulary and merges and encodes it to the same ids,
   each path's train and encode seconds printed beside phase 13a's (which
   takes the native engine when it builds); (b)
   the 21 reference adapters (``compat``) on CUDA tensors against the same
   calls on CPU tensors from one seed (float32, 1e-4 of the largest
   magnitude), ``run_transformer_lm`` and ``run_transformer_block`` at full
   width on a short sequence, 3 steps of ``get_adamw_cls()`` on the same
   gradients with its state on the parameters' card (the step on the
   host), the checkpoint adapters
   from the card to the CPU, ``run_get_batch`` onto the card; (c) ``train``
   with ``attribution_every`` at phase 15's config: records with the JAX
   probe's keys (and the probe's fenced wall time), the loop's step time
   split against the card's busy time from a ``torch.profiler`` trace,
   which must be shorter than both wall times on this host-bound step, the
   checkpoint after 8 steps byte-identical with the probe on and off, no
   sync in an update off a log boundary and every sync the probe adds in
   ``telemetry/attribution.py``, its fences exactly two a boundary, the
   probe's launches a whole number of one step's, the live tensors
   untouched; ``profile --measure 5 --serve`` with H100 verdicts and
   ``report`` rendering it; (d) ``warmup --compile-cache`` on the build root
   this run used, for phase 13b's, 13c's and 15's flags: nothing built,
   every needed source found, and those sources are the ones whose kernels
   those phases launched;
18. data and sequence parallelism over a process group (slice 10b): a
   real NCCL group of world 1 on ``cuda:0`` driving ``train()`` at phase
   15's config and seed, ZeRO-1 dp (``mesh data=1``) for 4 steps with a
   checkpoint, resumed dense to 8, and ring-flash sp (``mesh
   data=1,seq=1``) for 4 steps, each against ``train()`` on one device
   within phase 15's 1e-5 relative, with exact launch counts;
19. sharded parameters (slice 10c) over 18's group: B5, B4's pair and B3
   at the shapes tensor parallelism hands them (3 and 6 heads, hidden 512
   and 1024) against their plain versions, then ``train()`` under fsdp
   with ZeRO-1 (``mesh data=1``, a sharded checkpoint directory at step 4)
   and under fsdp_tp (``mesh data=1,model=1``) for 4 steps, and the
   directory verified and resumed under fsdp_tp to 8, each against one
   device within phase 15's 1e-5 relative, with exact launch counts;
20. Ulysses, the GPipe pipeline and expert parallelism (slice 10d): (a)
   ``make_sp_train_step(ulysses=True)`` on a stacked ring of 4 at
   GPT2_SMALL_32K under ``attention_impl="flash"`` (B2 + lse on 3 heads a
   rank over the whole 1024), step 1 against the dense flash step at
   phase 12c's tolerances and 3 steps with exact launch counts; (b) over
   18's group ``train()`` under pp (``mesh pp=1``, 4 microbatches, a
   stacked directory verified and resumed) against one device, and under
   ep and dp_ep (``expert=1``) at TINYSTORIES_MOE against one device, with
   exact launch counts; (c) B2 + lse at (8, 3, 1024, 64) and B5, B4's pair
   and B3 at the pipeline's 2-row microbatches against their plain
   versions, timed by CUDA-graph replay;
then one JSON line listing every ported kernel (launches counted over the
main paths, phases 18's, 19's and 20's included), and the ``ok`` line.

``python3 chip_smoke.py --phase 18 --world 4`` (on a host with four
cards) builds the kernels and runs phase 18 across cards
instead: one rank process a card (NCCL, started by the port's
``parallel/launch.py``), dp=4 at phase 8's config and batch (2 rows a
rank) for 3 steps against phase 8's one-card step (``DP_TOL``), ZeRO-1 at
dp=4 against dp=4 (``ZERO1_TOL``), the sp grids seq=4 and data=2 x seq=2,
contiguous and zig-zag, step 1 against phase 12's stacked ring of 4
(phase 12's tolerance) and 3 steps with exact launch counts, each with
host ms a step, tok/s a card, peak memory a rank and the NCCL time a step
from ``torch.profiler``; then the ``train`` CLI under ``torchrun`` at dp=4
with ZeRO-1, its step-4 checkpoint resumed at dp=2.  ``--phase 18`` alone
runs the default run's phases 18 and 19 after the build.

``python3 chip_smoke.py --phase 19 --world 4`` runs 19 across four cards:
one NCCL rank a card, fsdp=4, tp=4, fsdp_tp 2x2 and dp_tp 2x2 (ZeRO-1
where a data axis exists) at phase 8's config and batch for 3 steps
against phase 8's one-card step (``DP_TOL``; step 1's loss and gathered
mean gradients at phase 12's bf16 tolerance), each rank's parameter and
moment bytes equal to the specs' arithmetic, exact launch counts, host ms
a step, tok/s a card, peak memory a rank and the NCCL time a step; then
the ``train`` CLI under ``torchrun``: fsdp=4 with ZeRO-1 writing sharded
directories, its step-4 directory through ``verify-checkpoint`` and
resumed at fsdp=2 and at tp=2.

``python3 chip_smoke.py --phase 20 --world 4`` runs 20 across four cards:
one NCCL rank a card, Ulysses on seq=4 and data=2 x seq=2 and the
pipeline on pp=4 and data=2 x pp=2 at GPT2_SMALL_32K, ep=4, dp_ep and
fsdp_ep (data=2 x expert=2, ZeRO-1) and pp=4 at TINYSTORIES_MOE, each as
19's strategies are held (step 1, 3 steps, the bytes a rank against the
specs', exact launches, host ms, tok/s a card, peak memory, NCCL time);
then the ``train`` CLI under ``torchrun``: pp=4 writing stacked
directories, resumed at pp=4 and refused at pp=2 with the JAX loop's
message, dp_ep resumed at ep=4, and ``train --supervise --parallel pp``
(the supervisor starts the world itself) with one rank killed once.

Float32 matmuls run in full float32 (``allow_tf32 = False`` for cuBLAS and
cuDNN).  Per-shape kernel numbers are also written as JSON under
``OUT_DIR``: ``chip_smoke_kernels.json`` (serving),
``chip_smoke_training.json`` (training), ``chip_smoke_sample.json`` (the
fused tails), ``chip_smoke_gelu.json`` (the GeLU kernels), ``chip_smoke_sp.json`` (B6),
``chip_smoke_serve.json`` (phase 13's HTTP and in-process figures),
``chip_smoke_fleet.json`` (phase 14's migrations and fleet figures),
``chip_smoke_loop.json`` (phase 15's training-loop figures),
``chip_smoke_moe.json`` (phase 16's MoE figures),
``chip_smoke_surface.json`` (phase 17's), ``chip_smoke_parallel.json``
(phases 18's and 19's) and, from the four-card runs,
``chip_smoke_parallel4.json``, ``chip_smoke_parallel4_cli.json``,
``chip_smoke_sharded4.json``, ``chip_smoke_sharded4_cli.json``,
``chip_smoke_pipeline4.json`` and ``chip_smoke_pipeline4_cli.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
#: The split-KV kernels, whose two calls on the same inputs must give the
#: same bits.
SPLIT_KERNELS = ("decode_attention", "paged_decode_attention")
PAGED_KERNELS = ("paged_decode_attention", "quant_matmul")
TRAINING_KERNELS = ("flash_attention_rope", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
#: The kernels of phase 15's training loop (B5, B4's pair, B3).
TRAIN_KERNELS_15 = TRAINING_KERNELS + ("swiglu",)


#: Wall seconds of phases that a later phase prints beside its own.
TIMINGS: dict = {}


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


def paged_call(q, k, v, t, p, ks, vs):
    from bpe_transformer_tpu_torch.kernels import decode_attention as da

    return da.paged_decode_attention(q, k, v, t, p, k_scale=ks, v_scale=vs)


def paged_nan_inputs(torch, gen, H, KV, bs, nbs, d, dtype, kv_int8, pos, int32=False):
    """Inputs of one slot per frontier in ``pos`` whose table entries past
    the frontier point at the trash block 0, which holds NaN (an int8
    pool's NaN is in block 0's scales), and the same inputs with block 0
    finite for the plain version (which reads every entry)."""
    S = len(pos)
    pos_t = torch.tensor(pos, device="cuda", dtype=torch.int32 if int32 else torch.int64)
    q, k, v, tables, _, ks, vs = paged_inputs(torch, gen, S, H, KV, bs, nbs, d, dtype, kv_int8,
                                              pos=pos_t)
    live = torch.arange(nbs, device="cuda")[None, :] <= (pos_t[:, None] // bs)
    tables = torch.where(live, tables, torch.zeros_like(tables))
    clean = (q, k, v, tables, pos_t, ks, vs)
    if kv_int8:
        ks, vs = ks.clone(), vs.clone()
        ks[0] = vs[0] = float("nan")
    else:
        k, v = k.clone(), v.clone()
        k[0] = v[0] = float("nan")
    return (q, k, v, tables, pos_t, ks, vs), clean


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
        # The split-KV design where it can break: frontiers at 0 and on a
        # span boundary +-1 (one, two and three live spans), a ctx that is no
        # multiple of the span (1000), ctx 4096 and 8192 (spans of 128 and 256
        # keys, up to 8 tiles: the ring refills where it holds fewer, as at d
        # 128 and in float32), batches of 1 and 64,
        # and head dims whose rows are no whole 16-byte units in bf16 (17: no
        # bulk copy; 40: bulk copy of rows narrower than the register width);
        # int64 frontiers (the engines' own) except the last two cases (int32).
        span = da.decode_splits(1024)[1]
        edge = [0, 1, span - 1, span, span + 1, 2 * span - 1, 2 * span, 2 * span + 1]
        for B, H, KV, ctx, d, pos in (
                (8, 4, 4, 1024, 64, edge), (8, 16, 4, 1024, 64, edge),
                (4, 12, 12, 1000, 64, [0, 999, 500, 2 * span]),
                (3, 8, 2, 4096, 64, [4095, 1000, 128]), (2, 4, 4, 8192, 64, [8191, 3000]),
                (2, 16, 4, 8192, 128, [8191, 257]), (1, 12, 12, 1024, 64, [1023]),
                (64, 12, 12, 1024, 64, None), (4, 8, 2, 300, 17, [299, 0, 64, 65]),
                (4, 6, 3, 300, 40, [299, 0, 64, 65]), (3, 4, 1, 1000, 17, [999, 128, 129])):
            pos = (torch.randint(0, ctx, (B,), generator=gen, device="cuda") if pos is None
                   else torch.tensor(pos, device="cuda"))
            if d in (17, 40) and KV > 1:
                pos = pos.to(torch.int32)
            cases.append(("decode_attention", f"B={B} H={H} KV={KV} ctx={ctx} d={d} split edges",
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
                    paged_call, da.paged_decode_attention_plain, (q, k, v, tb, ps, ks, vs)))
        # The split-KV design where it can break: pool blocks of 1 to 128
        # keys, frontiers at 0 and at span and pool-block boundaries +-1, ctx
        # 4096 and 8192, groups of 3 and 16 heads on 4, head dims 17 (no bulk
        # copy in bf16), 40 and 320, with the trash block 0 holding NaN and
        # every table entry past a slot's frontier on it (so any read of them
        # would show); int64 frontiers but in the two int32 cases.
        for H, KV, bs, nbs, d in ((4, 4, 1, 300, 64), (12, 4, 8, 64, 64), (16, 4, 16, 64, 64),
                                  (16, 4, 32, 128, 128), (4, 4, 64, 128, 64),
                                  (6, 2, 128, 8, 40), (8, 4, 16, 16, 17), (6, 2, 16, 4, 320)):
            ctx = nbs * bs
            span = da.decode_splits(ctx)[1]
            pos = sorted({min(ctx - 1, max(0, p)) for base in (0, bs, span, 2 * span, ctx - 1)
                          for p in (base - 1, base, base + 1)})
            for kv_int8 in (False, True):
                inputs, clean = paged_nan_inputs(torch, gen, H, KV, bs, nbs, d, dtype, kv_int8,
                                                 pos, int32=d in (17, 40))
                cases.append((
                    "paged_decode_attention",
                    f"S={len(pos)} H={H} KV={KV} bs={bs} ctx={ctx} d={d} "
                    f"{'int8' if kv_int8 else 'act'} NaN past frontiers",
                    paged_call, lambda *a, clean=clean: da.paged_decode_attention_plain(*clean),
                    inputs))
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
            if name in SPLIT_KERNELS:  # the split merge takes a fixed order
                require(torch.equal(out, kern(*args)),
                        f"{name} {dname} {label}: two calls differ")
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
        if name in SPLIT_KERNELS:
            require(torch.equal(out, kern(*inputs)), f"{name} {label}: two calls differ")
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
    if name == "decode_attention":
        log(f"decode_attention {dname} {label}: kernel {ms:.4f} ms against SDPA's {lib_ms:.4f} "
            f"({'below' if ms < lib_ms else 'NOT below'} it; {ms / row['bound_ms']:.1f}x the "
            f"bound)")
    require(err <= tol, f"{name} {dname} {label}: max error {err:.3e} > {tol:g}")
    return row


@contextlib.contextmanager
def patched(module, **values):
    """Set module attributes for the block (a kernel entry routed to its
    plain version), and restore them after."""
    old = {name: getattr(module, name) for name in values}
    for name, value in values.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


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


def paged_span_sweep(torch, gen) -> list[dict]:
    """B7 at the paged tick of kernel_cases (bf16 q, int8 and act pools)
    with each slot's keys in spans of 64, 128 and 256 (the wrapper's
    decode_splits patched), by CUDA-graph replay, beside the span
    decode_splits picks; each held against the shipped span's output."""
    from bpe_transformer_tpu_torch.kernels import decode_attention as da

    S, H, bs, nbs, d = 8, 12, 16, 64, 64
    pos = torch.tensor([0, 15, 100, 257, 511, 700, 900, 1023], device="cuda")
    rows = []
    for kv_int8 in (True, False):
        sets = [paged_inputs(torch, gen, S, H, H, bs, nbs, d, torch.bfloat16, kv_int8, pos=pos)
                for _ in range(copies_for((S * nbs + 1) * H * bs * d * 2 * (1 if kv_int8 else 2)))]
        ref = paged_call(*sets[0])
        row = {"name": "paged_decode_attention", "dtype": "bfloat16",
               "shape": f"S={S} H=KV={H} bs={bs} nbs={nbs} d={d} "
                        f"{'int8' if kv_int8 else 'act'} KV span sweep",
               "shipped_span": da.decode_splits(nbs * bs)[1]}
        for span in (64, 128, 256):
            with patched(da, decode_splits=lambda ctx, span=span: (-(-ctx // span), span)):
                err = _max_err(paged_call(*sets[0]), ref)
                require(err <= TOL_BF16, f"paged span {span}: max error {err:.3e}")
                row[f"span_{span}_ms"] = time_ms(torch, paged_call, sets, 48, graph=True)
        rows.append(row)
        log(f"paged_decode_attention span sweep {row['shape']}: " + ", ".join(
            f"{span} keys {row[f'span_{span}_ms']:.4f} ms" for span in (64, 128, 256))
            + f" (decode_splits picks {row['shipped_span']})")
    return rows


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
    rows += paged_span_sweep(torch, gen)
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


def plain_quant_matmul():
    """Route the int8 matmul to its plain version on the card (the
    reference run of phase 9b); nothing else changes."""
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm

    return patched(qm, quant_matmul=qm.quant_matmul_plain)


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
#: The serving mix with top-k off (the finalize's radix nucleus path).
NUCLEUS_MIX = ((0.0, 0, 2.0), (0.8, 0, 0.95))


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
    # Sums and counts reduce in a fixed order: a second call gives the same bits.
    ws2 = torch.empty_like(ws)
    again = smp.fused_verify_head(inp["hidden"], inp["head"], *knobs, inp["judge"], inp["q"],
                                  inp["gumbel"], logits_out=ws2)
    tok2 = smp.fused_head_sample(inp["hidden"], inp["head"], *knobs, inp["gumbel"])
    require(torch.equal(ws, ws2) and torch.equal(tok, tok2)
            and all(torch.equal(x, y) for x, y in zip((greedy, p_d, bonus), again)),
            f"{what}: two calls differ")
    r_greedy, r_pd, r_bonus = smp.verify_rows(ws, *knobs, inp["judge"], inp["q"], inp["gumbel"])
    pd_err = (p_d - r_pd).abs().max().item()
    require(torch.equal(greedy, r_greedy), f"{what}: verify greedy tokens differ")
    require(pd_err <= PD_TOL, f"{what}: p_d error {pd_err:.3e} > {PD_TOL:g}")
    bad = torch.nonzero(bonus != r_bonus).flatten().tolist()
    require(not bad, f"{what}: verify bonus tokens differ from the plain ones in rows {bad}")
    return {"logit_err": logit_err, "pd_err": pd_err, "edge_flips": edges}


def fused_tail(name: str):
    """The fused tail ``name`` as a function of one sample_inputs set."""
    from bpe_transformer_tpu_torch.kernels import sample as smp

    if name == "fused_head_sample":
        return lambda t: smp.fused_head_sample(t["hidden"], t["head"], t["temps"], t["top_ks"],
                                               t["top_ps"], t["gumbel"], logits_out=t["ws"])
    return lambda t: smp.fused_verify_head(t["hidden"], t["head"], t["temps"], t["top_ks"],
                                           t["top_ps"], t["judge"], t["q"], t["gumbel"],
                                           logits_out=t["ws"])


def launch_split(torch, fn, input_sets, calls: int = 20) -> dict:
    """Device ms per call of each of a fused tail's two launches, from a
    ``torch.profiler`` trace of ``calls`` calls cycling through
    ``input_sets``: the projection (and which design ran) and the
    finalize.  The profiler here at times records no device events: such a
    trace is taken again, up to three times in all, and after that the
    split is not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(*input_sets[i % len(input_sets)])
            torch.cuda.synchronize()
        # Each kernel's time over the launches the trace holds of it (a
        # trace may drop events).
        by_name, _ = _device_breakdown(prof, 1)
        proj = [(name, us / k) for name, (us, k) in by_name.items()
                if "wgemm_kernel" in name or "head_logits_kernel" in name]
        fin = [us / k for name, (us, k) in by_name.items() if "finalize_kernel" in name]
        if len(proj) == 1 and len(fin) == 1:
            return {"projection_ms": proj[0][1] / 1e3, "finalize_ms": fin[0] / 1e3,
                    "projection": "tensor cores" if "wgemm" in proj[0][0] else "CUDA cores"}
    return {"projection_ms": None, "finalize_ms": None, "projection": None}


def ms_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def phase_sample_kernels(torch) -> dict:
    """10a: the fused head + sample (B9) and verify (B10) tails against their
    plain versions on the card, at the GPT2_SMALL_32K tick (8 rows) and
    verify (40 rows, K 4) shapes, float32 and bfloat16 hidden states with
    heads at their width and int8, every knob of KNOB_MIX; off the path at
    vocabularies of 257, 101 and 10000, rows 1, 3 and 33, a bf16 hidden
    state against a float32 head, and widths whose rows are not a multiple
    of 16 bytes; two calls bit-identical.  Then kernel / plain ms (CUDA
    graph replay), each launch's device ms (:func:`launch_split`) and the
    bound at the main shapes.  Returns the bf16 rows of the main shapes."""
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
                kern = fused_tail(name)
                if name == "fused_head_sample":
                    def plain(t):
                        return smp.fused_head_sample_plain(t["hidden"], t["head"], t["temps"],
                                                           t["top_ks"], t["top_ps"], t["gumbel"])
                    # hidden, head, knobs and gumbel in; tokens out.
                    nbytes = rows * d * isz + head_bytes + rows * 12 + rows * vocab * 4 + rows * 8
                else:
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
                split = launch_split(torch, kern, one)
                byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
                row = {
                    "name": name, "dtype": dname, "shape": f"R={rows} V={vocab} d={d} "
                    f"{'int8' if head_kind == 'int8' else dname} head, serving knobs",
                    "max_abs_err": err["pd_err"] if name == "fused_verify_head"
                    else err["logit_err"], "logit_err": err["logit_err"], "ms": ms,
                    "plain_ms": plain_ms, **split, "library_ms": None,
                    "bound_ms": max(byte_ms, op_ms),
                    "bound_by": "bytes" if byte_ms >= op_ms else "operations", "bytes": nbytes,
                    "flops": flops,
                }
                rows_out.append(row)
                log(f"kernel {name:18s} {dname:8s} {row['shape']:44s} logit err "
                    f"{err['logit_err']:.3e} p_d err {err['pd_err']:.3e} ms {ms:.4f} (by launch: "
                    f"projection {ms_or_not(split['projection_ms'])} on {split['projection']}, "
                    f"finalize {ms_or_not(split['finalize_ms'])}) plain {plain_ms:.4f} library "
                    f"null bound "
                    f"{row['bound_ms']:.4f} ({row['bound_by']})")
                if dname == "bfloat16" and head_kind == "act":
                    main[name] = row
    # The finalize's other path: the serving mix with top-k off, so the
    # nucleus takes its four radix passes over every column.
    for name, rows in (("fused_head_sample", 8), ("fused_verify_head", 40)):
        sets = sample_inputs(torch, gen, rows, 32000, 768, torch.bfloat16, "act", NUCLEUS_MIX,
                             copies=copies_for(32000 * 768 * 2))
        err = check_sample_case(torch, sets[0], f"{name} R={rows} bf16 top-k off")
        split = launch_split(torch, fused_tail(name), [(t,) for t in sets])
        rows_out.append({"name": name, "dtype": "bfloat16", "shape": f"R={rows} V=32000 d=768 "
                         "bfloat16 head, serving knobs with top-k off", **err, **split})
        log(f"kernel {name:18s} bfloat16 R={rows} serving knobs with top-k off: finalize "
            f"{ms_or_not(split['finalize_ms'])} ms (projection "
            f"{ms_or_not(split['projection_ms'])}), nucleus-edge flips {err['edge_flips']}")
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


def plain_gelu():
    """Route the GeLU forward to its plain version on the card (the
    reference run of phase 11c); nothing else changes."""
    from bpe_transformer_tpu_torch.kernels import gelu as ge

    return patched(ge, _gelu_forward=ge.gelu_plain)


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
            errs, differ = [], 0
            for inputs in sets[:2]:
                out = kern(*inputs)
                torch.cuda.synchronize()
                ref = plain(*inputs)
                require(out.shape == ref.shape and out.dtype == ref.dtype
                        and bool(torch.isfinite(out).all()), f"{name} {label}: bad output")
                errs.append(gelu_error(torch, out, ref))
                differ += int((out != ref).sum())
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
                "bytes": nbytes, "flops": flops, "elements_differing_from_plain": differ,
            }
            rows.append(row)
            log(f"kernel {name:8s} {dname:8s} {label:14s} err {err:.3e} ({rel:.3f} of tol "
                f"{tol}; {differ} elements differ from plain) ms {ms:.4f} (enqueued from Python "
                f"{loop_ms:.4f}) plain {plain_ms:.4f} library {lib_ms:.4f} bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']})")
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
            and "m=8192" in r["shape"] and "ms" in r}


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


# ------------------------------------------------------------ phase 13

#: Phase 13's working files (tokenizer, token file, checkpoint, telemetry),
#: inside the checkout and removed at the end of the phase.
SERVE_WORK = ROOT / ".scratch" / "chip_smoke_serve"
PORT_CLI = ("-m", "bpe_transformer_tpu_torch.training.cli")
SERVE_VOCAB = 2000
SERVE_SPECIAL = "<|endoftext|>"


def port_cli(*argv: str, timeout: float = 600) -> str:
    """Run one command of the port's CLI in a fresh process (as a user
    would); fails the phase on a non-zero exit.  Returns its stdout."""
    proc = subprocess.run([sys.executable, *PORT_CLI, *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    require(proc.returncode == 0,
            f"cli {argv[0]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


class ServeProcess:
    """A command of the port's CLI in a subprocess (``serve`` unless
    ``command`` says otherwise): started, its banner read, stopped with
    SIGTERM (for ``serve``, a clean drain and exit 0 required), killed on
    any failure and by a timer."""

    def __init__(self, argv: list, log_path: Path, timeout: float = 900, command: str = "serve",
                 banner: str = "serving on http://", env: dict | None = None):
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen([sys.executable, *PORT_CLI, command, *argv], cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=self._log, text=True,
                                     env=None if env is None else {**os.environ, **env})
        self._killer = threading.Timer(timeout, self.proc.kill)
        self._killer.start()
        self._log_path = log_path
        line = self.proc.stdout.readline()
        if not line.startswith(banner):
            self.kill()
            raise SmokeFailure(f"{command} printed no banner ({line!r}): "
                               f"{log_path.read_text()[-3000:]}")
        self.base = line.split()[2]

    def stop(self) -> None:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            out, _ = self.proc.communicate(timeout=300)
        finally:
            self.kill()
        require(self.proc.returncode == 0 and "drained cleanly" in out,
                f"serve did not drain cleanly (rc {self.proc.returncode}, {out!r}): "
                f"{self._log_path.read_text()[-3000:]}")

    def terminate(self) -> None:
        """SIGTERM, for the commands without a drain (router, fleet,
        controller); killed if it has not ended within 30 s."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        self.kill()

    def kill(self) -> None:
        self._killer.cancel()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        if not self._log.closed:
            self._log.close()


def http_json(url: str, body: dict | None = None, timeout: float = 600):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
    except urllib.error.HTTPError as err:
        raise SmokeFailure(f"{url}: HTTP {err.code}: {err.read().decode()[:500]}") from None
    return raw if url.endswith("/metrics") else json.loads(raw)


def histogram_buckets(metrics_text: str, family: str, labels: str) -> list:
    """``[(le, cumulative count)]`` of one Prometheus histogram series."""
    buckets = []
    prefix = f"{family}_bucket{{{labels},le=\""
    for line in metrics_text.splitlines():
        if line.startswith(prefix):
            le, value = line[len(prefix):].split("\"} ")
            buckets.append((math.inf if le == "+Inf" else float(le), float(value)))
    return buckets


def histogram_quantile(after: str, before: str, family: str, labels: str, q: float):
    """The ``q`` quantile of the observations one Prometheus histogram
    series gained between two scrapes (``before``, ``after``), interpolated
    linearly inside its bucket as Prometheus's ``histogram_quantile``
    does."""
    base = dict(histogram_buckets(before, family, labels))
    buckets = [(le, n - base.get(le, 0.0)) for le, n in histogram_buckets(after, family, labels)]
    if not buckets or buckets[-1][1] == 0:
        return None
    rank = q * buckets[-1][1]
    lo, below = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if le == math.inf:
                return lo
            return lo + (le - lo) * (rank - below) / max(count - below, 1e-12)
        lo, below = le, count
    return None


def serve_requests(tokenizer, corpus: str, n: int) -> list:
    """``n`` text prompts cut from the corpus (about 15 to 900 tokens), half
    greedy, half temperature 0.8 / top-k 50 / top-p 0.95 seeded, 64 new
    tokens each, as ``/generate`` bodies."""
    chars = [40, 3000, 300, 1500, 120, 2400, 700, 1900, 60, 2700, 500, 1100, 200, 2200, 900, 80]
    bodies = []
    for i in range(n):
        start = (i * 7919) % (len(corpus) - 4000)
        text = corpus[start: start + chars[i % len(chars)]].replace(SERVE_SPECIAL, " ")
        while len(tokenizer.encode(text)) > 900:
            text = text[: len(text) * 9 // 10]
        knobs = {"temperature": 0.0} if i % 2 == 0 else {
            "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": i}
        bodies.append({"prompt": text, "max_new_tokens": 64, **knobs})
    return bodies


def pcts(values) -> str:
    import numpy as np

    return f"p50 {np.percentile(values, 50):.4f} s, p95 {np.percentile(values, 95):.4f} s"


def serve_over_http(torch, smi: str, label: str, ckpt: Path, tokenizer, cfg, bodies: list,
                    flags: list, engine_kw: dict, kernels: tuple) -> dict:
    """Serve ``bodies`` through ``serve`` (a subprocess on ``ckpt`` with
    ``flags``), all at once over HTTP; read /healthz, /metrics and /statusz;
    stop it with SIGTERM and check its telemetry JSONL.  Then serve the same
    requests in-process through a ``ServingEngine`` built as the command
    builds it (``engine_kw``), with every launch count at 0 before and
    ``kernels`` launched after.  Greedy requests must give the same ids on
    both."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bpe_transformer_tpu_torch.checkpointing import load_checkpoint
    from bpe_transformer_tpu_torch.models.transformer import params_from_jax
    from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine
    from bpe_transformer_tpu_torch.telemetry import validate_record

    jsonl = SERVE_WORK / f"{label}.jsonl"
    server = ServeProcess(
        ["--checkpoint", str(ckpt), "--tokenizer-dir", str(SERVE_WORK / "tok"), "--port", "0",
         "--slots", "8", "--metrics-jsonl", str(jsonl), *flags],
        SERVE_WORK / f"{label}.log",
    )
    try:
        # Warm-up request (kernel libraries load, allocator pools), outside
        # the measured burst.
        http_json(server.base + "/generate", {"prompt_ids": list(range(20)),
                                               "max_new_tokens": 4, "temperature": 0.0})
        metrics_before = http_json(server.base + "/metrics")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            answers = list(pool.map(lambda b: http_json(server.base + "/generate", b), bodies))
        http_wall = time.perf_counter() - t0
        health = http_json(server.base + "/healthz")
        metrics = http_json(server.base + "/metrics")
        statusz = http_json(server.base + "/statusz")
        # Engine records come once a second: a burst shorter than that
        # leaves its record to the worker's next step.
        deadline = time.monotonic() + 10
        while '"kind": "engine"' not in jsonl.read_text() and time.monotonic() < deadline:
            time.sleep(0.2)
    except BaseException:
        server.kill()
        raise
    server.stop()

    kind = torch.cuda.get_device_name(0)
    res = statusz["resources"]
    roof = statusz["decode_roofline"]
    require(health["ok"] and health["requests_finished"] == len(bodies) + 1, f"healthz {health}")
    require(all(res[k] is not None for k in ("hbm_bytes_in_use", "hbm_peak_bytes_in_use",
                                             "hbm_bytes_limit", "live_buffer_bytes")),
            f"/statusz resources without HBM fields: {res}")
    require(statusz["manifest"]["device_kind"] == kind, f"manifest {statusz['manifest']}")
    require(roof["peak_flops_per_sec"] and roof["peak_hbm_bytes_per_sec"]
            and roof["ridge_flops_per_byte"], f"decode roofline without peaks: {roof}")
    require(statusz["compiled_programs"] >= 1, "no kernel library loaded in the server")
    for answer in answers:
        require(answer["finish_reason"] in ("length", "stop") and answer["token_ids"]
                and isinstance(answer["completion"], str), f"answer {answer}")
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    bad = [(r.get("kind"), validate_record(r)) for r in records if validate_record(r)]
    require(not bad, f"{label} JSONL records fail the schema: {bad[:5]}")
    kinds = {r.get("kind") for r in records}
    paths = {r.get("path") for r in records if r.get("kind") == "span"}
    require({"manifest", "span", "engine", "footer"} <= kinds, f"{label} JSONL kinds {kinds}")
    require({"serve/queue_wait", "serve/prefill", "serve/decode"} <= paths, f"spans {paths}")
    require(records[-1]["kind"] == "footer" and records[-1]["clean"], "no clean footer")

    payload = load_checkpoint(ckpt)
    stop_id = tokenizer.encode(SERVE_SPECIAL)[0]
    with ServingEngine(params_from_jax(payload["params"], "cuda"), cfg, slots=8,
                       default_stop_id=stop_id, device="cuda", **engine_kw) as serving:
        serving.generate(list(range(20)), max_new_tokens=4, temperature=0.0)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        handles = [serving.submit(Request(
            prompt_ids=tuple(tokenizer.encode(b["prompt"])), max_new_tokens=64, stop_id=stop_id,
            **{k: b[k] for k in ("temperature", "top_k", "top_p", "seed") if k in b}))
            for b in bodies]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        local_wall = time.perf_counter() - t0
        counts = read_counts(tuple(KERNEL_META))
    log(f"{label} in-process launches: {counts}")
    for name in KERNEL_META:
        want_launched = name in kernels
        require((counts[name] >= 1) == want_launched,
                f"{label}: kernel {name} launched {counts[name]} times")
    for body, answer, result in zip(bodies, answers, results):
        if body["temperature"] == 0.0:
            require(answer["token_ids"] == list(result.token_ids),
                    f"{label}: greedy ids over HTTP {answer['token_ids'][:8]}... != in-process "
                    f"{list(result.token_ids)[:8]}...")

    http_tokens = sum(len(a["token_ids"]) for a in answers)
    local_tokens = sum(len(r.token_ids) for r in results)
    http_ttft = [a["timings"]["queue_wait_s"] + a["timings"]["prefill_s"] for a in answers]
    local_ttft = [r.queue_wait_s + r.prefill_s for r in results]
    # TTFT of the burst alone: the warm-up request's is scraped out.
    p50, p95 = (histogram_quantile(metrics, metrics_before, "bpe_tpu_request_phase_seconds",
                                   'phase="ttfb"', q) for q in (0.5, 0.95))
    row = {
        "label": label, "card": smi, "requests": len(bodies),
        "http_tokens": http_tokens, "http_wall_s": http_wall,
        "http_tok_s": http_tokens / http_wall,
        "http_ttft_p50_s_metrics": p50, "http_ttft_p95_s_metrics": p95,
        "http_ttft_p50_s": float(np.percentile(http_ttft, 50)),
        "http_ttft_p95_s": float(np.percentile(http_ttft, 95)),
        "local_tokens": local_tokens, "local_wall_s": local_wall,
        "local_tok_s": local_tokens / local_wall,
        "local_ttft_p50_s": float(np.percentile(local_ttft, 50)),
        "local_ttft_p95_s": float(np.percentile(local_ttft, 95)),
        "counts": counts,
    }
    log(f"{smi}: {label} over HTTP: {len(bodies)} requests, {http_tokens} tokens in "
        f"{http_wall:.3f} s = {row['http_tok_s']:.1f} tok/s; TTFT from /metrics p50 "
        f"{p50:.4f} s, p95 {p95:.4f} s (responses: {pcts(http_ttft)})")
    log(f"{smi}: {label} in-process: {len(bodies)} requests, {local_tokens} tokens in "
        f"{local_wall:.3f} s = {row['local_tok_s']:.1f} tok/s; TTFT {pcts(local_ttft)}")
    return row


def phase_serve_http(torch, smi: str, keep_work: bool = False) -> list[dict]:
    """Phase 13: the port served as a user runs it.  (a) ``train-tokenizer``
    on the repo's markdown (vocabulary 2000, ``<|endoftext|>`` special),
    encode/decode byte-exact, no ``regex`` imported, ``tokenize``; (b)
    ``serve`` on a seeded GPT2_SMALL_32K checkpoint (bf16, the kernel
    knobs) answering 16 concurrent text requests over HTTP, against the
    same requests in-process (B1, B2, B3 launched); (c) the same at
    ``--paged --kv-dtype int8 --weight-dtype int8 --fused-sampling
    --decode-attention paged`` with 8 requests (B7, B8, B9 launched); (d)
    ``generate`` against ``generate_ids`` and ``eval`` against the
    in-process loss.  Returns the HTTP/in-process rows.  ``keep_work``
    leaves the tokenizer, corpus and checkpoint in ``SERVE_WORK`` for phase
    14 (which removes them); a failure removes them here."""
    import dataclasses
    import shutil

    import numpy as np

    from bpe_transformer_tpu_torch.checkpointing import load_checkpoint, save_checkpoint
    from bpe_transformer_tpu_torch.data import get_batch, load_token_file
    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params, params_from_jax
    from bpe_transformer_tpu_torch.tokenization import BPETokenizer
    from bpe_transformer_tpu_torch.training.sampling import generate_ids
    from bpe_transformer_tpu_torch.training.train_step import make_eval_step

    shutil.rmtree(SERVE_WORK, ignore_errors=True)
    SERVE_WORK.mkdir(parents=True)
    try:
        # 13a: the tokenizer.
        corpus = SERVE_SPECIAL.join(p.read_text(encoding="utf-8")
                                    for p in sorted(ROOT.glob("*.md")))
        (SERVE_WORK / "corpus.txt").write_text(corpus, encoding="utf-8")
        t0 = time.perf_counter()
        port_cli("train-tokenizer", "--input", str(SERVE_WORK / "corpus.txt"), "--vocab-size",
                 str(SERVE_VOCAB), "--output-dir", str(SERVE_WORK / "tok"))
        TIMINGS["13a train-tokenizer s"] = time.perf_counter() - t0
        tok = BPETokenizer.from_files(SERVE_WORK / "tok" / "vocab.pkl",
                                      SERVE_WORK / "tok" / "merges.pkl", [SERVE_SPECIAL])
        require(len(tok.vocab) == SERVE_VOCAB, f"vocabulary of {len(tok.vocab)}")
        ids = tok.encode(corpus)
        require(tok.decode(ids).encode() == corpus.encode(), "encode/decode not byte-exact")
        require("regex" not in sys.modules, "the regex package was imported")
        out = port_cli("tokenize", "--input", str(SERVE_WORK / "corpus.txt"), "--tokenizer-dir",
                       str(SERVE_WORK / "tok"), "--output", str(SERVE_WORK / "tokens.bin"))
        tokens = np.fromfile(SERVE_WORK / "tokens.bin", np.uint16)
        with open(SERVE_WORK / "corpus.txt", encoding="utf-8") as f:
            streamed = list(tok.encode_iterable(f))
        require(tokens.tolist() == streamed, "the token file differs from encode_iterable()")
        TIMINGS["13a tokenizer s"] = time.perf_counter() - t0
        log(f"13a tokenizer: {len(corpus)} chars -> {len(ids)} tokens, vocabulary "
            f"{len(tok.vocab)}, round trip byte-exact, no regex "
            f"({TIMINGS['13a tokenizer s']:.1f} s); {out.strip()}")

        # 13b: dense serving over HTTP.
        cfg = dataclasses.replace(GPT2_SMALL_32K, **KERNEL_KNOBS)
        ckpt = SERVE_WORK / "gpt2_small_32k.ckpt"
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(13), device="cuda")
        save_checkpoint(ckpt, params=params, extra={"model_config": dataclasses.asdict(cfg)})
        del params
        bodies = serve_requests(tok, corpus, 16)
        rows = [serve_over_http(torch, smi, "13b dense", ckpt, tok, cfg, bodies, [], {},
                                SERVING_KERNELS)]

        # 13c: paged int8 with the fused tail.
        paged_cfg = dataclasses.replace(cfg, decode_attention_impl="paged")
        rows.append(serve_over_http(
            torch, smi, "13c paged int8", ckpt, tok, paged_cfg, bodies[:8],
            ["--paged", "--kv-dtype", "int8", "--weight-dtype", "int8", "--fused-sampling",
             "--decode-attention", "paged"],
            dict(paged=True, kv_dtype="int8", weight_dtype="int8", fused_sampling=True),
            ("paged_decode_attention", "quant_matmul", "fused_head_sample")))

        # 13d: generate and eval.
        payload = load_checkpoint(ckpt)
        prompt = corpus[:400].replace(SERVE_SPECIAL, " ")
        out = json.loads(port_cli(
            "generate", "--checkpoint", str(ckpt), "--tokenizer-dir", str(SERVE_WORK / "tok"),
            "--prompt", prompt, "--max-new-tokens", "32", "--temperature", "0",
            "--print-ids"))
        want = generate_ids(payload["params"], cfg, tok.encode(prompt), max_new_tokens=32,
                            temperature=0.0, stop_id=tok.encode(SERVE_SPECIAL)[0],
                            device="cuda")
        require(out["token_ids"] == want and len(want) >= 1,
                f"generate ids {out['token_ids']} != {want}")
        out = json.loads(port_cli(
            "eval", "--checkpoint", str(ckpt), "--data", str(SERVE_WORK / "tokens.bin"),
            "--batches", "2", "--batch-size", "4"))
        params = params_from_jax(payload["params"], "cuda")
        data = load_token_file(SERVE_WORK / "tokens.bin")
        rng = np.random.default_rng(0)
        eval_step = make_eval_step(cfg)
        losses = []
        for _ in range(2):
            x, y = get_batch(data, 4, cfg.context_length, rng)
            losses.append(float(eval_step(params, torch.as_tensor(x, device="cuda"),
                                          torch.as_tensor(y, device="cuda"))))
        want = float(np.mean(losses))
        require(math.isfinite(out["val_loss"]) and abs(out["val_loss"] - want) <= 1e-4,
                f"eval val_loss {out['val_loss']} vs in-process {want}")
        log(f"13d generate: 32 greedy ids equal generate_ids; eval val_loss "
            f"{out['val_loss']:.6f} (in-process {want:.6f})")
    except BaseException:
        keep_work = False
        raise
    finally:
        if not keep_work:
            shutil.rmtree(SERVE_WORK, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_serve.json").write_text(json.dumps(rows, indent=1))
    return rows


# ------------------------------------------------------------ phase 14

#: Phase 14's replicas serve phase 13's checkpoint with phase 13c's flags.
FLEET_FLAGS = ["--paged", "--kv-dtype", "int8", "--weight-dtype", "int8", "--fused-sampling",
               "--decode-attention", "paged"]
FLEET_ENGINE_KW = dict(paged=True, kv_dtype="int8", weight_dtype="int8", fused_sampling=True)
FLEET_KERNELS = ("paged_decode_attention", "quant_matmul", "fused_head_sample")
#: Phase 14a's migrations over phase 9c's first 8 requests: an int
#: migrates after that many tokens, "prefill" after the first 256-token
#: chunk; the other requests never move.  The speculative run's plan indexes
#: the 4 greedy ones among them.
MIGRATION_PLAN = {0: 16, 2: 16, 5: 16, 7: 16, 1: "prefill", 6: "prefill"}
SPEC_MIGRATION_PLAN = {0: 16, 1: "prefill", 2: 16}
#: Phase 14b's burst: 8 prompts of 15-300 tokens cut from the corpus at
#: other offsets than phase 13's (a prompt served before would hit the
#: replicas' prefix caches, and a prefill that starts after shared blocks
#: rounds its bf16 KV differently), 256 new tokens each.
BURST_OFFSET = 7777
BURST = (0, 2, 4, 6, 8, 10, 11, 15)
#: The greedy request among the same 16 that decode B moves to decode C
#: (``/admin/evacuate``) through a relay whose first attempt is dropped.
REBALANCED = 12


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive_migrating(torch, src, dst, requests, plan: dict, sessions: list | None = None,
                    dst_launches: dict | None = None) -> list:
    """Serve ``requests`` on the engine ``src`` through begin /
    prefill_step / tick, all admitted at once, and move the ones ``plan``
    names to ``dst`` (an int: after that many tokens; ``"prefill"``: after
    the first prefill chunk): export_slot, payload_to_bytes (zlib),
    payload_from_bytes, import_slot.  ``sessions`` gets each move's raw and
    zlib bytes and its export and import ms (host clock, the card
    synchronized); ``dst_launches`` the kernel launches of ``dst``'s own
    calls (its imports, prefill chunks and ticks).  Returns every request's
    tokens."""
    from bpe_transformer_tpu_torch.serving.kvpool.migrate import (
        payload_from_bytes,
        payload_to_bytes,
    )

    names = tuple(KERNEL_META)
    if dst_launches is not None:
        dst_launches.update({name: 0 for name in names})

    def on(side: int, fn, *args):
        """``fn(*args)``, its launches added to ``dst_launches`` when
        ``side`` is the importing engine's."""
        if side == 0 or dst_launches is None:
            return fn(*args)
        before = read_counts(names)
        try:
            return fn(*args)
        finally:
            for name, n in read_counts(names).items():
                dst_launches[name] += n - before[name]

    outs = {i: [] for i in range(len(requests))}
    owner = {}
    for i, r in enumerate(requests):
        slot = src.begin(list(r.prompt_ids), max_new_tokens=r.max_new_tokens,
                         temperature=r.temperature, top_k=r.top_k, top_p=r.top_p, seed=r.seed,
                         request_id=f"r{i}")
        owner[(0, slot)] = i
    moved = set()

    def migrate(slot: int, i: int) -> None:
        sync(torch, src.device)
        t0 = time.perf_counter()
        payload = src.export_slot(slot, {"history": list(requests[i].prompt_ids) + outs[i],
                                         "emitted": list(outs[i])})
        export_ms = (time.perf_counter() - t0) * 1e3
        raw = len(payload_to_bytes(payload, codec="raw"))
        t0 = time.perf_counter()
        data = payload_to_bytes(payload, codec="zlib")
        zlib_ms = (time.perf_counter() - t0) * 1e3
        src.release(slot)
        del owner[(0, slot)]
        payload = payload_from_bytes(data)
        sync(torch, dst.device)
        t0 = time.perf_counter()
        owner[(1, on(1, dst.import_slot, payload))] = i
        sync(torch, dst.device)
        import_ms = (time.perf_counter() - t0) * 1e3
        moved.add(i)
        if sessions is not None:
            sessions.append({
                "request": i, "prompt_len": len(requests[i].prompt_ids),
                "at": plan[i], "tokens_before": len(outs[i]),
                "blocks": payload["meta"]["n_blocks"], "raw_bytes": raw, "zlib_bytes": len(data),
                "export_ms": export_ms, "zlib_ms": zlib_ms, "import_ms": import_ms,
            })

    engines = (src, dst) if dst is not None else (src,)
    while owner:
        for side, eng in enumerate(engines):
            for slot in list(eng.pending_prefills()):
                i = owner[(side, slot)]
                event = on(side, eng.prefill_step, slot)
                if event is None:
                    if side == 0 and plan.get(i) == "prefill" and i not in moved:
                        migrate(slot, i)
                    continue
                outs[i].append(event.token)
                if event.finished:
                    del owner[(side, slot)]
            for event in on(side, eng.tick):
                i = owner[(side, event.slot)]
                outs[i].append(event.token)
                if event.finished:
                    del owner[(side, event.slot)]
        for (side, slot), i in list(owner.items()):
            at = plan.get(i)
            if (side == 0 and isinstance(at, int) and i not in moved and len(outs[i]) >= at
                    and src._active[slot]):
                migrate(slot, i)
    require(moved == set(plan), f"planned migrations {sorted(plan)} but moved {sorted(moved)}")
    return [outs[i] for i in range(len(requests))]


def phase_fleet_engines(torch, smi: str, cfg=None, device: str = "cuda") -> dict:
    """14a: KV migration between two in-process engines at full width
    (GPT2_SMALL_32K, int8 KV + int8 weights, the fused tick tail, blocks of
    16, chunks of 256): phase 9c's first 8 requests, 4 moved mid-decode and
    2 mid-prefill, tokens equal to one engine's that never migrated (greedy
    and seeded sampled alike); then the speculative engine's greedy
    migration (K 4, a two-layer draft).  Launches are counted apart for the
    unmigrated run, the migrated run and the importing engine's own calls
    in it: B7, B8 and B9 in each and nothing else (the speculative runs:
    B10 in each).  Returns the per-session figures."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.serving.kvpool import PagedEngine
    from bpe_transformer_tpu_torch.serving.server import Request
    from bpe_transformer_tpu_torch.serving.spec import DraftSpec, SpecEngine

    cfg = cfg or dataclasses.replace(GPT2_SMALL_32K, **PAGED_KNOBS)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(14), device=device)
    requests = paged_mix(np.random.default_rng(14), cfg.vocab_size)[:8]
    kw = dict(slots=8, block_size=16, prefill_chunk=256, kv_dtype="int8", weight_dtype="int8",
              fused_sampling=True, device=device)
    on_card = torch.device(device).type == "cuda"
    out = {"card": smi}

    for label, build, plan, reqs in (
        ("paged", lambda: PagedEngine(params, cfg, **kw), MIGRATION_PLAN, requests),
        ("spec", lambda: SpecEngine(params, cfg, draft=DraftSpec(truncate_layers=2),
                                    speculate_k=4, **kw),
         SPEC_MIGRATION_PLAN, [r for r in requests if r.temperature == 0.0]),
    ):
        ref_engine, src, dst = build(), build(), build()
        # Warm-up outside the counted run (cuBLAS handles, allocator pools).
        for eng in (ref_engine, src, dst):
            drive_migrating(torch, eng, None, [Request(prompt_ids=tuple(range(20)),
                                                       max_new_tokens=4, temperature=0.0)], {})
        sync(torch, device)
        reset_counts()
        t0 = time.perf_counter()
        want = drive_migrating(torch, ref_engine, None, reqs, {})
        sync(torch, device)
        ref_wall = time.perf_counter() - t0
        ref_counts = read_counts(tuple(KERNEL_META))
        sessions: list = []
        dst_counts: dict = {}
        reset_counts()
        t0 = time.perf_counter()
        got = drive_migrating(torch, src, dst, reqs, plan, sessions, dst_counts)
        sync(torch, device)
        mig_wall = time.perf_counter() - t0
        counts = read_counts(tuple(KERNEL_META))
        for i, (a, b) in enumerate(zip(want, got)):
            require(a == b and len(a) == reqs[i].max_new_tokens,
                    f"14a {label} request {i} (temperature {reqs[i].temperature}): migrated "
                    f"tokens {b[:8]}... != unmigrated {a[:8]}... ({len(b)} vs {len(a)})")
        runs = {"unmigrated run": ref_counts, "migrated run": counts,
                "importing engine": dst_counts}
        log(f"14a {label} launches: "
            + "; ".join(f"{k} {launched(v)}" for k, v in runs.items()))
        for what, c in runs.items():
            if on_card and label == "paged":
                for name in KERNEL_META:
                    require((c[name] >= 1) == (name in FLEET_KERNELS),
                            f"14a paged {what}: kernel {name} launched {c[name]} times")
            elif on_card:
                require(c["fused_verify_head"] >= 1, f"14a spec {what}: B10 never launched")
        for row in sessions:
            log(f"{smi}: 14a {label} session {row['request']} (prompt {row['prompt_len']}, "
                f"moved at {row['at']}, {row['tokens_before']} tokens emitted, "
                f"{row['blocks']} blocks): raw {row['raw_bytes']} B, zlib {row['zlib_bytes']} B "
                f"({row['zlib_ms']:.1f} ms), export {row['export_ms']:.2f} ms, import "
                f"{row['import_ms']:.2f} ms")
        log(f"{smi}: 14a {label}: {len(reqs)} requests token-identical after "
            f"{len(sessions)} migrations; unmigrated run {ref_wall:.3f} s, migrated run "
            f"{mig_wall:.3f} s")
        out[label] = {"sessions": sessions, "counts": counts, "ref_counts": ref_counts,
                      "importer_counts": dst_counts, "ref_wall_s": ref_wall,
                      "migrated_wall_s": mig_wall}
        del ref_engine, src, dst
    return out


def replica_launches(base: str) -> dict:
    """A serve replica's kernel launches so far, per kernel (its
    ``/statusz``)."""
    counts = http_json(base + "/statusz")["resources"]["kernel_launches"]
    return {name: counts.get(name, 0) for name in KERNEL_META}


def launches_since(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in KERNEL_META}


def launched(counts: dict) -> dict:
    """The kernels launched at least once, for a log line."""
    return {name: n for name, n in counts.items() if n}


def require_fleet_launches(what: str, grown: dict, need=FLEET_KERNELS) -> None:
    """One replica's (or replicas') launches in a window: each of ``need``
    launched, and no kernel off the fleet's path."""
    missing = [name for name in need if grown[name] < 1]
    stray = {name: n for name, n in grown.items() if n and name not in FLEET_KERNELS}
    require(not missing and not stray,
            f"14b {what}: launches {grown}; never launched {missing}, off the path {stray}")


def http_raw(url: str, data: bytes, headers: dict, timeout: float = 600) -> tuple[int, bytes]:
    """POST ``data``; returns (status, body) for errors too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def fleet_reference(torch, cfg, ckpt: Path, tokenizer, bodies: list, device: str) -> tuple:
    """The fleet's requests on one in-process paged int8 engine (phase
    13c's), all at once: greedy ids to hold the fleet to, its tok/s and
    TTFT, and the launch counts."""
    import numpy as np

    from bpe_transformer_tpu_torch.checkpointing import load_checkpoint
    from bpe_transformer_tpu_torch.models.transformer import params_from_jax
    from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine

    stop_id = tokenizer.encode(SERVE_SPECIAL)[0]
    payload = load_checkpoint(ckpt)
    with ServingEngine(params_from_jax(payload["params"], device), cfg, slots=8,
                       default_stop_id=stop_id, device=device, **FLEET_ENGINE_KW) as serving:
        serving.generate(list(range(20)), max_new_tokens=4, temperature=0.0)
        runs = []
        for group in bodies:
            sync(torch, device)
            reset_counts()
            t0 = time.perf_counter()
            handles = [serving.submit(Request(
                prompt_ids=tuple(tokenizer.encode(b["prompt"])), stop_id=stop_id,
                **{k: b[k] for k in ("max_new_tokens", "temperature", "top_k", "top_p", "seed")
                   if k in b})) for b in group]
            results = [h.result(timeout=900) for h in handles]
            sync(torch, device)
            wall = time.perf_counter() - t0
            ttft = [r.queue_wait_s + r.prefill_s for r in results]
            runs.append({
                "ids": [list(r.token_ids) for r in results],
                "tokens": sum(len(r.token_ids) for r in results), "wall_s": wall,
                "tok_s": sum(len(r.token_ids) for r in results) / wall,
                "ttft_p50_s": float(np.percentile(ttft, 50)),
                "ttft_p95_s": float(np.percentile(ttft, 95)),
                "counts": read_counts(tuple(KERNEL_META)),
            })
    return runs


def phase_fleet_http(torch, smi: str, cfg, work: Path, rows13: list | None = None,
                     device: str = "cuda") -> dict:
    """14b and 14c: the fleet as subprocesses of the port's CLI on one card.
    ``serve --role prefill``, two ``serve --role decode`` (A drains with
    ``--evacuate-to`` B) and ``route --prefill-threshold 256`` over them
    answer phase 13's 16 text requests (greedy ids equal to one in-process
    engine's, no failed request, migrations counted on both sides); a burst
    of 8 requests with 256 new tokens, half sent to A and half through the
    router, during which A gets SIGTERM and evacuates its sessions to B (no
    failed request, greedy ids equal, "drained cleanly"); a prefill replica
    restarted with a corrupting ``BT_FAULTS`` plan, whose payload B refuses
    with a 400 and whose clean re-export, sent twice under one idempotency
    key, B grafts once; a session B moves to a third decode replica C that
    drops its first ``/kv/import``, so that B's relay retries under one key
    (C grafts once, greedy ids equal).  Each replica's own kernel launches
    (``/statusz``) hold B7, B8 and B9 and nothing else.  14c: ``fleet
    --once`` (schema-valid fleet and SLO records), ``control`` observe-only
    over a running ``fleet`` for a few ticks, and ``incident`` over the
    replicas' flight recorders."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bpe_transformer_tpu_torch.telemetry import validate_record
    from bpe_transformer_tpu_torch.tokenization import BPETokenizer

    on_card = torch.device(device).type == "cuda"
    tok = BPETokenizer.from_files(work / "tok" / "vocab.pkl", work / "tok" / "merges.pkl",
                                  [SERVE_SPECIAL])
    corpus = (work / "corpus.txt").read_text(encoding="utf-8")
    ckpt = work / "gpt2_small_32k.ckpt"
    bodies = serve_requests(tok, corpus, 16)
    fresh = serve_requests(tok, corpus[BURST_OFFSET:], 16)
    burst = [dict(fresh[i], max_new_tokens=256) for i in BURST]
    rebalanced = dict(fresh[REBALANCED], max_new_tokens=256)
    ref16, ref_burst, ref_moved = fleet_reference(torch, cfg, ckpt, tok,
                                                  [bodies, burst, [rebalanced]], device)
    if on_card:
        for name in KERNEL_META:
            require((ref16["counts"][name] >= 1) == (name in FLEET_KERNELS),
                    f"14b reference: kernel {name} launched {ref16['counts'][name]} times")
    log(f"{smi}: 14b single engine in-process: 16 requests, {ref16['tokens']} tokens in "
        f"{ref16['wall_s']:.3f} s = {ref16['tok_s']:.1f} tok/s; TTFT p50 "
        f"{ref16['ttft_p50_s']:.4f} s, p95 {ref16['ttft_p95_s']:.4f} s; launches "
        f"{launched(ref16['counts'])}")

    base = ["--checkpoint", str(ckpt), "--tokenizer-dir", str(work / "tok"), "--slots", "8",
            *FLEET_FLAGS] + ([] if on_card else ["--device", "cpu"])

    procs: dict = {}

    def start(**specs) -> None:
        """Start serve replicas together, each on a port of its own choosing:
        ``name=(log name, extra argv, extra environment)``, into ``procs``."""
        with ThreadPoolExecutor(max_workers=len(specs)) as pool:
            futures = {name: pool.submit(
                ServeProcess, [*base, "--port", "0", "--metrics-jsonl",
                               str(work / f"{log_name}.jsonl"), *extra],
                work / f"{log_name}.log", env=env)
                for name, (log_name, extra, env) in specs.items()}
            errors = []
            for name, fut in futures.items():
                try:
                    procs[name] = fut.result()
                except BaseException as exc:  # noqa: BLE001 -- stop the others first
                    errors.append(exc)
        if errors:
            raise errors[0]

    out: dict = {"card": smi, "reference": {k: v for k, v in ref16.items() if k != "ids"}}
    try:
        # Decode B first: A's --evacuate-to names the address B bound.
        t0 = time.perf_counter()
        start(prefill=("prefill", ("--role", "prefill"), None),
              decode_b=("decode_b", ("--role", "decode"), None))
        start(decode_a=("decode_a", ("--role", "decode", "--evacuate-to",
                                     procs["decode_b"].base), None))
        log(f"14b three serve replicas up in {time.perf_counter() - t0:.1f} s")
        pre, dec_a, dec_b = procs["prefill"].base, procs["decode_a"].base, procs["decode_b"].base
        procs["router"] = ServeProcess(
            ["--replica", pre, "--replica", dec_a, "--replica", dec_b, "--port", "0",
             "--prefill-threshold", "256", "--poll-interval", "0.5", "--metrics-jsonl",
             str(work / "router.jsonl")], work / "router.log", command="route",
            banner="routing on http://")
        router = procs["router"].base
        deadline = time.monotonic() + 60
        while http_json(router + "/statusz")["available"] < 3:
            require(time.monotonic() < deadline, "the router never saw three replicas")
            time.sleep(0.2)

        # Warm-up outside the measured burst: each decode replica serves a
        # request, and a prefix moves prefill -> decode A and B.
        warm = {"prompt_ids": list(range(300)), "max_new_tokens": 4, "temperature": 0.0}
        for dec in (dec_a, dec_b):
            http_json(dec + "/generate", dict(warm, prompt_ids=list(range(20))))
            code, data = http_raw(pre + "/kv/export", json.dumps(warm).encode(),
                                  {"Content-Type": "application/json", "X-KV-Accept": "zlib"})
            require(code == 200, f"warm-up export: HTTP {code}")
            code, _ = http_raw(dec + "/kv/import", data,
                               {"Content-Type": "application/octet-stream"})
            require(code == 200, f"warm-up import: HTTP {code}")

        # The 16 requests through the router.
        before = {n: http_json(procs[n].base + "/healthz") for n in ("prefill", "decode_a",
                                                                       "decode_b")}
        launches0 = {n: replica_launches(procs[n].base) for n in before}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            answers = list(pool.map(lambda b: http_json(router + "/generate", b), bodies))
        wall = time.perf_counter() - t0
        after = {n: http_json(procs[n].base + "/healthz") for n in before}
        launches16 = {n: replica_launches(procs[n].base) for n in before}
        rstat = http_json(router + "/statusz")
        for body, answer, want in zip(bodies, answers, ref16["ids"]):
            require(answer["finish_reason"] in ("length", "stop") and answer["token_ids"],
                    f"14b answer {answer}")
            if body["temperature"] == 0.0:
                require(answer["token_ids"] == want,
                        f"14b greedy ids through the fleet {answer['token_ids'][:8]}... != "
                        f"single engine {want[:8]}...")
        require(rstat["requests_failed"] == 0, f"14b router failed {rstat['requests_failed']}")
        require(rstat["requests_migrated"] > 0, "14b: no request took the two-tier path")

        def moved(n, key):
            return after[n][key] - before[n][key]

        for key in ("migrations_out", "migration_bytes_out"):
            require(moved("prefill", key) > 0, f"14b prefill replica: {key} did not grow")
        for key in ("migrations_in", "migration_bytes_in"):
            require(moved("decode_a", key) + moved("decode_b", key) > 0,
                    f"14b decode replicas: {key} did not grow")
        # Each process's own launches: the prefill replica's chunks run B8's
        # projections; the decode replicas' ticks B7, B8 and B9.
        grown = {n: launches_since(launches0[n], launches16[n]) for n in before}
        decoders = {k: grown["decode_a"][k] + grown["decode_b"][k] for k in KERNEL_META}
        log(f"14b launches in the replicas' processes, 16 requests: prefill "
            f"{launched(grown['prefill'])}; decode A {launched(grown['decode_a'])}; decode B "
            f"{launched(grown['decode_b'])}")
        if on_card:
            require_fleet_launches("prefill replica, 16 requests", grown["prefill"],
                                   need=("quant_matmul",))
            require_fleet_launches("decode replicas, 16 requests", decoders)
        tokens = sum(len(a["token_ids"]) for a in answers)
        ttft = [a["timings"]["queue_wait_s"] + a["timings"]["prefill_s"] for a in answers]
        fleet_row = {
            "requests": len(bodies), "tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p95_s": float(np.percentile(ttft, 95)),
            "requests_migrated": rstat["requests_migrated"],
            "migrations_out": moved("prefill", "migrations_out"),
            "migration_bytes_out": moved("prefill", "migration_bytes_out"),
            "replicas": sorted({str(a.get("replica")) for a in answers}),
            "launches": grown,
        }
        out["fleet"] = fleet_row
        log(f"{smi}: 14b fleet (1 prefill + 2 decode replicas behind the router, threshold "
            f"256): 16 requests, {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s; "
            f"TTFT p50 {fleet_row['ttft_p50_s']:.4f} s, p95 {fleet_row['ttft_p95_s']:.4f} s; "
            f"{rstat['requests_migrated']} requests migrated, "
            f"{fleet_row['migration_bytes_out']} payload bytes out of the prefill replica")
        if rows13:
            c = next((r for r in rows13 if r["label"] == "13c paged int8"), None)
            if c is not None:
                log(f"{smi}: 14b beside 13c (one paged int8 replica, its 8 requests): HTTP "
                    f"{c['http_tok_s']:.1f} tok/s, TTFT p50 {c['http_ttft_p50_s']:.4f} s, p95 "
                    f"{c['http_ttft_p95_s']:.4f} s; in-process {c['local_tok_s']:.1f} tok/s")
                out["13c"] = {k: c[k] for k in ("http_tok_s", "http_ttft_p50_s",
                                                  "http_ttft_p95_s", "local_tok_s")}

        # The burst, and decode replica A drained mid-burst with evacuation.
        # Half of it goes to A itself, so that A holds sessions when the
        # signal comes (the router alone may send a burst elsewhere).
        results: dict = {}

        def send(i_body):
            i, body = i_body
            try:
                results[i] = http_json((dec_a if i % 2 == 0 else router) + "/generate", body)
            except BaseException as exc:  # noqa: BLE001 -- reported below
                results[i] = exc

        threads = [threading.Thread(target=send, args=((i, b),)) for i, b in enumerate(burst)]
        for t in threads:
            t.start()
        # SIGTERM once A holds its four direct requests (and whatever the
        # router sent it) in slots.
        deadline = time.monotonic() + 120
        while http_json(dec_a + "/statusz")["active_slots"] < 4:
            require(time.monotonic() < deadline, "14b: decode replica A never held 4 sessions")
            time.sleep(0.02)
        t_stop = time.perf_counter()
        a_proc = procs.pop("decode_a")
        a_proc.stop()
        drain_s = time.perf_counter() - t_stop
        for t in threads:
            t.join(timeout=900)
        a_records = [json.loads(line) for line in
                     (work / "decode_a.jsonl").read_text().splitlines()]
        evacuated = [r for r in a_records if r.get("kind") == "migration"
                     and r.get("direction") == "evacuate"]
        relayed = [r for r in a_records if r.get("kind") == "migration"
                   and r.get("direction") == "evacuate_relay"]
        require(evacuated and len(relayed) >= len(evacuated),
                f"14b: A evacuated {len(evacuated)} sessions, relayed {len(relayed)}")
        for i, body in enumerate(burst):
            answer = results.get(i)
            require(isinstance(answer, dict), f"14b burst request {i} failed: {answer!r}")
            if body["temperature"] == 0.0:
                require(answer["token_ids"] == ref_burst["ids"][i],
                        f"14b burst greedy ids {answer['token_ids'][:8]}... != unmigrated "
                        f"{ref_burst['ids'][i][:8]}...")
        rstat = http_json(router + "/statusz")
        require(rstat["requests_failed"] == 0, f"14b burst: router failed "
                f"{rstat['requests_failed']}")
        b_grown = launches_since(launches16["decode_b"], replica_launches(dec_b))
        log(f"14b launches in decode B's process, burst and evacuation: {launched(b_grown)}")
        if on_card:
            require_fleet_launches("decode B, burst and evacuation", b_grown)
        out["evacuation"] = {"sessions": len(evacuated),
                             "bytes": sum(r.get("bytes", 0) for r in evacuated),
                             "drain_s": drain_s,
                             "relay_s": [r.get("transfer_s") for r in relayed],
                             "decode_b_launches": b_grown}
        log(f"{smi}: 14b burst of 8 x 256 tokens: decode A drained in {drain_s:.3f} s after "
            f"evacuating {len(evacuated)} sessions "
            f"({out['evacuation']['bytes']} payload bytes) to B; no request failed, greedy ids "
            f"equal the unmigrated run's")

        # A prefill replica that corrupts its next export, and a decode
        # replica C that drops its first /kv/import unanswered.
        procs.pop("prefill").stop()
        once = work / "faults_c"
        start(prefill=("prefill2", ("--role", "prefill"),
                       {"BT_FAULTS": json.dumps({"corrupt_payload": "flip"})}),
              decode_c=("decode_c", ("--role", "decode"), {"BT_FAULTS": json.dumps({
                  "http_blackhole": True, "http_fault_path": "/kv/import",
                  "once_dir": str(once)})}))
        pre, dec_c = procs["prefill"].base, procs["decode_c"].base
        body = json.dumps(bodies[0]).encode()
        export_headers = {"Content-Type": "application/json", "X-KV-Accept": "zlib"}
        import_headers = {"Content-Type": "application/octet-stream",
                          "X-Idempotency-Key": "chip-smoke-14b"}
        grafts0 = http_json(dec_b + "/healthz")["migrations_in"]
        code, bad = http_raw(pre + "/kv/export", body, export_headers)
        require(code == 200, f"14b corrupt export: HTTP {code}")
        code, reply = http_raw(dec_b + "/kv/import", bad, import_headers)
        require(code == 400, f"14b: a corrupted payload got HTTP {code}: {reply[:200]!r}")
        require(http_json(dec_b + "/healthz")["migrations_in"] == grafts0,
                "14b: a corrupted payload was grafted")
        code, good = http_raw(pre + "/kv/export", body, export_headers)
        require(code == 200 and good != bad, f"14b clean re-export: HTTP {code}")
        answers = []
        for _ in range(2):
            code, reply = http_raw(dec_b + "/kv/import", good, import_headers)
            require(code == 200, f"14b retried import: HTTP {code}: {reply[:200]!r}")
            answers.append(json.loads(reply))
        require(answers[0]["token_ids"] == answers[1]["token_ids"] == ref16["ids"][0],
                "14b: the retried graft's ids differ from the single engine's")
        grafts = http_json(dec_b + "/healthz")["migrations_in"] - grafts0
        require(grafts == 1, f"14b: one idempotency key grafted {grafts} times")
        log("14b corrupt payload: 400 from the importer, nothing grafted; the clean re-export "
            "sent twice under one idempotency key grafted once, ids equal the single engine's")

        # The server's relay retrying on its own: B moves a decoding session
        # to C (POST /admin/evacuate); C drops the first /kv/import, B's relay
        # backs off and sends the payload again under the same idempotency
        # key, C grafts it once and decodes the rest.
        stat0 = http_json(dec_b + "/statusz")
        emitted0 = http_json(dec_b + "/healthz")["tokens_emitted"]
        moved_answer: dict = {}

        def send_moved():
            try:
                moved_answer["r"] = http_json(dec_b + "/generate", rebalanced)
            except BaseException as exc:  # noqa: BLE001 -- reported below
                moved_answer["r"] = exc

        sender = threading.Thread(target=send_moved)
        sender.start()
        deadline = time.monotonic() + 120
        while http_json(dec_b + "/healthz")["tokens_emitted"] < emitted0 + 8:
            require(time.monotonic() < deadline, "14b: decode B never decoded the request")
            time.sleep(0.02)
        reply = http_json(dec_b + "/admin/evacuate", {"target": dec_c, "max_sessions": 1})
        require(reply["moved"] == 1, f"14b /admin/evacuate moved {reply}")
        sender.join(timeout=900)
        answer = moved_answer.get("r")
        require(isinstance(answer, dict) and answer["token_ids"] == ref_moved["ids"][0],
                f"14b: the session relayed to C answered {answer!r:.300}, not the single "
                f"engine's ids")
        stat1 = http_json(dec_b + "/statusz")
        require((once / "http_blackhole.fired").exists(), "14b: C's blackhole never fired")
        require(stat1["relays_ok"] - stat0["relays_ok"] == 1
                and stat1["relays_failed"] == stat0["relays_failed"],
                f"14b relay: ok {stat0['relays_ok']} -> {stat1['relays_ok']}, failed "
                f"{stat0['relays_failed']} -> {stat1['relays_failed']}")
        c_grafts = http_json(dec_c + "/healthz")["migrations_in"]
        require(c_grafts == 1, f"14b: C grafted the relayed session {c_grafts} times")
        c_launches = replica_launches(dec_c)
        log(f"14b relay retry: C dropped the first /kv/import, B's relay retried under one "
            f"idempotency key, C grafted once and its ids equal the single engine's; C's "
            f"launches {launched(c_launches)}")
        if on_card:
            require_fleet_launches("decode C after the graft", c_launches)
        out["relay_retry"] = {"rebalanced_out": stat1["rebalanced_out"] - stat0["rebalanced_out"],
                              "c_launches": c_launches}
        procs.pop("decode_c").stop()

        # 14c: the host tooling.
        replicas = ["--replica", pre, "--replica", dec_b]
        port_cli("fleet", *replicas, "--router", router, "--once", "--metrics-jsonl",
                 str(work / "fleet_once.jsonl"), "--poll-timeout", "30")
        records = [json.loads(line) for line in
                   (work / "fleet_once.jsonl").read_text().splitlines()]
        bad_records = [(r.get("kind"), validate_record(r)) for r in records
                       if validate_record(r)]
        kinds = {r.get("kind") for r in records}
        require(not bad_records, f"14c fleet records fail the schema: {bad_records[:5]}")
        require({"fleet", "slo"} <= kinds, f"14c fleet --once wrote kinds {kinds}")
        procs["fleet"] = ServeProcess(
            [*replicas, "--router", router, "--port", "0", "--interval", "0.5",
             "--metrics-jsonl", str(work / "fleet.jsonl")], work / "fleet.log",
            command="fleet", banner="fleet view on http://")
        procs["control"] = ServeProcess(
            ["--fleet", procs["fleet"].base, "--router", router, "--port", "0", "--interval",
             "0.5", "--observe-only", "--metrics-jsonl", str(work / "control.jsonl")],
            work / "control.log", command="control", banner="controlling on http://")
        deadline = time.monotonic() + 60
        while (ctl := http_json(procs["control"].base + "/statusz"))["ticks"] < 3:
            require(time.monotonic() < deadline, f"14c control ticked {ctl['ticks']} times")
            time.sleep(0.2)
        require(ctl["breaker"] == "closed" and ctl["observe_only"], f"14c control {ctl}")
        for name in ("control", "fleet"):
            procs.pop(name).terminate()
        out_incident = work / "incident.jsonl"
        port_cli("incident", *replicas, "--router", router, "--out", str(out_incident))
        bundle = [json.loads(line) for line in out_incident.read_text().splitlines()]
        require(bundle and bundle[-1]["kind"] == "incident"
                and bundle[-1]["hosts_online"] == 3, f"14c incident summary {bundle[-1:]}")
        out["tools"] = {"fleet_once_kinds": sorted(kinds), "control_ticks": ctl["ticks"],
                        "incident_records": len(bundle),
                        "incident_timeline": len(bundle[-1]["timeline"])}
        log(f"14c host tooling: fleet --once wrote {len(records)} schema-valid records "
            f"({sorted(kinds)}); control ticked {ctl['ticks']} times observe-only (breaker "
            f"{ctl['breaker']}); incident bundled {len(bundle)} records, "
            f"{len(bundle[-1]['timeline'])} timeline entries from 3 hosts")

        procs.pop("router").terminate()
        for name in ("prefill", "decode_b"):
            procs.pop(name).stop()
    finally:
        for proc in procs.values():
            proc.kill()
    return out


def phase_fleet(torch, smi: str, rows13: list) -> None:
    """Phase 14: the serving fleet (14a in-process migration, 14b and 14c
    the fleet over HTTP on phase 13's checkpoint and tokenizer); writes
    ``chip_smoke_fleet.json``."""
    import dataclasses

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K

    t0 = time.perf_counter()
    out = {"14a": phase_fleet_engines(torch, smi)}
    log(f"14a in-process migration: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(GPT2_SMALL_32K, **PAGED_KNOBS)
    out["14b"] = phase_fleet_http(torch, smi, cfg, SERVE_WORK, rows13)
    log(f"14b-c the fleet over HTTP: ok ({time.perf_counter() - t0:.1f} s)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_fleet.json").write_text(json.dumps(out, indent=1, default=str))


# ------------------------------------------------------------ phase 15

#: Phase 15's working files (token file, checkpoints, streams), inside the
#: checkout and removed at the end of the phase.
TRAIN_WORK = ROOT / ".scratch" / "chip_smoke_train"


def train_subprocess(argv: list, faults: dict | None = None, timeout: float = 600):
    """The port's ``train`` CLI in a fresh process, as a user runs it;
    returns the finished process (the caller checks its exit code)."""
    env = {**os.environ, "BT_FAULTS": json.dumps(faults)} if faults else None
    return subprocess.run([sys.executable, *PORT_CLI, "train", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def step_records(records: list) -> list:
    return [r for r in records if r.get("kind") is None and "loss" in r]


def span_seconds(records: list, name: str, **attrs) -> list:
    return [r["dur_s"] for r in records if r.get("kind") == "span" and r.get("name") == name
            and all(r.get(k) == v for k, v in attrs.items())]


#: The text of the warning that :func:`_step_marks`'s injector raises as
#: each loop step begins, followed by the step's index.
STEP_MARK = "loop step "


def count_syncs(torch, fn, n: int) -> list:
    """Synchronising CUDA calls that ``torch.cuda.set_sync_debug_mode`` flags
    while ``fn`` runs ``n`` times: ``filename:line`` of each, in order (one
    entry per call).  A warning whose text starts with :data:`STEP_MARK`
    stands in the list as itself, so a caller can split it by step."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message) if str(w.message).startswith(STEP_MARK)
            else f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if str(w.message).startswith(STEP_MARK) or "synchroniz" in str(w.message).lower()]


def phase_training_loop(torch, smi: str, cfg=None, device: str = "cuda", batch: int = 8) -> dict:
    """Phase 15: the training loop as a user runs it, at GPT2_SMALL_32K with
    phase 8's knobs; returns the launch counts of (a), the slice's main
    path, and writes ``chip_smoke_loop.json``."""
    import dataclasses
    import shutil

    import numpy as np

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.resilience.faults import FaultInjector, FaultPlan
    from bpe_transformer_tpu_torch.telemetry.schema import validate_record
    from bpe_transformer_tpu_torch.telemetry.watchdog import NonFiniteError
    from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    cfg = cfg or dataclasses.replace(
        GPT2_SMALL_32K, attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas",
        remat_policy="save_attn",
    )
    L, ctx = cfg.num_layers, cfg.context_length
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    TRAIN_WORK.mkdir(parents=True)
    data_path = TRAIN_WORK / "tokens.bin"
    # Zipf-distributed tokens: a unigram law the loss can fall towards
    # within a few steps.
    zipf = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
    data = np.random.default_rng(15).choice(cfg.vocab_size, size=2_000_000,
                                            p=zipf / zipf.sum()).astype(np.uint16)
    data.tofile(data_path)
    cfg.to_json(TRAIN_WORK / "model.json")
    hp = dict(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=2)
    quiet = lambda *a: None  # noqa: E731
    out: dict = {"smi": smi}

    def loop(**kw):
        base = dict(steps=8, batch_size=batch, log_every=4, eval_every=1000, seed=0)
        return LoopConfig(**{**base, **kw})

    def run(lc, c=None, **kw):
        return train(c or cfg, TrainHParams(**hp, cosine_cycle_iters=lc.steps), lc, data,
                     log_fn=quiet, device=device, **kw)

    # 15d and 15e run their subprocesses at 2 of the 12 layers (full width):
    # each of their checkpoints is then 0.76 GB instead of 1.61 GB.
    cfg_de = dataclasses.replace(cfg, num_layers=min(2, cfg.num_layers))
    cfg_de.to_json(TRAIN_WORK / "model_de.json")

    def cli_args(steps: int, ck: Path, *extra, every: int = 4, model: str = "model.json") -> list:
        return ["--data", str(data_path), "--model-config", str(TRAIN_WORK / model),
                "--steps", str(steps), "--batch-size", str(batch), "--log-every", "2",
                "--eval-every", "1000", "--checkpoint-every", str(every), "--checkpoint-dir", str(ck),
                "--lr", "6e-4", "--min-lr", "6e-5", "--warmup", "2", "--prefetch", "0",
                "--device", device, *extra]

    # (a) Every tap at once, with eval boundaries counted apart.
    t0 = time.perf_counter()
    ck_a, jsonl_a = TRAIN_WORK / "a_ck", TRAIN_WORK / "a.jsonl"
    steps_a, eval_every, eval_batches = 16, 8, 2
    reset_counts()
    summary = run(loop(steps=steps_a, log_every=2, eval_every=eval_every,
                       eval_batches=eval_batches, checkpoint_every=4,
                       checkpoint_dir=str(ck_a), metrics_jsonl=str(jsonl_a), health_stats=True,
                       dynamics_every=4, watchdog=True, keep_checkpoints=2, prefetch=2,
                       async_checkpoint=True), val_data=data)
    counts_a = read_counts(tuple(KERNEL_META))
    per_step = only(flash_attention_rope=L, flash_attention_bwd_dkdv=L,
                    flash_attention_bwd_dq=L, swiglu=2 * L)
    evals = eval_batches * steps_a // eval_every
    want = {name: per_step[name] * steps_a for name in KERNEL_META}
    want["flash_attention_rope"] += L * evals
    want["swiglu"] += L * evals
    records = read_jsonl(jsonl_a)
    bad = [(r.get("kind"), validate_record(r)) for r in records if validate_record(r)]
    require(not bad, f"15a: stream records fail the schema: {bad[:3]}")
    kinds = {r.get("kind") for r in records}
    steps = step_records(records)
    losses = [r["loss"] for r in steps]
    log(f"15a loop with every tap, {steps_a} steps (B={batch} S={ctx}): losses "
        f"{[round(v, 4) for v in losses]}; kinds {sorted(map(str, kinds))}; launches "
        f"{ {k: v for k, v in counts_a.items() if v} } (a train step "
        f"{ {k: v for k, v in per_step.items() if v} }, {evals} eval batches apart)")
    require("dynamics" in kinds and all("grad_norm/attn" in r and "nonfinite_grads" in r
                                        for r in steps), "15a: no health or dynamics records")
    require([r["step"] for r in records if r.get("kind") == "dynamics"] == [4, 8, 12, 16],
            "15a: dynamics records not every 4 steps")
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"15a: loss not finite or not falling: {losses}")
    if on_card:
        require(counts_a == want, f"15a: launches {counts_a} != {want}")
    snaps = sorted(p.name for p in ck_a.glob("step_*.ckpt"))
    require(snaps == ["step_00000012.ckpt", "step_00000016.ckpt"]
            and (ck_a / "latest.ckpt").is_symlink()
            and (ck_a / "latest.ckpt").resolve().name == "step_00000016.ckpt",
            f"15a: checkpoint dir {sorted(p.name for p in ck_a.iterdir())}")
    for snap in snaps:
        port_cli("verify-checkpoint", str(ck_a / snap))
    text = port_cli("report", str(jsonl_a), "--trace", str(TRAIN_WORK / "trace.json"))
    trace = json.loads((TRAIN_WORK / "trace.json").read_text())
    frame = port_cli("monitor", str(jsonl_a), "--once", "--plain")
    require("== steps" in text and trace["traceEvents"] and "train" in frame,
            "15a: report, trace or monitor output unreadable")
    async_stall = span_seconds(records, "checkpoint", async_save=True)
    out["a"] = {"losses": losses, "launches": counts_a, "async_stall_s": async_stall,
                "step_wall_s": [r["step_wall_s"] for r in steps]}
    log(f"15a verify-checkpoint ok on {snaps}; report {len(text.splitlines())} lines, trace "
        f"{len(trace['traceEvents'])} events, monitor frame ok; async checkpoint stall "
        f"{[round(s * 1e3, 1) for s in async_stall]} ms ({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(ck_a)

    # (b) Sync audit: each tap against the plain step, between log boundaries.
    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    x, y = (torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, ctx)), device=device)
            for _ in range(2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    opt_state = adamw_init(params)
    hparams = TrainHParams(**hp, cosine_cycle_iters=100)
    steps_fn = {"plain": make_train_step(cfg, hparams),
                "health": make_train_step(cfg, hparams, health=True),
                "dynamics": make_train_step(cfg, hparams, dynamics=True)}
    syncs, where, device_us, peak_gb = {}, {}, {}, {}
    for fn in steps_fn.values():  # the first call of each variant, before any count
        fn(params, opt_state, x, y)
    if on_card:
        # The debug mode's own first use is flagged once, whatever runs.
        first = count_syncs(torch, lambda: None, 1)
        log(f"15b set_sync_debug_mode's first use: {first}")
    for name, fn in steps_fn.items():
        if on_card:
            sites = count_syncs(torch, lambda fn=fn: fn(params, opt_state, x, y), 4)
            syncs[name], where[name] = len(sites), sorted(set(sites))
            device_us[name] = profile_step(torch, f"15b {name} GPT2_SMALL_32K",
                                           lambda fn=fn: fn(params, opt_state, x, y),
                                           n_top=3)["device_us"]
            # Peak device memory of one step, the state included.
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn(params, opt_state, x, y)
            torch.cuda.synchronize()
            peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, steps_fn
    if on_card:
        for depth in (0, 2):
            def feed(depth=depth):
                run(loop(steps=6, log_every=6, prefetch=depth))
            sites = count_syncs(torch, feed, 1)
            syncs[f"loop, prefetch {depth}"] = len(sites)
            where[f"loop, prefetch {depth}"] = sorted(set(sites))
        added = {k: syncs[k] - syncs["plain"] for k in ("health", "dynamics")}
        added["prefetch"] = syncs["loop, prefetch 2"] - syncs["loop, prefetch 0"]
        log(f"15b syncs flagged by set_sync_debug_mode (4 steps of each step variant; one "
            f"6-step loop run with its set-up and its one log boundary): {syncs}; added over "
            f"the plain step: {added}; raised at {where}")
        require(all(v == 0 for v in added.values()), f"15b: a tap adds syncs: {added}")
        extra = {k: (None if device_us[k] is None or device_us['plain'] is None
                     else device_us[k] - device_us["plain"]) for k in ("health", "dynamics")}
        log(f"15b device us a step: {device_us}; added by the taps {extra}; peak device GB "
            f"a step {peak_gb}, added by the taps "
            f"{ {k: peak_gb[k] - peak_gb['plain'] for k in ('health', 'dynamics')} } on {smi} "
            f"({time.perf_counter() - t0:.1f} s)")
        out["b"] = {"syncs": syncs, "added_syncs": added, "raised_at": where,
                    "device_us": device_us, "peak_gb": peak_gb}

    # (c) NaN rollback in-process (sync checkpoints), then `raise` as a process.
    t0 = time.perf_counter()
    ck_c, jsonl_c = TRAIN_WORK / "c_ck", TRAIN_WORK / "c.jsonl"
    summary = run(loop(steps=8, log_every=2, checkpoint_every=4, checkpoint_dir=str(ck_c),
                       metrics_jsonl=str(jsonl_c), dynamics_every=2, health_stats=True,
                       watchdog=True, watchdog_policy="rollback"),
                  fault_injector=FaultInjector(FaultPlan(nan_at_step=5)))
    records = read_jsonl(jsonl_c)
    nonfinite = [r for r in records if r.get("kind") == "event" and r.get("name") == "nonfinite"]
    recovery = [r for r in records if r.get("kind") == "recovery"]
    losses = [r["loss"] for r in step_records(records)]
    log(f"15c rollback: nonfinite events {[(r['step'], r.get('path')) for r in nonfinite]}, "
        f"recovery {[(r['step'], r['restored_step'], r.get('nonfinite_path')) for r in recovery]}, "
        f"losses {[round(v, 4) for v in losses]}, summary rollbacks {summary.get('rollbacks')}")
    require(len(nonfinite) == 1 and nonfinite[0]["step"] == 6
            and nonfinite[0].get("path", "").startswith("params/"),
            "15c: the nonfinite event is missing or not localised to a tensor")
    require([(r["step"], r["restored_step"]) for r in recovery] == [(6, 4)],
            f"15c: recovery records {recovery}")
    require(summary["history"][-1]["step"] == 8 and math.isfinite(summary["final_train_loss"]),
            "15c: the run did not finish with a finite loss")
    sync_stall = span_seconds(records, "checkpoint", async_save=False)
    shutil.rmtree(ck_c)
    ck_r, jsonl_r = TRAIN_WORK / "r_ck", TRAIN_WORK / "r.jsonl"
    proc = train_subprocess(cli_args(4, ck_r, "--watchdog", "--metrics-jsonl", str(jsonl_r)),
                            faults={"nan_at_step": 1})
    records = read_jsonl(jsonl_r)
    events = [r.get("name") or r.get("kind") for r in records
              if r.get("kind") in ("event", "blackbox")]
    log(f"15c raise: exit {proc.returncode}, stream events {events}, stderr tail "
        f"{proc.stderr.strip().splitlines()[-1][:160] if proc.stderr.strip() else ''!r}")
    require(proc.returncode not in (0, 75) and "nonfinite" in events and "blackbox" in events
            and "NonFiniteError" in proc.stderr,
            f"15c: raise policy exit {proc.returncode}: {proc.stderr[-2000:]}")
    out["c"] = {"losses": losses, "sync_stall_s": sync_stall, "raise_rc": proc.returncode}
    log(f"15c sync checkpoint stall {[round(s * 1e3, 1) for s in sync_stall]} ms "
        f"({time.perf_counter() - t0:.1f} s)")

    # (d) Preemption: exit 75 and an emergency snapshot, then --resume.
    t0 = time.perf_counter()
    ck_d, jsonl_d = TRAIN_WORK / "d_ck", TRAIN_WORK / "d.jsonl"
    proc = train_subprocess(cli_args(8, ck_d, "--metrics-jsonl", str(jsonl_d), every=8,
                                     model="model_de.json"),
                            faults={"preempt_at_step": 6})
    require(proc.returncode == 75, f"15d: preempted run exit {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    records = read_jsonl(jsonl_d)
    pre = [r for r in records if r.get("kind") == "preemption"]
    require(len(pre) == 1 and pre[0]["step"] == 6 and pre[0]["checkpoint"]
            and Path(pre[0]["checkpoint"]).name == "step_00000006.ckpt",
            f"15d: preemption record {pre}")
    emergency_s = span_seconds(records, "checkpoint", async_save=False)[-1]
    proc = train_subprocess(cli_args(8, ck_d, "--resume", str(ck_d), every=8,
                                     model="model_de.json"))
    require(proc.returncode == 0, f"15d: resume exit {proc.returncode}: {proc.stderr[-2000:]}")
    resumed = json.loads((ck_d / "summary.json").read_text())["history"]
    straight = run(loop(steps=8, log_every=2), c=cfg_de)["history"]
    want = {r["step"]: r["loss"] for r in straight}
    got = {r["step"]: r["loss"] for r in resumed}
    rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
    log(f"15d preempted at step 6 (exit 75, emergency save {emergency_s * 1e3:.1f} ms), resumed "
        f"to 8: losses {got} vs uninterrupted {want}; max rel diff {rel:.2e}, bit-equal "
        f"{all(got[s] == want[s] for s in got)} ({time.perf_counter() - t0:.1f} s)")
    require(sorted(got) == [8] and rel <= 1e-5, f"15d: resumed losses {got} vs {want}")
    out["d"] = {"emergency_save_s": emergency_s, "resumed": got, "straight": want,
                "max_rel": rel}
    shutil.rmtree(ck_d)

    # (e) --supervise: a child killed at step 6 is respawned with --resume.
    t0 = time.perf_counter()
    ck_e = TRAIN_WORK / "e_ck"
    proc = train_subprocess(cli_args(8, ck_e, "--supervise", "--max-restarts", "2",
                                     "--restart-backoff", "0.1", model="model_de.json"),
                            faults={"kill_at_step": 6, "once_dir": str(TRAIN_WORK / "once")})
    require(proc.returncode == 0 and "spawn #2" in proc.stdout,
            f"15e: supervised run exit {proc.returncode}: {proc.stdout[-2000:]}")
    history = json.loads((ck_e / "summary.json").read_text())["history"]
    got = {r["step"]: r["loss"] for r in history}
    rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
    log(f"15e supervised: killed at step 6, respawned once, losses {got}; max rel diff to the "
        f"uninterrupted run {rel:.2e} ({time.perf_counter() - t0:.1f} s)")
    require(sorted(got) == [6, 8] and rel <= 1e-5, f"15e: losses {got} vs {want}")
    shutil.rmtree(ck_e)

    # (f) Inner steps, and a read fault under prefetch.
    t0 = time.perf_counter()
    inner = {n: run(loop(inner_steps=n, log_every=4))["history"] for n in (1, 4)}
    l1, l4 = ([r["loss"] for r in inner[n]] for n in (1, 4))
    rel = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
    log(f"15f inner steps 4 vs 1: losses at steps 4, 8 {l4} vs {l1}, max rel diff {rel:.2e}")
    require([r["step"] for r in inner[4]] == [4, 8] and rel <= 1e-5,
            "15f: inner-step losses differ")
    try:
        run(loop(steps=6, prefetch=2), fault_injector=FaultInjector(FaultPlan(fail_read_at_step=3)))
        raised = None
    except OSError as exc:
        raised = str(exc)
    require(raised is not None and "injected dataset read failure at step 3" in raised,
            f"15f: the read fault did not surface on the main thread: {raised}")
    log(f"15f prefetch 2 read fault surfaced on the main thread: {raised!r} "
        f"({time.perf_counter() - t0:.1f} s)")

    # (g) Host ms a step of each feed and tap.
    t0 = time.perf_counter()
    host_ms = {"plain": inner[1][-1]["step_wall_s"] * 1e3,
               "inner steps 4": inner[4][-1]["step_wall_s"] * 1e3}
    for name, kw in (("health", dict(health_stats=True)), ("dynamics", dict(dynamics_every=4)),
                     ("prefetch 2", dict(prefetch=2))):
        host_ms[name] = run(loop(**kw))["history"][-1]["step_wall_s"] * 1e3
    out["g"] = {"host_ms": host_ms, "sync_stall_s": sync_stall, "async_stall_s": async_stall,
                "emergency_save_s": emergency_s, "phase_s": time.perf_counter() - t_phase}
    log(f"15g host ms a step (steps 5-8, one log window): "
        f"{ {k: round(v, 2) for k, v in host_ms.items()} }; checkpoint stall sync "
        f"{[round(s * 1e3, 1) for s in sync_stall]} ms, async "
        f"{[round(s * 1e3, 1) for s in async_stall]} ms; emergency save "
        f"{emergency_s * 1e3:.1f} ms; phase wall {out['g']['phase_s']:.1f} s on {smi} "
        f"({time.perf_counter() - t0:.1f} s)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_loop.json").write_text(json.dumps(out, indent=1, default=str))
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    return {name: counts_a[name] for name in TRAIN_KERNELS_15}


# ------------------------------------------------------------ phase 16

#: Phase 16's working files (token file, checkpoint, telemetry stream,
#: tokenizer), inside the checkout and removed at the end of the phase.
MOE_WORK = ROOT / ".scratch" / "chip_smoke_moe"
#: 16a: every token whose expert set differs between the card and the CPU
#: must have had its k-th and (k+1)-th router probabilities (on the CPU)
#: within this of each other: a flip only at a near-tie.
ROUTE_MARGIN = 1e-4
#: 16a: the gather and einsum dispatches on the card, max abs error of the
#: output (the issue's bounds; both share one routing).
MOE_DISPATCH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MOE_STAGES = ("router", "dispatch", "experts", "combine")


def moe_stage_ms(torch, tokens, params, cfg, iters: int = 5) -> dict:
    """Ms of each stage of one ``switch_ffn`` call on ``tokens (1, n, d)``
    (``iters`` calls of the stage alone, on the previous stage's outputs),
    and of the whole call: ``{"events": ..., "device": ...}``, CUDA events
    around the calls as Python enqueues them (the router's small kernels
    are timed at the enqueue rate) and around a CUDA graph of them (device
    time alone; the capture also shows that no stage syncs with the
    host)."""
    from bpe_transformer_tpu_torch.models import moe

    e, mode, k = cfg.n_experts, cfg.moe_dispatch, cfg.router_top_k
    cap = moe.expert_capacity(tokens.shape[1], e, cfg.capacity_factor)
    r = moe.route(tokens, params["router"], k, cap)
    expert_in, plan = moe.dispatch(tokens, r, e, cap, mode)
    expert_out = moe.experts(expert_in, params)
    stages = {
        "router": lambda: moe.route(tokens, params["router"], k, cap),
        "dispatch": lambda: moe.dispatch(tokens, r, e, cap, mode),
        "experts": lambda: moe.experts(expert_in, params),
        "combine": lambda: moe.combine(expert_out, r, plan, 1, mode),
        "switch_ffn": lambda: moe.switch_ffn(tokens, params, cfg),
    }
    return {how: {name: time_ms(torch, fn, [()], iters, graph=how == "device")
                  for name, fn in stages.items()} for how in ("events", "device")}


def route_flips(torch, r_dev, r_cpu, top_k: int) -> tuple[int, float, int]:
    """Tokens whose expert set differs between two routings of the same
    tokens, the largest CPU top-k / top-(k+1) probability margin among them,
    and the assignments whose kept flag differs."""
    n = r_cpu["probs"].shape[1]

    def sets(r):
        return torch.sort(r["expert"][0].reshape(top_k, n).t().cpu(), dim=1).values

    flipped = (sets(r_dev) != sets(r_cpu)).any(dim=1)
    top = torch.topk(r_cpu["probs"][0], top_k + 1, dim=-1).values
    margin = float((top[:, top_k - 1] - top[:, top_k])[flipped].max()) if flipped.any() else 0.0
    kept_diff = int((r_dev["kept"][0].cpu() != r_cpu["kept"][0]).sum())
    return int(flipped.sum()), margin, kept_diff


def moe_ffn_alone(torch, smi: str, cfg, batch: int, device: str) -> dict:
    """16a: ``switch_ffn`` at TINYSTORIES_MOE width on ``batch`` x 512
    tokens (weights at the init law, inputs standard normal), float32 and
    bfloat16: gather against einsum on the card, the card's routing against
    the CPU's on the same inputs (flips only at near-ties), the outputs of
    the tokens routed alike within the dispatch tolerance, the drop share,
    and the device ms of each stage of each dispatch."""
    import dataclasses

    from bpe_transformer_tpu_torch.models import moe

    on_card = device == "cuda"
    e, k, d = cfg.n_experts, cfg.router_top_k, cfg.d_model
    n = batch * cfg.context_length
    cap = moe.expert_capacity(n, e, cfg.capacity_factor)
    params32 = moe.init_moe_params(cfg, torch.Generator().manual_seed(16), device)
    x32 = torch.randn(batch, cfg.context_length, d, generator=torch.Generator().manual_seed(17))
    out: dict = {"tokens": n, "capacity": cap}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            params = {name: w.to(dtype) for name, w in params32.items()}
            x = x32.to(device=device, dtype=dtype)
            r = moe.route(x.reshape(1, n, d), params["router"], k, cap)
            got = {mode: moe.switch_ffn(x, params, dataclasses.replace(cfg, moe_dispatch=mode))
                   for mode in ("gather", "einsum")}
            err = _max_err(got["gather"][0], got["einsum"][0])
            aux_err = abs(float(got["gather"][1]) - float(got["einsum"][1]))
            drop = 1.0 - float(r["kept"].float().mean())
            # The same inputs through the port on the CPU.
            params_cpu = {name: w.cpu() for name, w in params.items()}
            r_cpu = moe.route(x.cpu().reshape(1, n, d), params_cpu["router"], k, cap)
            flips, margin, kept_diff = route_flips(torch, r, r_cpu, k)
            ref, _ = moe.switch_ffn(x.cpu(), params_cpu, dataclasses.replace(
                cfg, moe_dispatch="gather"))
            alike = ((r["expert"][0].cpu() == r_cpu["expert"][0])
                     & (r["kept"][0].cpu() == r_cpu["kept"][0])).reshape(k, n).all(dim=0)
            cpu_err = _max_err(got["gather"][0].reshape(n, d).cpu()[alike],
                               ref.reshape(n, d)[alike])
            log(f"16a switch_ffn {dname} ({batch}x{cfg.context_length} tokens, e {e}, top-{k}, "
                f"cap {cap}): gather vs einsum max abs err {err:.3e} (tol "
                f"{MOE_DISPATCH_TOL[dname]:g}), aux |d| {aux_err:.2e}; drop share {drop:.4f}; "
                f"card vs CPU: {flips} tokens route to another expert set (largest CPU top-{k}/"
                f"top-{k + 1} margin among them {margin:.2e}, bound {ROUTE_MARGIN:g}), "
                f"{kept_diff} kept flags differ, tokens routed alike {int(alike.sum())}/{n} "
                f"max abs err {cpu_err:.3e}; on {smi}")
            require(err <= MOE_DISPATCH_TOL[dname] and aux_err <= 1e-6,
                    f"16a {dname}: the gather and einsum dispatches disagree ({err}, {aux_err})")
            require(margin < ROUTE_MARGIN, f"16a {dname}: a token flipped its experts at a "
                    f"router margin of {margin}")
            require(cpu_err <= MOE_DISPATCH_TOL[dname],
                    f"16a {dname}: card vs CPU outputs of tokens routed alike differ by {cpu_err}")
            row = {"gather_vs_einsum": err, "drop_share": drop, "flips": flips,
                   "flip_margin": margin, "kept_diff": kept_diff, "card_vs_cpu": cpu_err}
            if on_card:
                for mode in ("gather", "einsum"):
                    ms = moe_stage_ms(torch, x.reshape(1, n, d), params,
                                      dataclasses.replace(cfg, moe_dispatch=mode))
                    row[f"{mode}_ms"] = ms
                    for how, label in (("device", "device ms (graph replay)"),
                                       ("events", "ms as launched (events)")):
                        log(f"16a {dname} {mode} dispatch {label}: "
                            + ", ".join(f"{name} {v:.3f}" for name, v in ms[how].items())
                            + f" (stages sum {sum(ms[how][st] for st in MOE_STAGES):.3f}) "
                            f"on {smi}")
            out[dname] = row
            del got, ref
    return out


def labelled_moe_stages(torch):
    """``models.moe``'s four stages wrapped in ``record_function`` ranges
    ``moe/<stage>`` (``switch_ffn`` looks them up at each call), for a
    profile of where the MoE forward's device time goes."""
    from bpe_transformer_tpu_torch.models import moe

    def labelled(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"moe/{name}"):
                return fn(*args, **kwargs)
        return call

    return patched(moe, route=labelled("router", moe.route),
                   dispatch=labelled("dispatch", moe.dispatch),
                   experts=labelled("experts", moe.experts),
                   combine=labelled("combine", moe.combine))


def moe_part_profile(torch, run_step) -> dict:
    """Device us of one step's MoE forward by stage: the kernels launched
    inside each ``moe/<stage>`` range (the backward's kernels run outside
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with labelled_moe_stages(torch), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    parts = dict.fromkeys(MOE_STAGES, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("moe/"):
            total = getattr(e, "device_time_total", None)
            parts[e.name[4:]] += total if total is not None else e.cuda_time_total
    return parts


def moe_training(torch, smi: str, cfg, batch: int, device: str, data) -> dict:
    """16b: ``train`` (the loop) at ``batch`` x 512 with health stats and the
    flash kernels, 10 steps; exact launches; ``moe_aux`` in the stream; the
    checkpoint through ``verify-checkpoint``; then for the gather and the
    einsum dispatch a step's synchronising calls (none allowed), step
    profile (kernels and MoE stages), peak memory, and the stream's MFU."""
    import dataclasses

    import numpy as np

    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

    on_card = device == "cuda"
    L, steps = cfg.num_layers, 10
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=2,
                           cosine_cycle_iters=steps)
    ck, jsonl = MOE_WORK / "ck", MOE_WORK / "b.jsonl"
    reset_counts()
    t0 = time.perf_counter()
    train(cfg, hparams, LoopConfig(steps=steps, batch_size=batch, log_every=1, eval_every=1000,
                                   checkpoint_every=steps, checkpoint_dir=str(ck),
                                   metrics_jsonl=str(jsonl), health_stats=True, seed=0),
          data, log_fn=lambda *a: None, device=device)
    wall = time.perf_counter() - t0
    counts = read_counts(tuple(KERNEL_META))
    per_step = only(flash_attention_rope=L, flash_attention_bwd_dkdv=L, flash_attention_bwd_dq=L)
    want = {name: v * steps for name, v in per_step.items()}
    records = step_records(read_jsonl(jsonl))
    losses = [r["loss"] for r in records]
    aux = [r.get("moe_aux") for r in records]
    mfu = [r["mfu"] for r in records if "mfu" in r]
    log(f"16b train {steps} steps (B={batch} S={cfg.context_length}, float32, "
        f"{cfg.attention_impl}, health) in {wall:.1f} s: losses {[round(v, 4) for v in losses]}; "
        f"moe_aux {[round(v, 4) for v in aux]}; stream mfu "
        f"{[round(v, 4) for v in mfu] or 'not measured'} on {smi}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    require(len(records) == steps and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0], f"16b: loss not finite or not falling: {losses}")
    require(all(v is not None and math.isfinite(v) for v in aux),
            f"16b: moe_aux missing or not finite in the stream: {aux}")
    if on_card:
        require(counts == want, f"16b: launches {counts} != {want}")
    text = port_cli("verify-checkpoint", str(ck / "latest.ckpt"))
    log(f"16b verify-checkpoint: {text.strip().splitlines()[-1] if text.strip() else 'ok'}")

    out = {"losses": losses, "moe_aux": aux, "mfu": mfu, "launches": counts, "wall_s": wall}
    if not on_card:
        return out
    rng = np.random.default_rng(16)
    x, y = (torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, cfg.context_length)),
                            device=device) for _ in range(2))
    count_syncs(torch, lambda: None, 1)  # the debug mode's own first use is flagged once
    for mode in ("gather", "einsum"):
        c = dataclasses.replace(cfg, moe_dispatch=mode)
        params = init_params(c, torch.Generator().manual_seed(0), device=device)
        opt_state = adamw_init(params)
        step = make_train_step(c, hparams)
        step(params, opt_state, x, y)  # warm-up
        sites = count_syncs(torch, lambda: step(params, opt_state, x, y), 2)
        syncs, where = len(sites), sorted(set(sites))
        log(f"16b {mode} step: {syncs} synchronising calls in 2 steps {where}")
        require(syncs == 0, f"16b: the {mode} MoE step syncs with the host at {where}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_step(torch, f"16b TINYSTORIES_MOE {mode} step (B={batch})",
                            lambda: step(params, opt_state, x, y))
        peak = torch.cuda.max_memory_allocated()
        parts = moe_part_profile(torch, lambda: step(params, opt_state, x, y))
        log(f"16b {mode} step: host {prof['host_us'] / 1e3:.2f} ms, device "
            f"{(prof['device_us'] or 0) / 1e3:.2f} ms, peak memory {peak / 2**30:.2f} GiB; MoE "
            f"forward device ms a step by stage (12 layers) "
            f"{ {k: round(v / 1e3, 3) for k, v in parts.items()} } on {smi}")
        out[mode] = {**prof, "peak_bytes": peak, "moe_forward_us": parts, "syncs": syncs}
        del params, opt_state, step
    return out


def moe_ring(torch, smi: str, cfg, batch: int, device: str) -> dict:
    """16c: ``make_sp_train_step`` on ``StackedRing(4)`` with the ring-flash
    kernels: step 1's loss and gradients against the dense step's with no
    drop and the aux weight 0 (each rank then routes exactly its tokens of
    the dense routing), then 3 steps of the config's own routing with exact
    launches each."""
    import dataclasses

    import numpy as np

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

    on_card = device == "cuda"
    ring = StackedRing(SP_RANKS)
    rng = np.random.default_rng(17)
    x, y = (rng.integers(0, cfg.vocab_size, size=(batch, cfg.context_length)) for _ in range(2))
    xs, ys = shard_sp_batch((x, y), ring, device=device)
    # A capacity factor of n_experts holds every token of a group: no drop.
    exact = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts), router_aux_weight=0.0)
    params = init_params(exact, torch.Generator().manual_seed(0), device=device)
    tol = TRAIN_TOL["float32"]
    dense_loss, dense_grads = value_and_grad(make_loss_fn(exact))(
        params, torch.as_tensor(x, device=device), torch.as_tensor(y, device=device))
    loss, grads = make_sp_grad_fn(exact, ring)(params, xs, ys)
    pairs = list(zip(tree_leaves(grads), tree_leaves(dense_grads), strict=True))
    loss_err = abs(float(loss) - float(dense_loss))
    grad_err = max(_max_err(a, b) for a, b in pairs)
    rel_err = max(float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in pairs)
    label = f"16c TINYSTORIES_MOE sp contiguous x{SP_RANKS} (B={batch})"
    log(f"{label} step 1 vs the dense step (no drop, aux weight 0): loss {float(loss):.6f} vs "
        f"{float(dense_loss):.6f} (|d| {loss_err:.3e}, tol {tol['out']:g}); grads max abs "
        f"error {grad_err:.3e} (tol {tol['grad']:g}), largest per-leaf relative error "
        f"{rel_err:.3e}; on {smi}")
    require(loss_err <= tol["out"] and grad_err <= tol["grad"] and rel_err <= tol["grad"],
            f"{label}: step 1 disagrees with the dense step")
    del grads, dense_grads, pairs

    per_step = {**sp_launches_per_step(cfg.num_layers, SP_RANKS, False), "swiglu": 0}
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=3)
    opt_state = adamw_init(params)
    step = make_sp_train_step(cfg, hparams, ring)
    totals, losses, host_ms = dict.fromkeys(KERNEL_META, 0), [], []
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, xs, ys)
        losses.append(float(m["loss"]))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(tuple(KERNEL_META))
        if on_card:
            require(counts == per_step, f"{label}: launches of one step {counts} != {per_step}")
        for name in KERNEL_META:
            totals[name] += counts[name]
    log(f"{label} 3 steps of the config's routing: losses {[round(v, 4) for v in losses]}, host "
        f"ms {[round(v, 1) for v in host_ms]} on {smi}; launches a step "
        f"{ {k: v for k, v in per_step.items() if v} }")
    require(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss {losses}")
    return totals


def moe_serving(torch, smi: str, cfg, device: str) -> dict:
    """16d: 16b's checkpoint served with the fused tick tail by the dense
    engine (B2 prefill, B1, B9), the paged engine at act and int8 KV (B7,
    B9) and the speculative engine (a two-layer truncated draft, K 4, B10):
    8 greedy requests of at most 64 prompt tokens (no prefill there drops a
    token, so every engine must give the same tokens; longer prompts drop by
    design) and 4 seeded-sampled ones (the same tokens from the dense and
    paged engines), exact launches, tok/s and TTFT; int8 KV's agreement is
    reported.  Then ``generate --temperature 0`` in a subprocess gives the
    dense engine's tokens, and ``serve --weight-dtype int8`` exits 2."""
    import dataclasses
    import pickle

    import numpy as np

    from bpe_transformer_tpu_torch.checkpointing import load_checkpoint
    from bpe_transformer_tpu_torch.models.transformer import params_from_jax
    from bpe_transformer_tpu_torch.serving.server import Request, ServingEngine
    from bpe_transformer_tpu_torch.serving.spec import DraftSpec

    on_card = device == "cuda"
    L, K, new = cfg.num_layers, 4, 32
    ckpt = MOE_WORK / "ck" / "latest.ckpt"
    params = params_from_jax(load_checkpoint(ckpt)["params"], device)
    prompt_text = "Once upon a time"
    rng = np.random.default_rng(18)
    prompts = [[ord(c) for c in prompt_text]] + [
        [int(t) for t in rng.integers(0, cfg.vocab_size, size=m)]
        for m in (5, 9, 20, 33, 47, 60, 64)]
    # Each prompt greedy, and the last four also seeded-sampled: the dense
    # and paged engines draw the same noise a slot.
    requests = [Request(prompt_ids=tuple(p), max_new_tokens=new, temperature=0.0)
                for p in prompts] + [
        Request(prompt_ids=tuple(p), max_new_tokens=new, temperature=0.8, top_k=50, seed=i)
        for i, p in enumerate(prompts[4:])]
    greedy = len(prompts)
    engines = {
        "dense": (dict(attention_impl="flash", decode_attention_impl="pallas"), {}),
        "paged act": (dict(attention_impl="flash", decode_attention_impl="paged"),
                      dict(paged=True, block_size=16, prefill_chunk=64)),
        "paged int8 KV": (dict(attention_impl="flash", decode_attention_impl="paged"),
                          dict(paged=True, block_size=16, prefill_chunk=64, kv_dtype="int8")),
        "spec": (dict(attention_impl="flash", decode_attention_impl="paged"),
                 dict(paged=True, block_size=16, prefill_chunk=64, speculate_k=K,
                      draft_spec=DraftSpec(truncate_layers=2))),
    }
    tokens, out, totals = {}, {}, dict.fromkeys(KERNEL_META, 0)
    for name, (knobs, kw) in engines.items():
        c = dataclasses.replace(cfg, **knobs)
        with ServingEngine(params, c, slots=8, fused_sampling=True, device=device,
                           **kw) as serving:
            serving.generate(list(range(1, 20)), max_new_tokens=4, temperature=0.0)  # warm-up
            engine = serving.engine
            ticks0 = engine.ticks
            if on_card:
                torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = [h.result(timeout=600) for h in [serving.submit(r) for r in requests]]
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(tuple(KERNEL_META))
            ticks = engine.ticks - ticks0
        tokens[name] = [list(r.token_ids) for r in results]
        n_tok = sum(len(t) for t in tokens[name])
        ttft = sorted(r.queue_wait_s + r.prefill_s for r in results)
        if name == "dense":
            want = only(flash_attention=L * len(requests), decode_attention=L * ticks,
                        fused_head_sample=ticks)
        elif name == "spec":
            want = only(fused_verify_head=ticks)
        else:
            want = only(paged_decode_attention=L * ticks, fused_head_sample=ticks)
        log(f"16d {name}: {len(results)} requests, {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} tok/s, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max "
            f"{ttft[-1] * 1e3:.1f} ms, {ticks} ticks on {smi}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if on_card:
            require(counts == want, f"16d {name}: launches {counts} != {want}")
        require(all(len(t) == new for t in tokens[name]), f"16d {name}: short generations")
        out[name] = {"tok_s": n_tok / wall, "ttft_s": ttft, "ticks": ticks, "launches": counts}
        for k2 in KERNEL_META:
            totals[k2] += counts[k2]
    require(tokens["paged act"] == tokens["dense"],
            "16d: the paged engine's tokens differ from the dense engine's")
    require(tokens["spec"][:greedy] == tokens["dense"][:greedy],
            "16d: the speculative engine's greedy tokens differ from the dense engine's")
    agree = sum(a == b for p, q in zip(tokens["paged int8 KV"], tokens["dense"])
                for a, b in zip(p, q)) / sum(len(p) for p in tokens["dense"])
    distinct = len({t for p in tokens["dense"] for t in p})
    log(f"16d greedy tokens equal across dense, paged act and spec, seeded-sampled ones "
        f"across dense and paged act ({distinct} distinct tokens); int8 KV agrees on "
        f"{agree:.4f} of the tokens; on {smi}")
    out["int8_kv_agreement"] = agree

    # The CLIs on the checkpoint: a byte tokenizer padded to the model's
    # vocabulary (ids past 255 decode to a marker of their own).
    tok = MOE_WORK / "tok"
    tok.mkdir(exist_ok=True)
    vocab = {i: bytes([i]) for i in range(256)}
    vocab.update({i: f"<{i}>".encode() for i in range(256, cfg.vocab_size)})
    (tok / "vocab.pkl").write_bytes(pickle.dumps(vocab))
    (tok / "merges.pkl").write_bytes(pickle.dumps([]))
    text = port_cli("generate", "--checkpoint", str(ckpt), "--tokenizer-dir", str(tok),
                    "--prompt", prompt_text, "--max-new-tokens", str(new), "--temperature", "0",
                    "--decode-attention", "pallas", "--print-ids", "--device", device)
    ids = json.loads(text.strip().splitlines()[-1])["token_ids"]
    log(f"16d generate --temperature 0: {ids[:8]}... equal to the dense engine's "
        f"{ids == tokens['dense'][0]}")
    require(ids == tokens["dense"][0], f"16d: generate gave {ids}, the dense engine "
            f"{tokens['dense'][0]}")
    proc = subprocess.run([sys.executable, *PORT_CLI, "serve", "--checkpoint", str(ckpt),
                           "--tokenizer-dir", str(tok), "--weight-dtype", "int8", "--device",
                           device], cwd=ROOT, capture_output=True, text=True, timeout=300)
    require(proc.returncode == 2 and "MoE" in proc.stdout + proc.stderr,
            f"16d: serve --weight-dtype int8 on MoE exited {proc.returncode}")
    out["totals"] = totals
    return out


def phase_moe(torch, smi: str, cfg=None, device: str = "cuda", batch: int = 16) -> dict:
    """Phase 16: the MoE family at TINYSTORIES_MOE width (12 layers, d 512,
    8 experts, top-2, capacity factor 1.25, gather); returns the launches
    of (b), (c) and (d) summed, and writes ``chip_smoke_moe.json``.  (b)
    runs RoPE inside the flash kernel (``flash_fused`` from sequence 0), as
    phases 8 and 15 do, so a step launches exactly ``TRAINING_KERNELS``."""
    import dataclasses
    import shutil

    import numpy as np

    from bpe_transformer_tpu_torch.models import TINYSTORIES_MOE

    cfg = cfg or dataclasses.replace(TINYSTORIES_MOE, attention_impl="flash_fused",
                                     flash_fused_min_seq=0)
    shutil.rmtree(MOE_WORK, ignore_errors=True)
    MOE_WORK.mkdir(parents=True)
    zipf = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
    data = np.random.default_rng(16).choice(cfg.vocab_size, size=1_000_000,
                                            p=zipf / zipf.sum()).astype(np.uint16)
    out: dict = {"smi": smi}
    t0 = time.perf_counter()
    out["a"] = moe_ffn_alone(torch, smi, cfg, batch, device)
    log(f"16a done ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["b"] = moe_training(torch, smi, cfg, batch, device, data)
    log(f"16b done ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ring_counts = moe_ring(torch, smi, dataclasses.replace(cfg, attention_impl="flash"),
                           batch // 2, device)
    log(f"16c done ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["d"] = moe_serving(torch, smi, cfg, device)
    log(f"16d done ({time.perf_counter() - t0:.1f} s)")
    totals = {name: out["b"]["launches"][name] + ring_counts[name] + out["d"]["totals"][name]
              for name in KERNEL_META}
    if device == "cuda":
        for name in ("swiglu", "quant_matmul", "gelu", "gelu_bwd"):
            require(totals[name] == 0, f"16: {name} launched {totals[name]} times on the MoE path")
    out["launches"] = totals
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_moe.json").write_text(json.dumps(out, indent=1, default=str))
    shutil.rmtree(MOE_WORK, ignore_errors=True)
    return totals


# ------------------------------------------------------------ phase 17

#: Phase 17's working files (corpus, token file, checkpoints, streams),
#: inside the checkout and removed at the end of the phase.
SURFACE_WORK = ROOT / ".scratch" / "chip_smoke_surface"
#: The keys of a ``kind="attribution"`` record, as the JAX package's probe
#: writes them (``programs`` on the first record only).
ATTRIBUTION_KEYS = {
    "kind", "t", "step", "wall_step_s", "device_step_s", "compute_frac", "collective_frac",
    "host_gap_frac", "probe_iters", "train_peak_hbm_bytes", "train_temp_hbm_bytes",
    "remat_policy", "grads_dtype", "scan_layers",
} | {"probe_wall_step_s", "device_time_from"}
#: CUDA against CPU for the adapters, float32 (TF32 off): the largest
#: absolute difference over the largest magnitude of the CPU result.
ADAPTER_REL_TOL = 1e-4


def native_tokenizer(smi: str, work: Path) -> dict:
    """17a: the native engine against the Python path on phase 13's corpus:
    the same vocabulary and merges, the same ids, and each path's seconds."""
    from bpe_transformer_tpu_torch import native
    from bpe_transformer_tpu_torch.tokenization import BPETokenizer, BPETrainer

    require(native.is_available(), f"17a: native engine unavailable: "
                                   f"{native.unavailable_reason()}")
    corpus = SERVE_SPECIAL.join(p.read_text(encoding="utf-8") for p in sorted(ROOT.glob("*.md")))
    path = work / "corpus.txt"
    path.write_text(corpus, encoding="utf-8")
    out: dict = {"chars": len(corpus)}
    trained = {}
    for engine in ("native", "python"):
        trainer = BPETrainer(vocab_size=SERVE_VOCAB, special_tokens=[SERVE_SPECIAL])
        t0 = time.perf_counter()
        if engine == "native":
            # The native path itself, required to run: a silent fallback
            # would compare Python against Python.
            require(trainer._train_native_file(path) is True,
                    "17a: the native trainer did not run")
        else:
            os.environ["BT_NATIVE"] = "0"
            try:
                trainer.train(path)
            finally:
                os.environ.pop("BT_NATIVE", None)
        out[f"train_{engine}_s"] = time.perf_counter() - t0
        trained[engine] = trainer
    require(trained["native"].vocab == trained["python"].vocab
            and trained["native"].merges == trained["python"].merges,
            "17a: native and Python training differ")
    vocab, merges = trained["native"].vocab, trained["native"].merges
    tok = BPETokenizer(dict(vocab), merges, [SERVE_SPECIAL])
    t0 = time.perf_counter()
    ids = tok.encode(corpus)
    out["encode_native_s"] = time.perf_counter() - t0
    require(tok._native is not None, "17a: the tokenizer did not take the native encoder")
    python_tok = BPETokenizer(dict(vocab), merges, [SERVE_SPECIAL])
    python_tok._native_tried = True  # the pure-Python path
    t0 = time.perf_counter()
    python_ids = python_tok.encode(corpus)
    out["encode_python_s"] = time.perf_counter() - t0
    require(ids == python_ids, "17a: native and Python encodes differ")
    require(tok.decode(ids) == corpus, "17a: decode not exact")
    out["tokens"] = len(ids)
    log(f"17a native tokenizer: {len(corpus)} chars, vocabulary {len(vocab)}, {len(ids)} tokens "
        f"identical; train native {out['train_native_s']:.2f} s / python "
        f"{out['train_python_s']:.2f} s, encode native {out['encode_native_s']:.3f} s / python "
        f"{out['encode_python_s']:.3f} s; 13a (train-tokenizer, native when it builds) "
        f"{TIMINGS.get('13a train-tokenizer s', float('nan')):.2f} s, 13a in all "
        f"{TIMINGS.get('13a tokenizer s', float('nan')):.2f} s on {smi}")
    return out


def adapters_card_vs_cpu(torch, smi: str, work: Path, device: str) -> dict:
    """17b: every adapter on CUDA tensors against the same call on CPU
    tensors made from one seed (``ADAPTER_REL_TOL``), ``run_transformer_lm``
    and ``run_transformer_block`` at GPT2_SMALL_32K widths, three steps of
    ``get_adamw_cls()``, the checkpoint adapters across devices."""
    import numpy as np

    from bpe_transformer_tpu_torch import compat
    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K

    t_all = time.perf_counter()
    cfg = GPT2_SMALL_32K
    d, ff, heads, vocab, layers = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.vocab_size, \
        cfg.num_layers
    g = torch.Generator().manual_seed(17)
    rand = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    errors: dict = {}

    def to_dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        if isinstance(a, dict):
            return {k: to_dev(v) for k, v in a.items()}
        return a

    def held(name, cpu_out, dev_out):
        require(dev_out.device.type == torch.device(device).type,
                f"17b {name}: result on {dev_out.device}")
        ref = cpu_out.float()
        err = float((dev_out.float().cpu() - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-30)
        errors[name] = err / scale
        require(err <= ADAPTER_REL_TOL * scale,
                f"17b {name}: max err {err:.3e} over {scale:.3e} > {ADAPTER_REL_TOL}")

    def both(name, *args):
        fn = getattr(compat, name)
        held(name, fn(*args), fn(*(to_dev(a) for a in args)))

    S = 32
    x = rand(2, S, d)
    positions = torch.arange(S).repeat(2, 1)
    both("run_linear", d, ff, rand(ff, d) * 0.05, x)
    both("run_embedding", vocab, d, rand(vocab, d), torch.randint(0, vocab, (2, S), generator=g))
    both("run_swiglu", d, ff, rand(ff, d) * 0.05, rand(d, ff) * 0.05, rand(ff, d) * 0.05, x)
    q, k, v = rand(2, heads, S, d // heads), rand(2, heads, S, d // heads), \
        rand(2, heads, S, d // heads)
    both("run_scaled_dot_product_attention", q, k, v, rand(2, heads, S, S) > 0.5)
    projs = [rand(d, d) * 0.05 for _ in range(4)]
    both("run_multihead_self_attention", d, heads, *projs, x)
    both("run_multihead_self_attention_with_rope", d, heads, cfg.context_length,
         cfg.rope_theta, *projs, x, positions)
    both("run_rope", d // heads, cfg.rope_theta, cfg.context_length, q, positions[:, None, :])
    both("run_rmsnorm", d, 1e-5, 1 + 0.1 * rand(d), x)
    both("run_silu", x)
    both("run_softmax", x * 10, -1)
    both("run_cross_entropy", rand(64, vocab) * 5, torch.randint(0, vocab, (64,), generator=g))
    sd = {"token_embeddings.weight": rand(vocab, d) * 0.02, "ln_final.weight": 1 + 0.1 * rand(d),
          "lm_head.weight": rand(vocab, d) * 0.02}
    for i in range(layers):
        p = f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "output_proj"):
            sd[p + f"attn.{name}.weight"] = rand(d, d) * 0.02
        sd[p + "ln1.weight"] = 1 + 0.1 * rand(d)
        sd[p + "ln2.weight"] = 1 + 0.1 * rand(d)
        sd[p + "ffn.w1.weight"] = rand(ff, d) * 0.02
        sd[p + "ffn.w2.weight"] = rand(d, ff) * 0.02
        sd[p + "ffn.w3.weight"] = rand(ff, d) * 0.02
    block = {k[len("layers.0."):]: v for k, v in sd.items() if k.startswith("layers.0.")}
    both("run_transformer_block", d, heads, ff, cfg.context_length, cfg.rope_theta, block, x)
    both("run_transformer_lm", vocab, cfg.context_length, d, layers, heads, ff, cfg.rope_theta,
         sd, torch.randint(0, vocab, (2, S), generator=g))
    del sd, block

    # Gradient clipping in place, and three AdamW steps, on both devices.
    grads = [rand(64, 64) * 3 for _ in range(3)]
    clipped = []
    for dev in ("cpu", device):
        ps = [torch.nn.Parameter(t.to(dev)) for t in grads]
        for prm, t in zip(ps, grads):
            prm.grad = t.to(dev) * 2
        compat.run_gradient_clipping(ps, 1.0)
        clipped.append([prm.grad for prm in ps])
    for i, (a, b) in enumerate(zip(*clipped)):
        held(f"run_gradient_clipping[{i}]", a, b)

    def adamw_net(dev):
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(d, ff), torch.nn.ReLU(),
                                  torch.nn.Linear(ff, d)).to(dev)
        return net, compat.get_adamw_cls()(net.parameters(), lr=1e-3, weight_decay=0.01,
                                           betas=(0.9, 0.999), eps=1e-8)

    # The same gradients reach both optimizers (the CPU net's, copied to the
    # card): AdamW divides by sqrt(v) + eps, so gradients near eps would
    # carry the two backwards' last-place differences into whole updates.
    (cpu_net, cpu_opt), (dev_net, dev_opt) = adamw_net("cpu"), adamw_net(device)
    data = torch.Generator().manual_seed(1)
    for _ in range(3):
        cpu_opt.zero_grad()
        xb = torch.randn(16, d, generator=data)
        ((cpu_net(xb) - xb) ** 2).mean().backward()
        for cp, dp in zip(cpu_net.parameters(), dev_net.parameters()):
            dp.grad = cp.grad.to(device)
        cpu_opt.step()
        dev_opt.step()
    for key, value in cpu_net.state_dict().items():
        held(f"get_adamw_cls {key}", value, dev_net.state_dict()[key])
    for i, st in dev_opt.state_dict()["state"].items():
        require(set(st) == {"step", "exp_avg", "exp_avg_sq"} and int(st["step"]) == 3
                and st["step"].dtype == torch.int32 and st["step"].device.type == "cpu"
                and st["exp_avg"].dtype == torch.float32
                and st["exp_avg"].device.type == torch.device(device).type,
                f"17b AdamW state {i}: {[(k, v.dtype, v.device) for k, v in st.items()]}")
        held(f"get_adamw_cls exp_avg_sq[{i}]", cpu_opt.state_dict()["state"][i]["exp_avg_sq"],
             st["exp_avg_sq"])

    # The checkpoint adapters: written from the card, read into a CPU net.
    ckpt = work / "adapters.ckpt"
    compat.run_save_checkpoint(dev_net, dev_opt, 3, ckpt)
    fresh = torch.nn.Sequential(torch.nn.Linear(d, ff), torch.nn.ReLU(), torch.nn.Linear(ff, d))
    fresh_opt = compat.get_adamw_cls()(fresh.parameters(), lr=1e-3)
    require(compat.run_load_checkpoint(ckpt, fresh, fresh_opt) == 3, "17b: iteration")
    for key, value in dev_net.state_dict().items():
        require(torch.equal(value.cpu(), fresh.state_dict()[key]), f"17b checkpoint {key}")

    dataset = np.arange(10_000)
    bx, by = compat.run_get_batch(dataset, 8, 64, device)
    require(bx.device.type == by.device.type == torch.device(device).type
            and bx.dtype == torch.int64 and torch.equal(bx + 1, by),
            f"17b run_get_batch: {bx.device} {bx.dtype}")
    tok = compat.get_tokenizer(*compat.run_train_bpe(work / "corpus.txt", 300, [SERVE_SPECIAL]),
                               [SERVE_SPECIAL])
    require(tok.decode(tok.encode("the quick fox")) == "the quick fox", "17b tokenizer")
    worst = max(errors, key=errors.get)
    log(f"17b adapters on {device} vs cpu: {len(errors)} comparisons within {ADAPTER_REL_TOL} "
        f"relative, worst {worst} {errors[worst]:.2e}; AdamW state on the parameters' device, "
        f"step on the host; run_get_batch on {bx.device} "
        f"({time.perf_counter() - t_all:.1f} s) on {smi}")
    return {"rel_err": errors}


def _step_marks():
    """A fault injector with no plan whose ``at_step`` hook, called by the
    loop as each step begins, raises a :data:`STEP_MARK` warning: the
    marks split :func:`count_syncs`'s list by step."""
    import warnings

    from bpe_transformer_tpu_torch.resilience.faults import FaultInjector

    class _StepMarks(FaultInjector):
        def at_step(self, step: int) -> None:
            warnings.warn(f"{STEP_MARK}{step}")
            super().at_step(step)

    return _StepMarks(None)


def syncs_by_update(sites: list) -> dict:
    """:func:`count_syncs`'s list of a loop run split by update: update
    ``u`` (1-based) holds the syncs from the start of step ``u - 1`` to the
    start of the next (its log boundary's fetch and probe included; the
    last update also holds the run's end), 0 the set-up before the first."""
    out, update = {0: []}, 0
    for site in sites:
        if site.startswith(STEP_MARK):
            update = int(site[len(STEP_MARK):]) + 1
            out.setdefault(update, [])
        else:
            out[update].append(site)
    return out


def attribution_on_card(torch, smi: str, work: Path, cfg, batch: int, device: str) -> dict:
    """17c: ``train`` with ``attribution_every`` at phase 15's config: the
    records' keys and split (the card's busy time below the loop's and the
    probe's wall times), the probe's launches against one loop step's, the
    live state bit-equal with and without the probe, no sync in an update
    off a log boundary (counted per update); then ``profile --measure 5
    --serve`` and ``report`` as a user runs them."""
    import filecmp

    import numpy as np

    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.telemetry import attribution
    from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

    on_card = device == "cuda"
    L = cfg.num_layers
    zipf = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
    data = np.random.default_rng(17).choice(cfg.vocab_size, size=500_000,
                                            p=zipf / zipf.sum()).astype(np.uint16)
    hp = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=2,
                      cosine_cycle_iters=8)
    steps, every, log_every = 8, 4, 2
    fences = []
    plain_fence = attribution._fence

    def counted_fence(dev):
        fences.append(dev)
        plain_fence(dev)

    attribution._fence = counted_fence
    runs = {}
    try:
        for on in (False, True):
            tag = "attr" if on else "plain"
            loop = LoopConfig(steps=steps, batch_size=batch, log_every=log_every, eval_every=1000,
                              checkpoint_every=steps, checkpoint_dir=str(work / f"ck_{tag}"),
                              metrics_jsonl=str(work / f"{tag}.jsonl"),
                              attribution_every=every if on else 0, seed=0)
            run = lambda: train(cfg, hp, loop, data, log_fn=lambda *a: None,  # noqa: E731
                                device=device,
                                fault_injector=_step_marks() if on_card else None)
            fences.clear()
            t0 = time.perf_counter()
            if on_card:
                sites = syncs_by_update(count_syncs(torch, run, 1))
            else:
                run()
                sites = {}
            runs[tag] = {"sites": sites, "fences": len(fences),
                         "wall_s": time.perf_counter() - t0}
    finally:
        attribution._fence = plain_fence
    boundaries = steps // every
    require(filecmp.cmp(work / "ck_plain" / "step_00000008.ckpt",
                        work / "ck_attr" / "step_00000008.ckpt", shallow=False),
            "17c: the live state differs with the probe on")
    records = read_jsonl(work / "attr.jsonl")
    attrs = [r for r in records if r.get("kind") == "attribution"]
    require([r["step"] for r in attrs] == [4, 8], f"17c: attribution steps {attrs}")
    require(set(attrs[0]) == ATTRIBUTION_KEYS | {"programs"}
            and all(set(r) == ATTRIBUTION_KEYS for r in attrs[1:]),
            f"17c: record keys {[sorted(r) for r in attrs]}")
    step_wall = {r["step"]: r["step_wall_s"] for r in step_records(records)}
    for r in attrs:
        require(abs(r["compute_frac"] + r["host_gap_frac"] - 1.0) <= 1e-3
                and r["collective_frac"] == 0.0, f"17c: fractions {r}")
        # The split is the loop's own step time against the card's busy
        # time, which on this host-bound step is the shorter of the two.
        require(abs(r["wall_step_s"] - step_wall[r["step"]]) <= 1e-6
                and abs(r["compute_frac"] - r["device_step_s"]
                        / max(r["wall_step_s"], r["device_step_s"])) <= 1e-3,
                f"17c: the split is not the loop's step time against the device time: {r}")
        if on_card:
            require(r["device_time_from"] == "kernels"
                    and r["device_step_s"] < r["probe_wall_step_s"]
                    and r["device_step_s"] < r["wall_step_s"] and r["host_gap_frac"] > 0,
                    f"17c: the device time is not the card's busy time: {r}")
    require(runs["attr"]["fences"] == boundaries * attribution.StepProbe.FETCHES_PER_MEASURE,
            f"17c: {runs['attr']['fences']} probe fences for {boundaries} boundaries")
    # Per update: none off a log boundary, and at a boundary nothing more
    # than the plain run's outside the probe (the plain run goes first and
    # pays the process's one-time syncs).
    from collections import Counter

    extra = {}
    if on_card:
        for u in range(1, steps + 1):
            attr_u, plain_u = runs["attr"]["sites"].get(u), runs["plain"]["sites"].get(u)
            require(attr_u is not None and plain_u is not None, f"17c: no mark for update {u}")
            if u % log_every and u != steps:
                require(not attr_u and not plain_u,
                        f"17c: update {u}, off a log boundary, syncs at {attr_u} "
                        f"(plain run {plain_u})")
            more = Counter(attr_u) - Counter(plain_u)
            require(all(site.startswith("attribution.py:") for site in more),
                    f"17c: update {u} syncs off the probe: {dict(more)} (plain run "
                    f"{dict(Counter(plain_u))})")
            if more:
                extra[u] = dict(more)
    probe_s = span_seconds(records, "attribution_probe")
    if on_card:
        require(attrs[0]["programs"][0]["bound"] in ("compute-bound", "memory-bound"),
                f"17c: roofline verdict {attrs[0]['programs'][0]}")
        require(attrs[0]["train_peak_hbm_bytes"], "17c: no peak memory read")
        # The probe reads its own peak without shortening the run's.
        peaks = [r["hbm_peak_bytes_in_use"] for r in records if r.get("kind") == "resources"]
        require(len(peaks) >= 2 and all(b >= a for a, b in zip(peaks, peaks[1:])),
                f"17c: the run's peak device memory fell: {peaks}")

    # The probe's launches are one loop step's, and it never writes the
    # live tensors.
    params = init_params(cfg, torch.Generator(device=device).manual_seed(3), device=device)
    opt = adamw_init(params)
    step = make_train_step(cfg, hp)
    x = torch.from_numpy(data[: batch * cfg.context_length].astype(np.int64)
                         .reshape(batch, -1)).to(device)
    reset_counts()
    step(params, opt, x, x)
    one_step = read_counts(tuple(KERNEL_META))
    snapshot = [t.clone() for t in (params["lm_head"], params["layers"][0]["attn"]["q_proj"],
                                    opt.m["lm_head"], opt.v["token_embeddings"])]
    probe = attribution.StepProbe(cfg, hp, batch_size=batch, iters=3, device=device)
    calls = probe.calls_per_measure
    reset_counts()
    measured = probe.measure(params, opt)
    probe_counts = read_counts(tuple(KERNEL_META))
    if on_card:
        want = {k: v * calls for k, v in one_step.items()}
        require(probe_counts == want and one_step["flash_attention_rope"] == L,
                f"17c: probe launches {probe_counts} != {calls} x {one_step}")
    after = (params["lm_head"], params["layers"][0]["attn"]["q_proj"], opt.m["lm_head"],
             opt.v["token_embeddings"])
    require(all(torch.equal(a, b) for a, b in zip(snapshot, after)),
            "17c: the probe wrote the live state")
    del params, opt, snapshot, after, probe

    # profile and report, as a user runs them.
    cfg.to_json(work / "model.json")
    t0 = time.perf_counter()
    text = port_cli("profile", "--model-config", str(work / "model.json"), "--batch", str(batch),
                    "--measure", "5", "--serve", "--json", "--metrics-jsonl",
                    str(work / "profile.jsonl"), "--device", device)
    profile_s = time.perf_counter() - t0
    summary = json.loads(text.strip().splitlines()[-1])
    verdicts = {r["name"]: r["bound"] for r in summary["programs"]}
    if on_card:
        require(all(v in ("compute-bound", "memory-bound") for v in verdicts.values()),
                f"17c: profile verdicts {verdicts}")
    report = port_cli("report", str(work / "profile.jsonl"))
    require("== attribution (1 records" in report, f"17c: report {report[:2000]}")
    log(f"17c attribution every {every} of {steps} steps (B={batch} S={cfg.context_length}): "
        f"records {[(r['step'], r['compute_frac'], r['host_gap_frac']) for r in attrs]}, "
        f"device step ({attrs[0]['device_time_from']}) "
        f"{[round(r['device_step_s'] * 1e3, 2) for r in attrs]} ms, "
        f"probe fenced wall {[round(r['probe_wall_step_s'] * 1e3, 2) for r in attrs]} ms, loop "
        f"step wall {[round(r['wall_step_s'] * 1e3, 2) for r in attrs]} ms, probe span "
        f"{[round(s, 3) for s in probe_s]} s a boundary, peak "
        f"{attrs[0]['train_peak_hbm_bytes']} B (the run's by boundary "
        f"{[r['hbm_peak_bytes_in_use'] for r in records if r.get('kind') == 'resources']}); "
        f"run wall {runs['plain']['wall_s']:.2f} s "
        f"plain / {runs['attr']['wall_s']:.2f} s with the probe; live state bit-equal; syncs "
        f"by update plain { {u: len(v) for u, v in runs['plain']['sites'].items()} }, with the "
        f"probe { {u: len(v) for u, v in runs['attr']['sites'].items()} } (extra by update "
        f"{extra}), {runs['attr']['fences']} probe fences; probe launches "
        f"{ {k: v for k, v in probe_counts.items() if v} } = {calls} x one step's; measure "
        f"{measured['device_step_s'] * 1e3:.2f} ms/step device ({measured['device_time_from']}), "
        f"{measured['probe_wall_step_s'] * 1e3:.2f} ms/step fenced wall on {smi}")
    log(f"17c profile --measure 5 --serve ({profile_s:.1f} s): verdicts {verdicts}; wall "
        f"{summary['wall_step_s'] * 1e3:.2f} ms, device {summary['device_step_s'] * 1e3:.2f} ms, "
        f"compute {summary['compute_frac']}, host gap {summary['host_gap_frac']}; report "
        f"renders == attribution ==")
    return {"records": attrs, "probe_span_s": probe_s, "runs": runs, "profile": summary,
            "profile_s": profile_s, "probe_launches": probe_counts}


def warmup_warm(smi: str, work: Path, cfg, device: str) -> dict:
    """17d: ``warmup`` against the build root this run already used, for
    phase 13b's, 13c's and phase 15's flags: nothing built, every source the
    flags need found, and those sources are the ones holding the kernels
    that those phases launched."""
    import dataclasses

    from bpe_transformer_tpu_torch.kernels import _build

    root = str(_build.BUILD_ROOT)
    serve_cfg = dataclasses.replace(cfg, **KERNEL_KNOBS, remat_policy="none")
    serve_cfg.to_json(work / "serve.json")
    cfg.to_json(work / "train.json")
    stem = lambda name: Path(KERNEL_META[name]["source"]).stem  # noqa: E731
    cases = {
        "13b dense": (["--model-config", str(work / "serve.json")],
                      {stem(k) for k in SERVING_KERNELS}),
        "13c paged int8": (["--model-config", str(work / "serve.json"), "--paged",
                            "--kv-dtype", "int8", "--weight-dtype", "int8", "--fused-sampling",
                            "--decode-attention", "paged"],
                           {stem(k) for k in ("paged_decode_attention", "quant_matmul",
                                              "fused_head_sample")}),
        "15 train": (["--model-config", str(work / "train.json"), "--train"],
                     {stem(k) for k in TRAIN_KERNELS_15}),
    }
    from concurrent.futures import ThreadPoolExecutor

    def warm(flags):
        t0 = time.perf_counter()
        got = json.loads(port_cli("warmup", "--compile-cache", root, *flags,
                                  "--device", device).strip().splitlines()[-1])
        got["wall_s"] = time.perf_counter() - t0
        return got

    # Independent processes that build nothing: started together.
    with ThreadPoolExecutor(len(cases)) as pool:
        results = dict(zip(cases, pool.map(warm, [flags for flags, _ in cases.values()])))
    out = {}
    for label, (flags, want) in cases.items():
        got = out[label] = results[label]
        if device == "cuda":
            require(got["programs_compiled"] == 0 and got["cache_hits"] == len(want)
                    and set(got["sources"]) == want,
                    f"17d {label}: {got} (want the sources {sorted(want)} found built)")
        log(f"17d warmup {label}: programs_compiled {got['programs_compiled']}, cache_hits "
            f"{got['cache_hits']} of {got['sources']} ({got['wall_s']:.1f} s, the three "
            f"commands at once)")
    return out


def phase_surface(torch, smi: str, cfg=None, device: str = "cuda", batch: int = 8) -> dict:
    """Phase 17: the rest of the one-card surface at full width: (a) the
    native tokenizer engine against the Python path, (b) the reference
    adapters on the card against the CPU, (c) attribution in ``train``,
    ``profile`` and ``report``, (d) ``warmup`` on the warm build root.
    Writes ``chip_smoke_surface.json``."""
    import dataclasses
    import shutil

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K

    cfg = cfg or dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash_fused", flash_fused_min_seq=0,
                             ffn_impl="pallas", remat_policy="save_attn")
    shutil.rmtree(SURFACE_WORK, ignore_errors=True)
    SURFACE_WORK.mkdir(parents=True)
    out = {"smi": smi}
    t0 = time.perf_counter()
    for part, run in (("a", lambda: native_tokenizer(smi, SURFACE_WORK)),
                      ("b", lambda: adapters_card_vs_cpu(torch, smi, SURFACE_WORK, device)),
                      ("c", lambda: attribution_on_card(torch, smi, SURFACE_WORK, cfg, batch,
                                                        device)),
                      ("d", lambda: warmup_warm(smi, SURFACE_WORK, cfg, device))):
        reset_counts()
        t_part = time.perf_counter()
        out[part] = run()
        out[f"{part}_s"] = time.perf_counter() - t_part
    out["wall_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_surface.json").write_text(json.dumps(out, indent=1, default=str))
    return out


# ------------------------------------------------------------ main


# ------------------------------------------------------------ phase 18

#: Phase 18's working files (token file, config, checkpoints, streams),
#: inside the checkout and removed at the end of the phase.
PARALLEL_WORK = ROOT / ".scratch" / "chip_smoke_parallel"
#: 18 at world 4, dp=4 against phase 8's one-card step on the same batch.
#: Each rank's forward and backward run on 2 of the 8 rows in bf16, so
#: cuBLAS sums each weight gradient over 2048 tokens instead of 8192 and
#: NCCL then adds the 4 ranks' float32 means: the gradients agree to bf16
#: rounding, not bitwise.  Step 1's loss and mean gradients (the rank's
#: own, through the step's reduction) are held at phase 12's bf16
#: tolerance (TRAIN_TOL), the losses of 3 steps to 2e-3 relative.  AdamW
#: divides each gradient by its own running magnitude, so a gradient near
#: zero that changes sign moves its weight the other way: for the first
#: three steps |m_hat / sqrt(v_hat)| <= 1.004 (Cauchy-Schwarz on the
#: moments' weights), so two runs' weights can drift apart by at most 2.01
#: x the sum of the learning rates of the steps (the weight decay terms
#: agree), and that bound is held; the measured drift is printed.
DP_TOL = {"loss_rel": 2e-3, "adam_flip": 2.01}
#: ZeRO-1 at dp=4 against dp=4 with the dense optimizer: the same rows on
#: the same ranks, so the same local gradients; a reduce-scatter instead of
#: an all-reduce, the clip norm summed in another order, the update
#: computed on a flat row.  Step 1's grad norm (the mean gradients of the
#: same weights) agrees to float32 rounding, the losses of 3 steps to 1e-5
#: relative, the weights to DP_TOL's AdamW bound.
ZERO1_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-5}
#: 18 at world 1 (the default run): phase 15's tolerance (relative, on the
#: logged losses) between train() over a world-1 NCCL group and train() on
#: one device.
LOOP_REL_TOL = 1e-5


def zipf_tokens(vocab: int, n: int, seed: int):
    """Phase 15's seeded Zipf-distributed uint16 token stream."""
    import numpy as np

    zipf = 1.0 / np.arange(1, vocab + 1) ** 1.1
    return np.random.default_rng(seed).choice(vocab, size=n, p=zipf / zipf.sum()).astype(
        np.uint16)


def max_rel(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want, strict=True))


def phase_parallel(torch, smi: str, cfg=None, device: str = "cuda",
                   batch: int = 8, p20_cfgs=None) -> tuple[dict, dict, dict]:
    """Phase 18 (the default run): a real process group of world 1 (NCCL
    on ``cuda:0``, gloo with ``device="cpu"``) driving ``train()`` at phase
    15's config, seed and batch: ZeRO-1 dp (``mesh data=1``) for 4 steps
    with a checkpoint, resumed dense to 8, and ring-flash sp (``mesh
    data=1,seq=1``) for 4 steps, each against ``train()`` on one device
    (phase 15's run; ``attention_impl="flash"`` for sp, whose ring runs
    the flash kernels) within phase 15's 1e-5 relative; then phases 19
    (:func:`phase_sharded`) and 20 (:func:`phase_pipeline`, ``p20_cfgs``
    its configurations) on the same group.  Returns the launch counts of
    18's dp and sp runs, of 19's runs and of 20's (the slices' main
    paths)."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.parallel import initialize_distributed
    from bpe_transformer_tpu_torch.parallel.launch import free_port
    from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    cfg = cfg or dataclasses.replace(
        GPT2_SMALL_32K, attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas",
        remat_policy="save_attn",
    )
    sp_cfg = dataclasses.replace(cfg, attention_impl="flash")
    L = cfg.num_layers
    shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
    PARALLEL_WORK.mkdir(parents=True)
    data = zipf_tokens(cfg.vocab_size, 2_000_000, 15)
    hp = dict(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=2,
              cosine_cycle_iters=8)
    quiet = lambda *a: None  # noqa: E731
    base = dict(batch_size=batch, log_every=2, eval_every=1000, seed=0)
    initialize_distributed(device, coordinator_address=f"127.0.0.1:{free_port()}",
                           num_processes=1, process_id=0)
    out: dict = {"smi": smi, "backend": dist.get_backend()}
    try:
        def run(c, steps, resume_from=None, data=data, **kw):
            loop = LoopConfig(**{**base, "steps": steps, **kw})
            return train(c, TrainHParams(**hp), loop, data, log_fn=quiet, device=device,
                         resume_from=resume_from)

        def losses(summary):
            return [r["loss"] for r in summary["history"]]

        ref = losses(run(cfg, 8))
        ref_sp = losses(run(sp_cfg, 4))
        ck = PARALLEL_WORK / "zero1_ck"
        reset_counts()
        dp = run(cfg, 4, parallel="dp", mesh_axes={"data": 1}, opt_sharding="zero1",
                 checkpoint_every=4, checkpoint_dir=str(ck))
        dp_counts = read_counts(tuple(KERNEL_META))
        reset_counts()
        sp = run(sp_cfg, 4, parallel="sp", mesh_axes={"data": 1, "seq": 1})
        sp_counts = read_counts(tuple(KERNEL_META))
        resumed = losses(run(cfg, 8, checkpoint_every=8, checkpoint_dir=str(ck),
                             resume_from=str(ck / "step_00000004.ckpt")))
        rel = {"dp zero1": max_rel(losses(dp), ref[:2]), "resumed dense": max_rel(resumed,
                                                                                  ref[2:]),
               "sp": max_rel(losses(sp), ref_sp)}
        log(f"18 world 1 ({out['backend']}): one device {[round(v, 5) for v in ref]}, dp zero1 "
            f"{[round(v, 5) for v in losses(dp)]}, resumed dense {[round(v, 5) for v in resumed]}"
            f"; one device (flash) {[round(v, 5) for v in ref_sp]}, sp "
            f"{[round(v, 5) for v in losses(sp)]}; max rel diffs {rel} (tol {LOOP_REL_TOL:g})")
        require(all(v <= LOOP_REL_TOL for v in rel.values()),
                f"18: world-1 runs disagree with one device: {rel}")
        dp_step = only(flash_attention_rope=L, flash_attention_bwd_dkdv=L,
                       flash_attention_bwd_dq=L, swiglu=2 * L)
        sp_step = sp_launches_per_step(L, 1, False)
        want_dp = {k: 4 * v for k, v in dp_step.items()}
        want_sp = {k: 4 * v for k, v in sp_step.items()}
        log(f"18 launches: dp zero1 { {k: v for k, v in dp_counts.items() if v} }, sp "
            f"{ {k: v for k, v in sp_counts.items() if v} }")
        if on_card:
            require(dp_counts == want_dp, f"18: dp launches {dp_counts} != {want_dp}")
            require(sp_counts == want_sp, f"18: sp launches {sp_counts} != {want_sp}")
        if on_card:
            # Syncs of a 6-step loop with one log boundary, one device against
            # the mesh paths (the stop flag rides the boundary's fetch).
            syncs = {name: len(count_syncs(torch, lambda kw=kw: run(c, 6, log_every=6, **kw), 1))
                     for name, c, kw in (
                         ("one device", cfg, {}),
                         ("dp zero1", cfg, dict(parallel="dp", mesh_axes={"data": 1},
                                                opt_sharding="zero1")),
                         ("sp", sp_cfg, dict(parallel="sp", mesh_axes={"data": 1, "seq": 1})))}
            log(f"18 syncs flagged by set_sync_debug_mode in a 6-step loop (set-up and one log "
                f"boundary included): {syncs}")
            out["syncs"] = syncs
        out.update(ref=ref, ref_sp=ref_sp, dp=losses(dp), sp=losses(sp), resumed=resumed,
                   rel=rel, dp_step_wall_s=[r["step_wall_s"] for r in dp["history"]],
                   sp_step_wall_s=[r["step_wall_s"] for r in sp["history"]],
                   phase_s=time.perf_counter() - t_phase)
        log(f"phase 18 data and sequence parallelism over a process group (world 1): ok "
            f"({time.perf_counter() - t_phase:.1f} s)")
        t_19 = time.perf_counter()
        counts19, out["sharded"] = phase_sharded(torch, run, losses, ref, cfg, on_card)
        log(f"phase 19 sharded parameters over the same group (world 1): ok "
            f"({time.perf_counter() - t_19:.1f} s)")
        t_20 = time.perf_counter()
        p20 = p20_cfgs or p20_configs()
        counts20, out["pipeline"] = phase_pipeline(
            torch, smi, run, losses, ref, p20, zipf_tokens(p20["moe"].vocab_size, 1_000_000, 16),
            on_card, batch)
        out["pipeline"]["phase_s"] = time.perf_counter() - t_20
        log(f"phase 20 Ulysses, the GPipe pipeline and expert parallelism (world 1): ok "
            f"({time.perf_counter() - t_20:.1f} s)")
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_parallel.json").write_text(json.dumps(out, indent=1))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
    return {name: dp_counts[name] + sp_counts[name] for name in KERNEL_META}, counts19, counts20


# ------------------------------------------------------------ phase 19

#: The GSPMD cases of 19 at world N (strategy, mesh, opt_sharding).
SHARDED_CASES = (
    ("fsdp", lambda n: {"data": n}, "zero1"),
    ("tp", lambda n: {"model": n}, None),
    ("fsdp_tp", lambda n: {"data": 2, "model": n // 2}, "zero1"),
    ("dp_tp", lambda n: {"data": 2, "model": n // 2}, "zero1"),
)


def tp_kernel_cases(torch) -> list[dict]:
    """19 (default run): B5, B4's pair and B3 at the shapes tensor
    parallelism hands them, against their plain versions (phase 5's
    tolerances): 3 heads a rank (tp=4) and 6 (tp=2) of GPT2_SMALL_32K's 12
    at (B, 1024, 64) bf16, and the SwiGLU forward at hidden 512 (tp=4, m
    8192) and 1024 (tp=2, m 4096)."""
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for label, shape in (("tp=4", (8, 3, 1024, 64)), ("tp=2 of fsdp_tp 2x2", (4, 6, 1024, 64))):
        errs = training_kernel_errors(torch, fa, *training_inputs(torch, shape, torch.bfloat16,
                                                                  gen))
        log(f"19 training kernels bfloat16 {label} {shape}: "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if label == "tp=4":
            for row in training_timings(torch, fa, shape, torch.bfloat16, gen):
                row.update(config=f"GPT2_SMALL_32K {label}", max_abs_err=errs[row["name"]])
                rows.append(row)
                log(f"19 kernel {row['name']:24s} {row['shape']:44s} ms {row['ms']:.4f} plain "
                    f"{row['plain_ms']:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']})")
    for label, m, ff in (("tp=4", 8192, 512), ("tp=2 of fsdp_tp 2x2", 4096, 1024)):
        sets = [tuple((torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)
                      for shape, std in (((m, 768), 1.0), ((ff, 768), 0.02), ((768, ff), 0.02),
                                         ((ff, 768), 0.02)))
                for _ in range(copies_for((2 * m * 768 + 3 * ff * 768) * 2))]
        out = sw._swiglu_forward(*sets[0])
        torch.cuda.synchronize()
        err = _max_err(out, sw.swiglu_plain(*sets[0]))
        tol = TOL.get(("swiglu", "bfloat16"), TOL_BF16)
        require(err <= tol, f"19 swiglu {label} m={m} ff={ff}: max error {err:.3e} > {tol:g}")
        ms, plain = time_ms(torch, sw._swiglu_forward, sets, 5), time_ms(torch, sw.swiglu_plain,
                                                                         sets, 3)
        flops, nbytes = 6 * m * 768 * ff, (2 * m * 768 + 3 * ff * 768) * 2
        bound = max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["bfloat16"]) * 1e3
        log(f"19 kernel swiglu bfloat16 {label} m={m} d=768 ff={ff}: err {err:.3e} (tol {tol:g}) "
            f"ms {ms:.4f} plain {plain:.4f} bound {bound:.4f}")
        rows.append({"name": "swiglu", "config": f"GPT2_SMALL_32K {label}", "dtype": "bfloat16",
                     "shape": f"m={m} d=768 ff={ff} forward", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bound})
    return rows


def phase_sharded(torch, run, losses, ref, cfg, on_card: bool) -> tuple[dict, dict]:
    """Phase 19 (the default run), on phase 18's world-1 group: the
    kernels at tensor-parallel shapes, then ``train()`` under ``fsdp`` with
    ZeRO-1 (``mesh data=1``) for 4 steps writing a sharded directory, and
    under ``fsdp_tp`` (``mesh data=1,model=1``) for 4 steps, each against
    one device's ``train()`` (phase 18's run) within phase 15's 1e-5
    relative with exact launch counts, and the directory verified and
    resumed under ``fsdp_tp`` to step 8.  Returns the launch counts of the
    two runs."""
    from bpe_transformer_tpu_torch.resilience.integrity import verify_checkpoint

    L = cfg.num_layers
    out: dict = {}
    if on_card:
        out["kernels"] = tp_kernel_cases(torch)
    ck = PARALLEL_WORK / "fsdp_ck"
    reset_counts()
    fsdp = run(cfg, 4, parallel="fsdp", mesh_axes={"data": 1}, opt_sharding="zero1",
               checkpoint_every=4, checkpoint_dir=str(ck))
    fsdp_counts = read_counts(tuple(KERNEL_META))
    reset_counts()
    fsdp_tp = run(cfg, 4, parallel="fsdp_tp", mesh_axes={"data": 1, "model": 1})
    tp_counts = read_counts(tuple(KERNEL_META))
    step4 = ck / "step_00000004.ckpt"
    verdict = verify_checkpoint(step4)
    require(step4.is_dir() and (step4 / "manifest.json").exists() and verdict.ok,
            f"19: {step4} is not a verified sharded directory: {verdict.problems}")
    resumed = losses(run(cfg, 8, parallel="fsdp_tp", mesh_axes={"data": 1, "model": 1},
                         resume_from=str(step4)))
    rel = {"fsdp zero1": max_rel(losses(fsdp), ref[:2]),
           "fsdp_tp": max_rel(losses(fsdp_tp), ref[:2]),
           "resumed fsdp_tp": max_rel(resumed, ref[2:])}
    log(f"19 world 1: fsdp zero1 {[round(v, 5) for v in losses(fsdp)]}, fsdp_tp "
        f"{[round(v, 5) for v in losses(fsdp_tp)]}, the fsdp directory ({verdict.files_checked} "
        f"files) resumed under fsdp_tp {[round(v, 5) for v in resumed]}; max rel diffs to one "
        f"device {rel} (tol {LOOP_REL_TOL:g})")
    require(all(v <= LOOP_REL_TOL for v in rel.values()),
            f"19: world-1 sharded runs disagree with one device: {rel}")
    want = {k: 4 * v for k, v in only(flash_attention_rope=L, flash_attention_bwd_dkdv=L,
                                      flash_attention_bwd_dq=L, swiglu=2 * L).items()}
    log(f"19 launches: fsdp zero1 { {k: v for k, v in fsdp_counts.items() if v} }, fsdp_tp "
        f"{ {k: v for k, v in tp_counts.items() if v} }")
    if on_card:
        require(fsdp_counts == want, f"19: fsdp launches {fsdp_counts} != {want}")
        require(tp_counts == want, f"19: fsdp_tp launches {tp_counts} != {want}")
    out.update(fsdp=losses(fsdp), fsdp_tp=losses(fsdp_tp), resumed=resumed, rel=rel,
               fsdp_step_wall_s=[r["step_wall_s"] for r in fsdp["history"]],
               fsdp_tp_step_wall_s=[r["step_wall_s"] for r in fsdp_tp["history"]])
    return {name: fsdp_counts[name] + tp_counts[name] for name in KERNEL_META}, out


def sharded_rank(torch, cfg=None, device: str = "cuda", batch: int = 8) -> None:
    """19 at world N, in each rank process (one card a rank, NCCL): each of
    :data:`SHARDED_CASES` against phase 8's one-card step on the same batch
    (phase 18's dp tolerances: step 1's loss and mean gradients, the losses
    of 3 steps, the weights within the AdamW bound), with exact launch
    counts, a rank's parameter and moment bytes equal to the specs'
    arithmetic, host ms a step, tok/s a card, peak memory a rank and NCCL
    ms a step; rank 0 prints and writes ``chip_smoke_sharded4.json``.
    ``device="cpu"`` (gloo) and a small ``cfg`` rehearse it on the CPU."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import abstract_params, init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
    from bpe_transformer_tpu_torch.parallel import (
        initialize_distributed,
        make_gspmd_train_step,
        make_mesh,
        shard_batch,
    )
    from bpe_transformer_tpu_torch.parallel.gspmd import block_bytes
    from bpe_transformer_tpu_torch.training.train_step import (
        TrainHParams,
        make_loss_fn,
        make_train_step,
        value_and_grad,
    )
    from bpe_transformer_tpu_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    dev = initialize_distributed(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    say = log if rank == 0 else (lambda msg: None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(dev.index)], capture_output=True, text=True,
                         check=True).stdout.strip() if on_card else "cpu"
    cfg = cfg or dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash_fused",
                                     flash_fused_min_seq=0, ffn_impl="pallas",
                                     remat_policy="save_attn")
    L, S = cfg.num_layers, cfg.context_length
    n_steps = 3
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=10)
    rng = np.random.default_rng(8)
    x, y = (rng.integers(0, cfg.vocab_size, size=(batch, S)) for _ in range(2))
    lrs = [cosine_schedule(i, hparams.max_learning_rate, hparams.min_learning_rate,
                           hparams.warmup_iters, hparams.cosine_cycle_iters)
           for i in range(n_steps)]
    adam_bound = DP_TOL["adam_flip"] * sum(lrs)
    tol = TRAIN_TOL["bfloat16"]
    out: dict = {"world": world, "smi": smi, "cases": []}

    def fresh():
        return init_params(cfg, torch.Generator(device=device).manual_seed(0), device=dev)

    # The one-card reference on rank 0: step 1's loss and gradients, and 3
    # steps' losses and weights.
    want_loss = want_grads = ref_losses = ref_leaves = None
    if rank == 0:
        p = fresh()
        full = (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        want_loss, want_grads = value_and_grad(make_loss_fn(cfg))(p, *full)
        want_grads = tree_leaves(want_grads)
        step = make_train_step(cfg, hparams)
        o, ref_losses = adamw_init(p), []
        for _ in range(n_steps):
            p, o, m = step(p, o, *full)
            ref_losses.append(float(m["loss"]))
        ref_leaves = [t.detach().clone() for t in tree_leaves(p)]
        del p, o, step
    for strategy, axes_of, zero1 in SHARDED_CASES:
        axes = axes_of(world)
        if world == 1 and "model" in axes:
            axes = {"data": 1, "model": 1}
        label = f"{strategy} {'x'.join(str(v) for v in axes.values())}" + (
            " zero1" if zero1 else "")
        mesh = make_mesh(axes, device=device)
        step = make_gspmd_train_step(cfg, hparams, mesh, strategy,
                                     example_params=abstract_params(cfg), opt_sharding=zero1)
        layout = step.layout
        p = layout.shard(fresh())
        o = layout.init_opt_state()
        xs, ys = shard_batch((x, y), mesh)
        # Step 1's loss and mean gradients, gathered whole.
        loss, grads = value_and_grad(make_loss_fn(cfg, shard=layout))(p, xs, ys)
        g = tree_leaves(grads)
        if layout.data is not None:
            layout.data.pmean_(loss)
            for i, spec in enumerate(layout.leaf_specs):
                if not layout.data_reduced(spec):
                    layout.data.pmean_(g[i])
        whole = [layout.gather_leaf(t, spec) for t, spec in zip(g, layout.leaf_specs)]
        if rank == 0:
            abs_err, rel_err = grad_errors(whole, want_grads)
            loss_err = abs(float(loss) - float(want_loss))
            say(f"19 {label} step 1 vs the one-card step: loss {float(loss):.6f} vs "
                f"{float(want_loss):.6f} (|d| {loss_err:.3e}, tol {tol['out']:g}); mean grads max "
                f"abs error {abs_err:.3e} (tol {tol['grad']:g}), largest per-leaf relative error "
                f"{rel_err:.3e}")
            require(loss_err <= tol["out"] and abs_err <= tol["grad"] and rel_err <= tol["grad"],
                    f"19 {label}: step 1 disagrees with the one-card step")
        del grads, g, whole
        # Bytes a rank: exactly the specs' arithmetic.
        pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(p))
        obytes = sum(t.numel() * t.element_size() for t in tree_leaves(o.m) + tree_leaves(o.v))
        spec_bytes = block_bytes(cfg, mesh.shape, strategy, zero1 == "zero1", mesh.coords)
        require(pbytes == spec_bytes["params"] and obytes == spec_bytes["moments"],
                f"19 {label} rank {rank}: {pbytes} + {obytes} bytes, the specs say "
                f"{spec_bytes}")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, step_losses = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            p, o, m = step(p, o, xs, ys)
            step_losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(tuple(KERNEL_META))
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        want = {k: n_steps * v for k, v in only(
            flash_attention_rope=L, flash_attention_bwd_dkdv=L, flash_attention_bwd_dq=L,
            swiglu=2 * L).items()}
        require(counts == want or not on_card, f"19 {label} rank {rank}: launches {counts} != "
                f"{want}")
        leaves = [layout.gather_leaf(t.detach(), spec)
                  for t, spec in zip(tree_leaves(p), layout.leaf_specs)]
        busy, nccl = nccl_ms(torch, lambda _: step(p, o, xs, ys), dev)
        t = torch.tensor([float(peak)], device=dev)
        peaks = [torch.zeros_like(t) for _ in range(world)]
        dist.all_gather(peaks, t)
        peaks = [int(v.item()) for v in peaks]
        if rank == 0:
            drift = leaf_drift(leaves, ref_leaves)
            loss_rel = max_rel(step_losses, ref_losses)
            mean_ms = float(np.mean(ms[1:]))
            say(f"19 {label} (GPT2_SMALL_32K, {batch}x{S}): losses "
                f"{[round(v, 5) for v in step_losses]} vs one card {[round(v, 5) for v in ref_losses]}"
                f" (rel {loss_rel:.2e}, tol {DP_TOL['loss_rel']:g}); weights max abs diff "
                f"{drift['max_abs']:.3e} (AdamW bound {adam_bound:.3e}); host ms a step "
                f"{[round(v, 1) for v in ms]} (steps 2-3 mean {mean_ms:.1f} ms = "
                f"{batch * S / mean_ms * 1e3 / world:.0f} tok/s a card); peak GB a rank "
                f"{[round(v / 1e9, 3) for v in peaks]}; rank 0 holds {pbytes / 1e9:.4f} GB of "
                f"params and {obytes / 1e9:.4f} GB of moments (dense "
                f"{spec_bytes['dense_params'] / 1e9:.4f} and "
                f"{2 * spec_bytes['dense_params'] / 1e9:.4f}); device busy {busy} ms a step of "
                f"which NCCL {nccl} ms; launches a step "
                f"{ {k: v // n_steps for k, v in counts.items() if v} } on {smi}")
            require(loss_rel <= DP_TOL["loss_rel"] and drift["max_abs"] <= adam_bound,
                    f"19 {label}: disagrees with the one-card step: {loss_rel}, {drift}")
            out["cases"].append({"label": label, "losses": step_losses, "host_ms": ms,
                                 "peak": peaks, "busy_ms": busy, "nccl_ms": nccl,
                                 "param_bytes": pbytes, "moment_bytes": obytes,
                                 "dense_param_bytes": spec_bytes["dense_params"],
                                 "loss_rel": loss_rel, **drift})
        del p, o, step, layout, leaves
        if on_card:
            torch.cuda.empty_cache()
    if rank == 0:
        out["ref_losses"] = ref_losses
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_sharded4.json").write_text(json.dumps(out, indent=1))
    dist.destroy_process_group()


def cli_sharded_resume(smi: str, world: int, cfg=None, device: str = "cuda") -> dict:
    """19 at world N: the ``train`` CLI under ``torchrun`` at fsdp=N with
    ZeRO-1 for 8 steps writing sharded directories (every 4 steps), the
    step-4 directory through ``verify-checkpoint``, then resumed from it at
    fsdp=N/2 and at tp=N/2: the resumed losses against the uninterrupted
    run's at DP_TOL's loss tolerance (another width splits the rows
    otherwise)."""
    import dataclasses
    import shutil

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K

    cfg = cfg or dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash_fused",
                                     flash_fused_min_seq=0, ffn_impl="pallas",
                                     remat_policy="save_attn")
    shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
    PARALLEL_WORK.mkdir(parents=True)
    try:
        zipf_tokens(cfg.vocab_size, 2_000_000, 15).tofile(PARALLEL_WORK / "tokens.bin")
        cfg.to_json(PARALLEL_WORK / "model.json")

        def torchrun(n: int, ck: Path, *extra) -> tuple[dict, float]:
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    f"--nproc-per-node={n}", *PORT_CLI, "train", "--data",
                    str(PARALLEL_WORK / "tokens.bin"), "--model-config",
                    str(PARALLEL_WORK / "model.json"), "--steps", "8", "--batch-size", "8",
                    "--log-every", "2", "--eval-every", "1000", "--checkpoint-every", "4",
                    "--lr", "6e-4", "--min-lr", "6e-5", "--warmup", "2", "--prefetch", "0",
                    "--checkpoint-dir", str(ck), "--device", device, *extra]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            require(proc.returncode == 0, f"19 torchrun x{n} {extra} exit {proc.returncode}: "
                    f"{proc.stderr[-3000:]}")
            return json.loads((ck / "summary.json").read_text()), wall

        ck = PARALLEL_WORK / "ck"
        full, wall_full = torchrun(world, ck, "--parallel", "fsdp", "--mesh", f"data={world}",
                                   "--opt-sharding", "zero1")
        step4 = ck / "step_00000004.ckpt"
        require(step4.is_dir() and (ck / "latest.ckpt").is_symlink(),
                f"19: {step4} is not a directory or latest.ckpt no link")
        port_cli("verify-checkpoint", str(step4))
        want = {r["step"]: r["loss"] for r in full["history"]}
        half = max(world // 2, 1)
        got, walls = {}, {"fsdp": wall_full}
        for name, flags in (("fsdp", ("--parallel", "fsdp", "--mesh", f"data={half}",
                                      "--opt-sharding", "zero1")),
                            ("tp", ("--parallel", "tp", "--mesh", f"model={half}"))):
            ck_r = PARALLEL_WORK / f"ck_{name}"
            ck_r.mkdir()
            shutil.copytree(step4, ck_r / step4.name)
            resumed, walls[f"resumed {name}"] = torchrun(half, ck_r, *flags, "--resume",
                                                         str(ck_r / step4.name))
            got[name] = {r["step"]: r["loss"] for r in resumed["history"]}
        rel = {name: max(abs(g[s] - want[s]) / abs(want[s]) for s in g) for name, g in
               got.items()}
        log(f"19 train CLI under torchrun: fsdp={world} zero1 8 steps {want} "
            f"({wall_full:.1f} s wall), its step-4 directory resumed at fsdp={half} zero1 "
            f"{got['fsdp']} and tp={half} {got['tp']} (walls {walls}); max rel diffs {rel} "
            f"(tol {DP_TOL['loss_rel']:g}) on {smi}")
        require(all(sorted(g) == [6, 8] for g in got.values())
                and all(v <= DP_TOL["loss_rel"] for v in rel.values()),
                f"19: resumed runs {got} vs {want}")
        return {"full": want, "resumed": got, "rel": rel, "wall_s": walls}
    finally:
        shutil.rmtree(PARALLEL_WORK, ignore_errors=True)


def leaf_drift(got: list, want: list) -> dict:
    """The largest absolute difference of two weight lists, and the share
    of entries that differ by more than 1e-5."""
    worst, over, total = 0.0, 0, 0
    for g, w in zip(got, want, strict=True):
        d = (g.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        over += int((d > 1e-5).sum())
        total += d.numel()
    return {"max_abs": worst, "share_over_1e-5": over / total}


def grad_errors(got: list, want: list) -> tuple[float, float]:
    """``(max abs error, largest per-leaf relative L2 error)``."""
    abs_err = max(_max_err(a, b) for a, b in zip(got, want, strict=True))
    rel_err = max(float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in zip(got, want))
    return abs_err, rel_err


def nccl_ms(torch, fn, dev) -> tuple[float | None, float | None]:
    """``(busy ms, NCCL ms)`` of one call from a ``torch.profiler`` trace
    (None off the card)."""
    from bpe_transformer_tpu_torch.telemetry.attribution import device_busy_split

    split = device_busy_split(fn, torch.zeros(1, device=dev))
    return (None, None) if split is None else (split[0] * 1e3, split[1] * 1e3)


def parallel_rank(torch, cfg=None, device: str = "cuda", batch: int = 8) -> None:
    """18 at world N, in each rank process (one card a rank, NCCL): dp=N
    against phase 8's one-card step, ZeRO-1 against dp, the sp grid(s)
    against phase 12's stacked ring, with step times, peak memory and NCCL
    time per step; rank 0 prints and writes ``chip_smoke_parallel4.json``.
    ``device="cpu"`` (gloo) and a small ``cfg`` rehearse it on the CPU,
    without the launch counts and the card's numbers."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init, sharded_adamw_init
    from bpe_transformer_tpu_torch.parallel import (
        StackedRing,
        initialize_distributed,
        make_dp_train_step,
        make_mesh,
        make_sp_grad_fn,
        make_sp_train_step,
        shard_batch,
        shard_sp_batch,
    )
    from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
    from bpe_transformer_tpu_torch.training.train_step import (
        TrainHParams,
        _pmean_scalars,
        _reduce_grads,
        make_loss_fn,
        make_train_step,
        value_and_grad,
    )
    from bpe_transformer_tpu_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    dev = initialize_distributed(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    say = log if rank == 0 else (lambda msg: None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(dev.index)], capture_output=True, text=True,
                         check=True).stdout.strip() if on_card else "cpu"
    cfg = cfg or dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash_fused",
                                     flash_fused_min_seq=0, ffn_impl="pallas",
                                     remat_policy="save_attn")
    sp_cfg = dataclasses.replace(cfg, attention_impl="flash")
    L, S = cfg.num_layers, cfg.context_length
    n_steps = 3
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=10)
    rng = np.random.default_rng(8)
    x, y = (rng.integers(0, cfg.vocab_size, size=(batch, S)) for _ in range(2))
    out: dict = {"world": world, "smi": smi}

    def fresh():
        return init_params(cfg, torch.Generator(device=device).manual_seed(0), device=dev)

    def timed_steps(step, state, xs, ys, n):
        """``n`` synchronised steps: the state, losses, host ms a step, peak
        memory and the grad norms."""
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, ms, norms = [], [], []
        for _ in range(n):
            t0 = time.perf_counter()
            *state, m = step(*state, xs, ys)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        return state, losses, ms, peak, norms

    def gathered_peak(nbytes: int) -> list:
        t = torch.tensor([float(nbytes)], device=dev)
        got = [torch.zeros_like(t) for _ in range(world)]
        dist.all_gather(got, t)
        return [int(v.item()) for v in got]

    tol = TRAIN_TOL["bfloat16"]
    lrs = [cosine_schedule(i, hparams.max_learning_rate, hparams.min_learning_rate,
                           hparams.warmup_iters, hparams.cosine_cycle_iters)
           for i in range(n_steps)]
    adam_bound = DP_TOL["adam_flip"] * sum(lrs)
    mesh = make_mesh({"data": world}, device=device)
    # (a) The one-card reference: phase 8's step on the whole batch; step 1's
    # loss and gradients against the ranks' reduced ones.
    ref_losses, ref_leaves = None, None
    p = fresh()
    xs, ys = shard_batch((x, y), mesh)
    loss, grads = value_and_grad(make_loss_fn(cfg))(p, xs, ys)
    (loss,) = _pmean_scalars(mesh.axis("data"), loss)
    grads = tree_leaves(_reduce_grads(grads, mesh.axis("data"), "float32"))
    if rank == 0:
        full = (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        want_loss, want_grads = value_and_grad(make_loss_fn(cfg))(p, *full)
        abs_err, rel_err = grad_errors(grads, tree_leaves(want_grads))
        loss_err = abs(float(loss) - float(want_loss))
        say(f"18 dp x{world} step 1 vs the one-card step: loss {float(loss):.6f} vs "
            f"{float(want_loss):.6f} (|d| {loss_err:.3e}, tol {tol['out']:g}); mean grads max "
            f"abs error {abs_err:.3e} (tol {tol['grad']:g}), largest per-leaf relative error "
            f"{rel_err:.3e}")
        require(loss_err <= tol["out"] and abs_err <= tol["grad"] and rel_err <= tol["grad"],
                f"18: dp x{world} step 1 disagrees with the one-card step")
        out["dp_step1"] = {"loss_err": loss_err, "grad_abs": abs_err, "grad_rel": rel_err}
        del want_grads
        state, ref_losses, *_ = timed_steps(make_train_step(cfg, hparams), (p, adamw_init(p)),
                                            *full, n_steps)
        ref_leaves = [t.detach().clone() for t in tree_leaves(state[0])]
        del state
    del p, grads
    runs = {}
    for name, zero1 in (("dp", None), ("zero1", "zero1")):
        p = fresh()
        opt = sharded_adamw_init(p, world, mesh) if zero1 else adamw_init(p)
        step = make_dp_train_step(cfg, hparams, mesh, opt_sharding=zero1)
        xs, ys = shard_batch((x, y), mesh)
        reset_counts()
        state, losses, ms, peak, norms = timed_steps(step, (p, opt), xs, ys, n_steps)
        counts = read_counts(tuple(KERNEL_META))
        want = {k: n_steps * v for k, v in only(
            flash_attention_rope=L, flash_attention_bwd_dkdv=L, flash_attention_bwd_dq=L,
            swiglu=2 * L).items()}
        require(counts == want or not on_card,
                f"18 {name} rank {rank}: launches {counts} != {want}")
        leaves = [t.detach().clone() for t in tree_leaves(state[0])]
        # A fourth step, traced (after the weights were read).
        busy, nccl = nccl_ms(torch, lambda _: step(*state, xs, ys), dev)
        opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state[1])
                        if isinstance(t, torch.Tensor) and t.device == dev)
        runs[name] = {"losses": losses, "host_ms": ms, "peak": gathered_peak(peak),
                      "busy_ms": busy, "nccl_ms": nccl, "opt_bytes": opt_bytes,
                      "grad_norms": norms, "leaves": leaves}
        del p, opt, state, step
    if rank == 0:
        dp, z1 = runs["dp"], runs["zero1"]
        dp_rel = {"loss": max_rel(dp["losses"], ref_losses),
                  **leaf_drift(dp["leaves"], ref_leaves)}
        z1_rel = {"loss": max_rel(z1["losses"], dp["losses"]),
                  # Step 1's: later steps start from weights AdamW moved apart.
                  "grad_norm": abs(z1["grad_norms"][0] - dp["grad_norms"][0])
                  / dp["grad_norms"][0],
                  **leaf_drift(z1["leaves"], dp["leaves"])}
        for name, r in runs.items():
            mean_ms = float(np.mean(r["host_ms"][1:]))
            say(f"18 {name} x{world} (GPT2_SMALL_32K, {batch}x{S}, {batch // world} rows a rank): "
                f"losses {[round(v, 5) for v in r['losses']]}; host ms a step "
                f"{[round(v, 1) for v in r['host_ms']]} (steps 2-3 mean {mean_ms:.1f} ms = "
                f"{batch * S / mean_ms * 1e3 / world:.0f} tok/s a card); peak GB a rank "
                f"{[round(v / 1e9, 2) for v in r['peak']]}; optimizer state on rank 0 "
                f"{r['opt_bytes'] / 1e9:.3f} GB; device busy {r['busy_ms']} ms a step of which "
                f"NCCL {r['nccl_ms']} ms on {smi}")
        say(f"18 dp x{world} 3 steps vs the one-card step's: loss rel {dp_rel['loss']:.2e} "
            f"(tol {DP_TOL['loss_rel']:g}), weights max abs diff {dp_rel['max_abs']:.3e} "
            f"(AdamW bound {adam_bound:.3e}), share over 1e-5 {dp_rel['share_over_1e-5']:.4f}; "
            f"one card {[round(v, 5) for v in ref_losses]}")
        say(f"18 zero1 x{world} vs dp x{world}: loss rel {z1_rel['loss']:.2e} (tol "
            f"{ZERO1_TOL['loss_rel']:g}), step-1 grad norm rel {z1_rel['grad_norm']:.2e} (tol "
            f"{ZERO1_TOL['grad_norm_rel']:g}), weights max abs diff {z1_rel['max_abs']:.3e} "
            f"(bound {adam_bound:.3e}), share over 1e-5 {z1_rel['share_over_1e-5']:.4f}")
        require(dp_rel["loss"] <= DP_TOL["loss_rel"] and dp_rel["max_abs"] <= adam_bound,
                f"18: dp x{world} disagrees with the one-card step: {dp_rel}")
        require(z1_rel["loss"] <= ZERO1_TOL["loss_rel"]
                and z1_rel["grad_norm"] <= ZERO1_TOL["grad_norm_rel"]
                and z1_rel["max_abs"] <= adam_bound,
                f"18: zero1 disagrees with dp: {z1_rel}")
        out["dp"] = {k: {kk: vv for kk, vv in v.items() if kk != "leaves"}
                     for k, v in runs.items()}
        out["dp"]["ref_losses"] = ref_losses
        out["dp_rel"], out["zero1_rel"] = dp_rel, z1_rel
    del runs, ref_leaves
    if on_card:
        torch.cuda.empty_cache()

    # (c) sp grids against phase 12's stacked ring of 4 on the whole batch.
    tol = TRAIN_TOL["bfloat16"]
    grids = [{"data": 1, "seq": world}] + ([{"data": 2, "seq": world // 2}]
                                          if world >= 4 else [])
    out["sp"] = []
    for axes in grids:
        mesh = make_mesh(axes, device=device)
        for zigzag in (False, True):
            label = (f"sp data={axes['data']} x seq={axes['seq']} "
                     f"{'zig-zag' if zigzag else 'contiguous'}")
            p = fresh()
            want_loss = want_grads = None
            if rank == 0:
                ring = StackedRing(SP_RANKS)
                want_loss, want_grads = make_sp_grad_fn(sp_cfg, ring, zigzag)(
                    p, *shard_sp_batch((x, y), ring, zigzag=zigzag, device=dev))
                want_grads = tree_leaves(want_grads)
            xs, ys = shard_sp_batch((x, y), mesh, zigzag=zigzag)
            loss, grads = make_sp_grad_fn(sp_cfg, mesh, zigzag)(p, xs, ys)
            if rank == 0:
                grads = tree_leaves(grads)
                loss_err = abs(float(loss) - float(want_loss))
                grad_err = max(_max_err(a, b) for a, b in zip(grads, want_grads, strict=True))
                rel_err = max(float((a - b).norm() / b.norm().clamp(min=1e-30))
                              for a, b in zip(grads, want_grads))
                say(f"18 {label} step 1 vs the stacked ring of {SP_RANKS}: loss "
                    f"{float(loss):.6f} vs {float(want_loss):.6f} (|d| {loss_err:.3e}, tol "
                    f"{tol['out']:g}); grads max abs error {grad_err:.3e} (tol {tol['grad']:g}), "
                    f"largest per-leaf relative error {rel_err:.3e}")
                require(loss_err <= tol["out"] and grad_err <= tol["grad"]
                        and rel_err <= tol["grad"], f"18 {label}: step 1 disagrees")
            del grads, want_grads
            step = make_sp_train_step(sp_cfg, hparams, mesh, zigzag=zigzag)
            reset_counts()
            state, losses, ms, peak, _ = timed_steps(step, (p, adamw_init(p)), xs, ys, n_steps)
            counts = read_counts(tuple(KERNEL_META))
            want = {k: n_steps * v for k, v in sp_launches_per_step(L, axes["seq"],
                                                                    zigzag).items()}
            require(counts == want or not on_card,
                    f"18 {label} rank {rank}: launches {counts} != {want}")
            busy, nccl = nccl_ms(torch, lambda _: step(*state, xs, ys), dev)
            peaks = gathered_peak(peak)
            mean_ms = float(np.mean(ms[1:]))
            say(f"18 {label}: losses {[round(v, 4) for v in losses]}; host ms a step "
                f"{[round(v, 1) for v in ms]} (steps 2-3 mean {mean_ms:.1f} ms = "
                f"{batch * S / mean_ms * 1e3 / world:.0f} tok/s a card); peak GB a rank "
                f"{[round(v / 1e9, 2) for v in peaks]}; device busy {busy} ms a step of "
                f"which NCCL {nccl} ms; launches a step "
                f"{ {k: v // n_steps for k, v in counts.items() if v} } on {smi}")
            require(all(math.isfinite(v) for v in losses), f"18 {label}: non-finite loss")
            out["sp"].append({"label": label, "losses": losses, "host_ms": ms, "peak": peaks,
                              "busy_ms": busy, "nccl_ms": nccl})
            del p, state, step
            if on_card:
                torch.cuda.empty_cache()
    if rank == 0:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_parallel4.json").write_text(json.dumps(out, indent=1))
    dist.destroy_process_group()


def cli_resume_across_widths(smi: str, world: int, cfg=None, device: str = "cuda") -> dict:
    """18 at world N: the ``train`` CLI under ``torchrun`` at dp=N with
    ZeRO-1 for 8 steps (checkpoints at 4 and 8), then resumed from step 4
    at dp=N/2 with ZeRO-1 (the state re-sharded) to 8: the resumed losses
    against the uninterrupted run's, at DP_TOL's loss tolerance (another
    width splits the rows otherwise, as dp=N against one card)."""
    import dataclasses
    import shutil

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K

    cfg = cfg or dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash_fused",
                                     flash_fused_min_seq=0, ffn_impl="pallas",
                                     remat_policy="save_attn")
    shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
    PARALLEL_WORK.mkdir(parents=True)
    try:
        zipf_tokens(cfg.vocab_size, 2_000_000, 15).tofile(PARALLEL_WORK / "tokens.bin")
        cfg.to_json(PARALLEL_WORK / "model.json")
        ck = PARALLEL_WORK / "ck"

        def torchrun(n: int, *extra) -> tuple[dict, float]:
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    f"--nproc-per-node={n}", *PORT_CLI, "train", "--data",
                    str(PARALLEL_WORK / "tokens.bin"), "--model-config",
                    str(PARALLEL_WORK / "model.json"), "--steps", "8", "--batch-size", "8",
                    "--log-every", "2", "--eval-every", "1000", "--checkpoint-every", "4",
                    "--lr", "6e-4", "--min-lr", "6e-5", "--warmup", "2", "--prefetch", "0",
                    "--parallel", "dp", "--mesh", f"data={n}", "--opt-sharding", "zero1",
                    "--device", device, *extra]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            require(proc.returncode == 0, f"18 torchrun x{n} exit {proc.returncode}: "
                    f"{proc.stderr[-3000:]}")
            ck_dir = Path(extra[extra.index("--checkpoint-dir") + 1])
            return json.loads((ck_dir / "summary.json").read_text()), wall

        full, wall_full = torchrun(world, "--checkpoint-dir", str(ck))
        port_cli("verify-checkpoint", str(ck / "step_00000004.ckpt"))
        ck_half = PARALLEL_WORK / "ck_half"
        ck_half.mkdir()
        for name in ("step_00000004.ckpt", "step_00000004.ckpt.crc32.json"):
            shutil.copy(ck / name, ck_half / name)
        half = max(world // 2, 1)
        resumed, wall_resumed = torchrun(half, "--checkpoint-dir", str(ck_half), "--resume",
                                         str(ck_half / "step_00000004.ckpt"))
        want = {r["step"]: r["loss"] for r in full["history"]}
        got = {r["step"]: r["loss"] for r in resumed["history"]}
        rel = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
        log(f"18 train CLI under torchrun: dp={world} zero1 8 steps {want} ({wall_full:.1f} s "
            f"wall), resumed from step 4 at dp={half} zero1 {got} ({wall_resumed:.1f} s); max "
            f"rel diff {rel:.2e} (tol {DP_TOL['loss_rel']:g}) on {smi}")
        require(sorted(got) == [6, 8] and rel <= DP_TOL["loss_rel"],
                f"18: resumed at dp={half}: {got} vs {want}")
        return {"full": want, "resumed": got, "rel": rel, "wall_s": [wall_full, wall_resumed]}
    finally:
        shutil.rmtree(PARALLEL_WORK, ignore_errors=True)


# ------------------------------------------------------------ phase 20

#: 20's working files (token files, checkpoints), removed at the end.
PIPE_WORK = ROOT / ".scratch" / "chip_smoke_pipeline"
#: Ulysses' ranks on the default run's stacked ring, and the pipeline's
#: microbatches a step (8 rows: 2 a microbatch at pp=4).
ULYSSES_RANKS = 4
PIPE_MICRO = 4


def p20_configs() -> dict:
    """20's configurations at full width: Ulysses at GPT2_SMALL_32K under
    ``attention_impl="flash"`` (Ulysses runs the flash kernels only then),
    the pipeline at phase 8's knobs, and TINYSTORIES_MOE at phase 16's."""
    import dataclasses

    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K, TINYSTORIES_MOE

    pipe = dataclasses.replace(GPT2_SMALL_32K, attention_impl="flash_fused",
                               flash_fused_min_seq=0, ffn_impl="pallas", remat_policy="save_attn")
    return {"ulysses": dataclasses.replace(pipe, attention_impl="flash"), "pipe": pipe,
            "moe": dataclasses.replace(TINYSTORIES_MOE, attention_impl="flash_fused",
                                       flash_fused_min_seq=0)}


def p20_launches(kind: str, cfg, layers: int, micro: int = 1) -> dict:
    """One step's launches a rank: Ulysses runs B2 + lse, B4's pair and the
    SwiGLU forward twice (save_attn) a layer; the phase-8 knobs B5 instead
    of B2; the pipeline does so for each microbatch on its own layers; an
    MoE FFN launches no SwiGLU."""
    attn = "flash_attention" if kind == "ulysses" else "flash_attention_rope"
    n = layers * micro
    return only(**{attn: n, "flash_attention_bwd_dkdv": n, "flash_attention_bwd_dq": n},
                swiglu=0 if cfg.ffn_type == "moe" else 2 * n)


def ulysses_stacked(torch, smi: str, cfg, batch: int = 8, device: str = "cuda") -> dict:
    """20a: ``make_sp_train_step(ulysses=True)`` on a StackedRing of 4 at
    ``cfg`` (bf16, ``batch`` x the context): step 1's loss and per-leaf
    gradients against the dense flash step at phase 12c's tolerances, then
    3 steps with exact launch counts (B2 + lse on ``(batch, heads/4, S,
    64)``, B4's pair, B3).  Returns the launches."""
    import numpy as np

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

    on_card = device == "cuda"
    ring = StackedRing(ULYSSES_RANKS)
    rng = np.random.default_rng(20)
    x, y = (rng.integers(0, cfg.vocab_size, size=(batch, cfg.context_length)) for _ in range(2))
    tol = TRAIN_TOL["bfloat16"]
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    want_loss, want_grads = value_and_grad(make_loss_fn(cfg))(
        params, torch.as_tensor(x, device=device), torch.as_tensor(y, device=device))
    xs, ys = shard_sp_batch((x, y), ring, device=device)
    loss, grads = make_sp_grad_fn(cfg, ring, ulysses=True)(params, xs, ys)
    abs_err, rel_err = grad_errors(tree_leaves(grads), tree_leaves(want_grads))
    loss_err = abs(float(loss) - float(want_loss))
    label = f"20a Ulysses x{ULYSSES_RANKS} (stacked ring, {batch}x{cfg.context_length})"
    log(f"{label} step 1 vs the dense flash step: loss {float(loss):.6f} vs "
        f"{float(want_loss):.6f} (|d| {loss_err:.3e}, tol {tol['out']:g}); grads max abs error "
        f"{abs_err:.3e}, largest per-leaf relative error {rel_err:.3e} (tol {tol['grad']:g})")
    require(loss_err <= tol["out"] and abs_err <= tol["grad"] and rel_err <= tol["grad"],
            f"{label}: step 1 disagrees with the dense step")
    del grads, want_grads
    step = make_sp_train_step(cfg, TrainHParams(max_learning_rate=6e-4, warmup_iters=1,
                                                cosine_cycle_iters=10), ring, ulysses=True)
    opt = adamw_init(params)
    per_step = p20_launches("ulysses", cfg, cfg.num_layers)
    losses, host_ms = [], []
    totals = dict.fromkeys(KERNEL_META, 0)
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, xs, ys)
        losses.append(float(m["loss"]))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(tuple(KERNEL_META))
        require(counts == per_step or not on_card,
                f"{label}: launches of one step {counts} != {per_step}")
        totals = {k: totals[k] + counts[k] for k in KERNEL_META}
    require(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss {losses}")
    log(f"{label} 3 steps: losses {[round(v, 5) for v in losses]}, host ms "
        f"{[round(v, 1) for v in host_ms]}; launches a step "
        f"{ {k: v for k, v in per_step.items() if v} } on {smi}")
    return totals


def p20_kernel_rows(torch) -> list[dict]:
    """20c: B2 + lse at Ulysses' shape (8, 3, 1024, 64), and B5, B4's pair
    and B3 at the pipeline's 2-row microbatch (2, 12, 1024, 64) and m 2048,
    each against its plain version (phase 5's tolerances) and timed, the
    backward by CUDA-graph replay ("device")."""
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import swiglu as sw

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    for label, shape, names in (
            ("Ulysses x4", (8, 3, 1024, 64), ("flash_attention",)),
            ("pp microbatch", (2, 12, 1024, 64), ("flash_attention_rope",
                                                  "flash_attention_bwd_dkdv",
                                                  "flash_attention_bwd_dq"))):
        errs = training_kernel_errors(torch, fa, *training_inputs(torch, shape, torch.bfloat16,
                                                                  gen))
        log(f"20c training kernels bfloat16 {label} {shape}: "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        for row in training_timings(torch, fa, shape, torch.bfloat16, gen):
            if row["name"] in names:
                row.update(config=f"GPT2_SMALL_32K {label}", max_abs_err=errs[row["name"]])
                rows.append(row)
                log(f"20c kernel {row['name']:24s} {row['shape']:44s} ms {row['ms']:.4f} dev "
                    f"{row['device_ms']:.4f} plain {row['plain_ms']:.4f} bound "
                    f"{row['bound_ms']:.4f} ({row['bound_by']})")
    m, d, ff = 2048, 768, 2048
    sets = [tuple((torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)
                  for shape, std in (((m, d), 1.0), ((ff, d), 0.02), ((d, ff), 0.02),
                                     ((ff, d), 0.02)))
            for _ in range(copies_for((2 * m * d + 3 * ff * d) * 2))]
    out = sw._swiglu_forward(*sets[0])
    torch.cuda.synchronize()
    err = _max_err(out, sw.swiglu_plain(*sets[0]))
    tol = TOL.get(("swiglu", "bfloat16"), TOL_BF16)
    require(err <= tol, f"20c swiglu m={m}: max error {err:.3e} > {tol:g}")
    ms, plain = time_ms(torch, sw._swiglu_forward, sets, 10), time_ms(torch, sw.swiglu_plain,
                                                                      sets, 3)
    dev = time_ms(torch, sw._swiglu_forward, sets, 10, graph=True)
    lib = time_ms(torch, lambda x, w1, w2, w3: torch.nn.functional.linear(
        torch.nn.functional.silu(x @ w1.t()) * (x @ w3.t()), w2), sets, 10)
    flops, nbytes = 6 * m * d * ff, (2 * m * d + 3 * ff * d) * 2
    byte_ms, op_ms = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"20c kernel swiglu bfloat16 pp microbatch m={m} d={d} ff={ff}: err {err:.3e} (tol "
        f"{tol:g}) ms {ms:.4f} dev {dev:.4f} plain {plain:.4f} library {lib:.4f} bound "
        f"{max(byte_ms, op_ms):.4f}")
    rows.append({"name": "swiglu", "config": "GPT2_SMALL_32K pp microbatch", "dtype": "bfloat16",
                 "shape": f"m={m} d={d} ff={ff} forward", "max_abs_err": err, "ms": ms,
                 "device_ms": dev, "plain_ms": plain, "library_ms": lib,
                 "bound_ms": max(byte_ms, op_ms),
                 "bound_by": "bytes" if byte_ms >= op_ms else "operations"})
    return rows


def phase_pipeline(torch, smi: str, run, losses, ref, cfgs=None, moe_data=None,
                   on_card: bool = True, batch: int = 8) -> tuple[dict, dict]:
    """Phase 20 (the default run) on phase 18's world-1 group: (a)
    Ulysses on a stacked ring of 4 (:func:`ulysses_stacked`); (b) ``train()``
    under pp (``mesh pp=1``, 4 microbatches) for 4 steps writing a stacked
    directory, verified and resumed under pp to step 8, against one device
    (phase 18's run; the microbatches change the bf16 sums, so DP_TOL's
    2e-3), and under ``ep`` (``expert=1``) and ``dp_ep`` (``data=1,
    expert=1``) at TINYSTORIES_MOE against one device's run within 1e-5;
    exact launch counts; (c) on the card the kernels at 20's shapes
    (:func:`p20_kernel_rows`).  Returns the launches and the record."""
    from bpe_transformer_tpu_torch.resilience.integrity import verify_checkpoint

    cfgs = cfgs or p20_configs()
    pipe, moe = cfgs["pipe"], cfgs["moe"]
    out: dict = {}
    t0 = time.perf_counter()
    totals = ulysses_stacked(torch, smi, cfgs["ulysses"], batch,
                             "cuda" if on_card else "cpu")
    out["ulysses_s"] = time.perf_counter() - t0
    ck = PARALLEL_WORK / "pp_ck"
    reset_counts()
    pp = run(pipe, 4, parallel="pp", mesh_axes={"pp": 1}, pp_microbatches=PIPE_MICRO,
             checkpoint_every=4, checkpoint_dir=str(ck))
    pp_counts = read_counts(tuple(KERNEL_META))
    step4 = ck / "step_00000004.ckpt"
    verdict = verify_checkpoint(step4)
    require(step4.is_dir() and verdict.ok, f"20: {step4} is not a verified directory: "
            f"{verdict.problems}")
    resumed = losses(run(pipe, 8, parallel="pp", mesh_axes={"pp": 1},
                         pp_microbatches=PIPE_MICRO, resume_from=str(step4)))
    moe_ref = losses(run(moe, 4, data=moe_data))
    reset_counts()
    ep = {name: losses(run(moe, 4, data=moe_data, parallel=name, mesh_axes=axes))
          for name, axes in (("ep", {"expert": 1}), ("dp_ep", {"data": 1, "expert": 1}))}
    ep_counts = read_counts(tuple(KERNEL_META))
    rel = {"pp": max_rel(losses(pp), ref[:2]), "resumed pp": max_rel(resumed, ref[2:]),
           **{name: max_rel(v, moe_ref) for name, v in ep.items()}}
    log(f"20b world 1: pp x{PIPE_MICRO} microbatches {[round(v, 5) for v in losses(pp)]}, its "
        f"directory ({verdict.files_checked} files) resumed {[round(v, 5) for v in resumed]} vs "
        f"one device {[round(v, 5) for v in ref]}; TINYSTORIES_MOE one device "
        f"{[round(v, 5) for v in moe_ref]}, ep {[round(v, 5) for v in ep['ep']]}, dp_ep "
        f"{[round(v, 5) for v in ep['dp_ep']]}; max rel diffs {rel} (pp tol "
        f"{DP_TOL['loss_rel']:g}, ep {LOOP_REL_TOL:g})")
    require(rel["pp"] <= DP_TOL["loss_rel"] and rel["resumed pp"] <= DP_TOL["loss_rel"]
            and rel["ep"] <= LOOP_REL_TOL and rel["dp_ep"] <= LOOP_REL_TOL,
            f"20: world-1 runs disagree with one device: {rel}")
    want_pp = {k: 4 * v for k, v in p20_launches("pp", pipe, pipe.num_layers,
                                                  PIPE_MICRO).items()}
    want_ep = {k: 8 * v for k, v in p20_launches("ep", moe, moe.num_layers).items()}
    log(f"20 launches: pp { {k: v for k, v in pp_counts.items() if v} }, ep + dp_ep "
        f"{ {k: v for k, v in ep_counts.items() if v} }")
    if on_card:
        require(pp_counts == want_pp, f"20: pp launches {pp_counts} != {want_pp}")
        require(ep_counts == want_ep, f"20: ep launches {ep_counts} != {want_ep}")
        t0 = time.perf_counter()
        out["kernels"] = p20_kernel_rows(torch)
        out["kernels_s"] = time.perf_counter() - t0
    out.update(pp=losses(pp), resumed=resumed, moe_ref=moe_ref, ep=ep, rel=rel,
               pp_step_wall_s=[r["step_wall_s"] for r in pp["history"]])
    for name in KERNEL_META:
        totals[name] += pp_counts[name] + ep_counts[name]
    return totals, out


#: 20 at world N: (kind, label, config key, mesh of N ranks, opt_sharding).
PIPE_CASES = (
    ("ulysses", "Ulysses seq", "ulysses", lambda n: {"data": 1, "seq": n}, None),
    ("ulysses", "Ulysses data x seq", "ulysses", lambda n: {"data": 2, "seq": n // 2}, None),
    ("pp", "pp", "pipe", lambda n: {"pp": n}, None),
    ("pp", "data x pp", "pipe", lambda n: {"data": 2, "pp": n // 2}, None),
    ("ep", "ep", "moe", lambda n: {"expert": n}, None),
    ("dp_ep", "dp_ep", "moe", lambda n: {"data": 2, "expert": n // 2}, "zero1"),
    ("fsdp_ep", "fsdp_ep", "moe", lambda n: {"data": 2, "expert": n // 2}, "zero1"),
    ("pp", "pp MoE", "moe", lambda n: {"pp": n}, None),
)


def p20_state(torch, kind: str, cfg, mesh, zero1, hparams, fresh, x, y, device: str) -> dict:
    """One case of 20 at world N on this rank: the state, the step, the
    step-1 ``(loss, whole grads)`` function, the whole-weights function, the
    placed batch and the bytes the specs give a rank."""
    import numpy as np

    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.parallel import (
        PipelineLayout,
        make_gspmd_train_step,
        make_pp_grad_fn,
        make_pp_train_step,
        make_sp_grad_fn,
        make_sp_train_step,
        shard_batch,
        shard_sp_batch,
        stack_pipeline_params,
        unstack_pipeline_params,
    )
    from bpe_transformer_tpu_torch.parallel.gspmd import block_bytes
    from bpe_transformer_tpu_torch.parallel.sharding import local_shape
    from bpe_transformer_tpu_torch.models.transformer import abstract_params
    from bpe_transformer_tpu_torch.training.train_step import make_loss_fn, value_and_grad
    from bpe_transformer_tpu_torch.tree import tree_leaves

    if kind == "ulysses":
        params = fresh()
        dense = 4 * sum(t.numel() for t in tree_leaves(params))
        # Copies: the step updates the parameters in place.
        return dict(params=params, opt=adamw_init(params),
                    batch=shard_sp_batch((x, y), mesh),
                    step=make_sp_train_step(cfg, hparams, mesh, ulysses=True),
                    grads=make_sp_grad_fn(cfg, mesh, ulysses=True),
                    whole=lambda tree: [t.detach().clone() for t in tree_leaves(tree)],
                    spec_bytes={"params": dense, "moments": 2 * dense})
    if kind == "pp":
        lay = PipelineLayout(cfg, mesh)
        grad_fn = make_pp_grad_fn(cfg, mesh, num_microbatches=PIPE_MICRO)
        nbytes = sum(4 * int(np.prod(local_shape(tuple(t.shape), s, mesh.shape)))
                     for t, s in zip(tree_leaves(lay.full), lay.leaf_specs))
        return dict(params=lay.shard(stack_pipeline_params(fresh(), lay.stages)),
                    opt=lay.init_opt_state(), batch=shard_batch((x, y), mesh),
                    step=make_pp_train_step(cfg, hparams, mesh, num_microbatches=PIPE_MICRO),
                    grads=grad_fn,
                    whole=lambda tree: tree_leaves(unstack_pipeline_params(lay.gather(tree))),
                    spec_bytes={"params": nbytes, "moments": 2 * nbytes})
    step = make_gspmd_train_step(cfg, hparams, mesh, kind, example_params=abstract_params(cfg),
                                 opt_sharding=zero1)
    layout = step.layout
    loss_grad = value_and_grad(make_loss_fn(cfg, shard=layout))

    def grads(p, xs, ys):
        loss, g = loss_grad(p, xs, ys)
        g = tree_leaves(g)
        if layout.data is not None:
            layout.data.pmean_(loss)
            for i, spec in enumerate(layout.leaf_specs):
                if not layout.data_reduced(spec):
                    # A batched expert weight's gradient may come back
                    # transposed; a collective takes contiguous storage.
                    g[i] = layout.data.pmean_(g[i].contiguous())
        return loss, g

    return dict(params=layout.shard(fresh()), opt=layout.init_opt_state(),
                batch=shard_batch((x, y), mesh), step=step, grads=grads,
                whole=lambda tree: [layout.gather_leaf(t.detach(), s) for t, s in
                                    zip(tree_leaves(tree), layout.leaf_specs)],
                spec_bytes=block_bytes(cfg, mesh.shape, kind, zero1 == "zero1", mesh.coords))


def one_card_grad_fn(cfg, groups: int):
    """The one-card ``(params, x, y) -> (loss, grads)``; with ``groups`` > 1
    an MoE FFN routes that many consecutive slices of the batch's rows as
    dispatch groups of their own, as the pipeline routes its microbatches
    (the loss and aux then equal the pipeline's)."""
    from bpe_transformer_tpu_torch.models.transformer import forward_hidden, lm_head_weight
    from bpe_transformer_tpu_torch.ops.losses import lm_loss
    from bpe_transformer_tpu_torch.training.train_step import make_loss_fn, value_and_grad

    if groups == 1:
        return value_and_grad(make_loss_fn(cfg))

    def loss_fn(params, x, y):
        hidden, aux = forward_hidden(params, x, cfg, moe_groups=groups)
        return (lm_loss(hidden, lm_head_weight(params, cfg), y, cfg.loss_chunk)
                + cfg.router_aux_weight * aux)

    return value_and_grad(loss_fn)


def pipeline_rank(torch, cfgs=None, device: str = "cuda", batch: int = 8) -> None:
    """20 at world N, in each rank process (one card a rank, NCCL): each of
    :data:`PIPE_CASES` against the one-card step of its config on the same
    batch, as phase 19 holds its strategies: step 1's loss and whole
    gradients (per-leaf relative, phase 12's bf16 tolerance), the losses of
    3 steps (2e-3) and the weights (the AdamW bound), exact launch counts,
    a rank's parameter and moment bytes equal to the specs', host ms a
    step, tok/s a card, peak memory a rank and the traced device busy and
    NCCL ms of a step; rank 0 prints and writes ``chip_smoke_pipeline4.json``.
    The pipeline's MoE is held against the one-card step whose MoE routes
    each microbatch's rows as a group (:func:`one_card_grad_fn`).
    ``device="cpu"`` (gloo) and small ``cfgs`` rehearse it on the CPU."""
    import numpy as np
    import torch.distributed as dist

    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
    from bpe_transformer_tpu_torch.parallel import initialize_distributed, make_mesh
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams, _update
    from bpe_transformer_tpu_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    dev = initialize_distributed(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    say = log if rank == 0 else (lambda msg: None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(dev.index)], capture_output=True, text=True,
                         check=True).stdout.strip() if on_card else "cpu"
    cfgs = cfgs or p20_configs()
    n_steps = 3
    hparams = TrainHParams(max_learning_rate=6e-4, min_learning_rate=6e-5, warmup_iters=1,
                           cosine_cycle_iters=10)
    adam_bound = DP_TOL["adam_flip"] * sum(
        cosine_schedule(i, hparams.max_learning_rate, hparams.min_learning_rate,
                        hparams.warmup_iters, hparams.cosine_cycle_iters) for i in range(n_steps))
    tol = TRAIN_TOL["bfloat16"]
    out: dict = {"world": world, "smi": smi, "cases": []}
    refs: dict = {}
    for kind, name, key, axes_of, zero1 in PIPE_CASES:
        cfg = cfgs[key]
        S = cfg.context_length
        rng = np.random.default_rng(20)
        x, y = (rng.integers(0, cfg.vocab_size, size=(batch, S)) for _ in range(2))

        def fresh(cfg=cfg):
            return init_params(cfg, torch.Generator(device=device).manual_seed(0), device=dev)

        axes = axes_of(world)
        groups = (PIPE_MICRO * axes.get("data", 1) if kind == "pp" and cfg.ffn_type == "moe"
                  else 1)
        if rank == 0 and (key, groups) not in refs:
            # The one-card reference: step 1's loss and gradients, 3 steps.
            p = fresh()
            full = (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
            grad_fn = one_card_grad_fn(cfg, groups)
            want_loss, want_grads = grad_fn(p, *full)
            o, ref_losses = adamw_init(p), []
            for _ in range(n_steps):
                p, o, m = _update(p, o, *grad_fn(p, *full), hparams)
                ref_losses.append(float(m["loss"]))
            refs[key, groups] = (float(want_loss), tree_leaves(want_grads), ref_losses,
                                 [t.detach().clone() for t in tree_leaves(p)])
            del p, o, want_grads
        label = f"{name} {'x'.join(str(v) for v in axes.values())}" + (
            " zero1" if zero1 else "")
        mesh = make_mesh(axes, device=device)
        case = p20_state(torch, kind, cfg, mesh, zero1, hparams, fresh, x, y, device)
        p, o, (xs, ys) = case["params"], case["opt"], case["batch"]
        loss, grads = case["grads"](p, xs, ys)
        whole = case["whole"](grads)
        if rank == 0:
            want_loss, want_grads, ref_losses, ref_leaves = refs[key, groups]
            abs_err, rel_err = grad_errors(whole, want_grads)
            loss_err = abs(float(loss) - want_loss)
            say(f"20 {label} step 1 vs one card: loss {float(loss):.6f} vs {want_loss:.6f} (|d| "
                f"{loss_err:.3e}, tol {tol['out']:g}); grads max abs error {abs_err:.3e}, largest "
                f"per-leaf relative error {rel_err:.3e} (tol {tol['grad']:g})")
            require(loss_err <= tol["out"] and rel_err <= tol["grad"],
                    f"20 {label}: step 1 disagrees with the one-card step")
        del grads, whole
        pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(p))
        obytes = sum(t.numel() * t.element_size() for t in tree_leaves(o.m) + tree_leaves(o.v))
        require(pbytes == case["spec_bytes"]["params"]
                and obytes == case["spec_bytes"]["moments"],
                f"20 {label} rank {rank}: {pbytes} + {obytes} bytes, the specs say "
                f"{case['spec_bytes']}")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, step_losses = [], []
        step = case["step"]
        for _ in range(n_steps):
            t0 = time.perf_counter()
            p, o, m = step(p, o, xs, ys)
            step_losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts(tuple(KERNEL_META))
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        layers = cfg.num_layers // axes.get("pp", 1)
        per_step = p20_launches("ulysses" if kind == "ulysses" else kind, cfg, layers,
                                PIPE_MICRO if kind == "pp" else 1)
        want = {k: n_steps * v for k, v in per_step.items()}
        require(counts == want or not on_card,
                f"20 {label} rank {rank}: launches {counts} != {want}")
        leaves = case["whole"](p)
        busy, nccl = nccl_ms(torch, lambda _: step(p, o, xs, ys), dev)
        t = torch.tensor([float(peak)], device=dev)
        peaks = [torch.zeros_like(t) for _ in range(world)]
        dist.all_gather(peaks, t)
        peaks = [int(v.item()) for v in peaks]
        if rank == 0:
            drift = leaf_drift(leaves, ref_leaves)
            loss_rel = max_rel(step_losses, ref_losses)
            mean_ms = float(np.mean(ms[1:]))
            say(f"20 {label} ({batch}x{S}): losses {[round(v, 5) for v in step_losses]} vs one "
                f"card {[round(v, 5) for v in ref_losses]} (rel {loss_rel:.2e}, tol "
                f"{DP_TOL['loss_rel']:g}); weights max abs diff {drift['max_abs']:.3e} (AdamW "
                f"bound {adam_bound:.3e}); host ms a step {[round(v, 1) for v in ms]} (steps 2-3 "
                f"mean {mean_ms:.1f} ms = {batch * S / mean_ms * 1e3 / world:.0f} tok/s a card); "
                f"peak GB a rank {[round(v / 1e9, 3) for v in peaks]}; rank 0 holds {pbytes:,} B "
                f"of params and {obytes:,} B of moments (the specs' {case['spec_bytes']}); "
                f"device busy {busy} ms a step of which NCCL {nccl} ms; launches a step "
                f"{ {k: v for k, v in per_step.items() if v} } on {smi}")
            require(loss_rel <= DP_TOL["loss_rel"] and drift["max_abs"] <= adam_bound,
                    f"20 {label}: disagrees with the one-card step: {loss_rel}, {drift}")
            out["cases"].append({"label": label, "losses": step_losses, "ref": ref_losses,
                                 "host_ms": ms, "peak": peaks, "busy_ms": busy,
                                 "nccl_ms": nccl, "param_bytes": pbytes, "moment_bytes": obytes,
                                 "loss_rel": loss_rel, **drift})
            # Written after each case, so a failing later case keeps these.
            OUT_DIR.mkdir(exist_ok=True)
            (OUT_DIR / "chip_smoke_pipeline4.json").write_text(json.dumps(out, indent=1))
        del p, o, step, case, leaves
        if on_card:
            torch.cuda.empty_cache()
    dist.destroy_process_group()


def cli_pipeline_resume(smi: str, world: int, cfgs=None, device: str = "cuda") -> dict:
    """20 at world N: the ``train`` CLI under ``torchrun``: pp=N for 8 steps
    writing stacked directories (every 4 steps), the step-4 directory
    through ``verify-checkpoint``, resumed at pp=N to 8 (the uninterrupted
    losses within 1e-5 relative: the same ranks do the same work) and at
    pp=N/2, refused with the JAX loop's message; dp_ep (data=2) for 8 steps
    at TINYSTORIES_MOE, resumed at ep=N (DP_TOL's 2e-3); and ``train
    --supervise --parallel pp`` without ``torchrun``, one rank killed at
    step 5: the supervisor respawns the world once and ends with the
    uninterrupted pp=N losses."""
    import shutil

    cfgs = cfgs or p20_configs()
    shutil.rmtree(PIPE_WORK, ignore_errors=True)
    PIPE_WORK.mkdir(parents=True)
    try:
        for key in ("pipe", "moe"):
            cfg = cfgs[key]
            zipf_tokens(cfg.vocab_size, 2_000_000, 20).tofile(PIPE_WORK / f"{key}.bin")
            cfg.to_json(PIPE_WORK / f"{key}.json")

        def argv_of(key: str, ck: Path, *extra) -> list:
            return [*PORT_CLI, "train", "--data", str(PIPE_WORK / f"{key}.bin"),
                    "--model-config", str(PIPE_WORK / f"{key}.json"), "--steps", "8",
                    "--batch-size", "8", "--log-every", "2", "--eval-every", "1000",
                    "--checkpoint-every", "4", "--lr", "6e-4", "--min-lr", "6e-5", "--warmup",
                    "2", "--prefetch", "0", "--checkpoint-dir", str(ck), "--device", device,
                    *extra]

        def torchrun(n: int, key: str, ck: Path, *extra, ok: bool = True):
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    f"--nproc-per-node={n}", *argv_of(key, ck, *extra)]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if not ok:
                return proc, wall
            require(proc.returncode == 0, f"20 torchrun x{n} {extra} exit {proc.returncode}: "
                    f"{proc.stderr[-3000:]}")
            summary = json.loads((ck / "summary.json").read_text())
            return {r["step"]: r["loss"] for r in summary["history"]}, wall

        def copy_step4(src: Path, name: str) -> Path:
            dst = PIPE_WORK / name
            dst.mkdir()
            shutil.copytree(src / "step_00000004.ckpt", dst / "step_00000004.ckpt")
            return dst

        pp_args = ("--parallel", "pp", "--mesh", f"pp={world}", "--pp-microbatches",
                   str(PIPE_MICRO))
        ck = PIPE_WORK / "pp_ck"
        full, walls = {}, {}
        full["pp"], walls["pp"] = torchrun(world, "pipe", ck, *pp_args)
        port_cli("verify-checkpoint", str(ck / "step_00000004.ckpt"))
        again = copy_step4(ck, "pp_again")
        resumed, walls["pp resumed"] = torchrun(world, "pipe", again, *pp_args, "--resume",
                                                str(again / "step_00000004.ckpt"))
        half = max(world // 2, 1)
        narrow = copy_step4(ck, "pp_half")
        proc, walls["pp half refused"] = torchrun(
            half, "pipe", narrow, "--parallel", "pp", "--mesh", f"pp={half}", "--resume",
            str(narrow / "step_00000004.ckpt"), ok=False)
        message = (f"checkpoint has {world} pipeline stages but the mesh pp axis is {half}; "
                   f"resume with --mesh ...,pp={world}")
        require(proc.returncode != 0 and message in proc.stderr,
                f"20: a pp={world} directory resumed at pp={half} was not refused with JAX's "
                f"message (exit {proc.returncode}): {proc.stderr[-2000:]}")
        ep_ck = PIPE_WORK / "ep_ck"
        full["dp_ep"], walls["dp_ep"] = torchrun(world, "moe", ep_ck, "--parallel", "dp_ep",
                                                 "--mesh", f"data=2,expert={world // 2}")
        ep_again = copy_step4(ep_ck, "ep_again")
        ep_resumed, walls["ep resumed"] = torchrun(
            world, "moe", ep_again, "--parallel", "ep", "--mesh", f"expert={world}", "--resume",
            str(ep_again / "step_00000004.ckpt"))
        sup_ck = PIPE_WORK / "sup_ck"
        t0 = time.perf_counter()
        sup = subprocess.run(
            [sys.executable, *argv_of("pipe", sup_ck, *pp_args, "--supervise",
                                      "--max-restarts", "2", "--restart-backoff", "1")],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
            env={**os.environ, "BT_FAULTS": json.dumps(
                {"kill_at_step": 5, "once_dir": str(PIPE_WORK / "once")})})
        walls["supervised"] = time.perf_counter() - t0
        require(sup.returncode == 0 and "spawn #2" in sup.stdout,
                f"20: the supervised pp world (exit {sup.returncode}): {sup.stdout[-2000:]} "
                f"{sup.stderr[-2000:]}")
        supervised = {r["step"]: r["loss"] for r in json.loads(
            (sup_ck / "summary.json").read_text())["history"]}
        rel = {
            "pp resumed": max(abs(resumed[s] - full["pp"][s]) / abs(full["pp"][s])
                              for s in resumed),
            "ep resumed": max(abs(ep_resumed[s] - full["dp_ep"][s]) / abs(full["dp_ep"][s])
                              for s in ep_resumed),
            "supervised": max(abs(supervised[s] - full["pp"][s]) / abs(full["pp"][s])
                              for s in supervised),
        }
        log(f"20 train CLI under torchrun: pp={world} 8 steps {full['pp']}, its step-4 "
            f"directory resumed at pp={world} {resumed}, at pp={half} refused (\"{message}\"); "
            f"dp_ep data=2 x expert={world // 2} {full['dp_ep']}, resumed at ep={world} "
            f"{ep_resumed}; supervised pp={world}, a rank killed at step 5, respawned: "
            f"{supervised}; max rel diffs {rel} (pp tol {LOOP_REL_TOL:g}, ep "
            f"{DP_TOL['loss_rel']:g}); walls {walls} on {smi}")
        require(sorted(resumed) == [6, 8] and rel["pp resumed"] <= LOOP_REL_TOL
                and rel["supervised"] <= LOOP_REL_TOL and rel["ep resumed"] <= DP_TOL["loss_rel"],
                f"20: resumed runs disagree with the uninterrupted ones: {rel}")
        return {"full": full, "resumed": resumed, "ep_resumed": ep_resumed,
                "supervised": supervised, "rel": rel, "wall_s": walls}
    finally:
        shutil.rmtree(PIPE_WORK, ignore_errors=True)


def main_parallel(world: int, phase: int = 18) -> int:
    """``chip_smoke.py --phase 18|19|20 [--world N]``: the build, then the
    phase alone: at world 1 the default run's phases 18, 19 and 20, at
    world N > 1 one rank process a card (NCCL) for dp, ZeRO-1 and the sp
    grids (18), the GSPMD strategies (19) or Ulysses, the pipeline and
    expert parallelism (20), then the ``train`` CLI under ``torchrun``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if not (ROOT / "bpe_transformer_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port package beside {__file__}; run it from the repo",
              file=sys.stderr)
        return 1
    require(torch.cuda.device_count() >= world,
            f"--world {world} needs {world} cards, this host shows {torch.cuda.device_count()}")
    sys.path.insert(0, str(ROOT))
    from bpe_transformer_tpu_torch.kernels import _build
    from bpe_transformer_tpu_torch.parallel.launch import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    smi = smi_all[0]
    for line in smi_all[:world]:
        log(line)
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({built})")
    t0 = time.perf_counter()
    if world == 1:
        counts, counts19, counts20 = phase_parallel(torch, smi)
        log(f"18 launches {counts}; 19 launches {counts19}; 20 launches {counts20}")
    else:
        outs = launch([__file__, "--phase", str(phase), "--world", str(world), "--rank-child"],
                      world, timeout=600 if phase == 20 else 900, cwd=ROOT)
        print(outs[0], end="", flush=True)
        log(f"{phase} ranks: ok ({time.perf_counter() - t0:.1f} s)")
        if phase == 18:
            cli = cli_resume_across_widths(smi, world)
            name = "chip_smoke_parallel4_cli.json"
        elif phase == 19:
            cli = cli_sharded_resume(smi, world)
            name = "chip_smoke_sharded4_cli.json"
        else:
            cli = cli_pipeline_resume(smi, world)
            name = "chip_smoke_pipeline4_cli.json"
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / name).write_text(json.dumps(cli, indent=1))
    log(f"phase {phase} across {world} card(s): ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": world},
    }))
    return 0


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
    t0 = time.perf_counter()
    rows13 = phase_serve_http(torch, smi, keep_work=True)
    log(f"phase 13 serving over HTTP: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    try:
        phase_fleet(torch, smi, rows13)
    finally:
        import shutil

        shutil.rmtree(SERVE_WORK, ignore_errors=True)
    log(f"phase 14 the serving fleet: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    try:
        counts.update(phase_training_loop(torch, smi))
    finally:
        import shutil

        shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    log(f"phase 15 the training loop as a user runs it: ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    try:
        moe_counts = phase_moe(torch, smi)
    finally:
        import shutil

        shutil.rmtree(MOE_WORK, ignore_errors=True)
    # The kernels the MoE path launches report its counts.
    counts.update({name: n for name, n in moe_counts.items() if n})
    log(f"phase 16 the MoE family (TINYSTORIES_MOE): ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    try:
        phase_surface(torch, smi)
    finally:
        import shutil

        shutil.rmtree(SURFACE_WORK, ignore_errors=True)
    log(f"phase 17 the native tokenizer, the adapters, attribution and warmup: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    # Phase 18's main path is dp (ZeRO-1) and sp over a process group,
    # phase 19's fsdp and fsdp_tp over the same group, and phase 20's
    # Ulysses, pp and the ep strategies: their launches are added to every
    # kernel's count.
    counts18, counts19, counts20 = phase_parallel(torch, smi)
    for name in KERNEL_META:
        counts[name] = counts.get(name, 0) + counts18[name] + counts19[name] + counts20[name]

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


def _args(argv: list) -> dict:
    """``--phase 18|19|20 [--world N] [--rank-child]``, or nothing (every
    phase)."""
    import argparse

    parser = argparse.ArgumentParser(description="Run the port on the card and check it.")
    parser.add_argument("--phase", type=int, choices=[18, 19, 20], default=None,
                        help="run the build and this phase alone")
    parser.add_argument("--world", type=int, default=1,
                        help="cards for --phase 18, 19 or 20 (one rank process a card)")
    parser.add_argument("--rank-child", action="store_true", help=argparse.SUPPRESS)
    return vars(parser.parse_args(argv))


if __name__ == "__main__":
    try:
        opts = _args(sys.argv[1:])
        if opts["rank_child"]:
            import torch

            sys.path.insert(0, str(ROOT))
            {18: parallel_rank, 19: sharded_rank, 20: pipeline_rank}[opts["phase"]](torch)
            sys.exit(0)
        if opts["phase"] in (18, 19, 20):
            sys.exit(main_parallel(opts["world"], opts["phase"]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
