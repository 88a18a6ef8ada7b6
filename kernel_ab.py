#!/usr/bin/env python3
"""Time the port's kernels of two checkouts on one CUDA card, in turns.

    python3 kernel_ab.py PARENT_DIR [CHANGE_DIR]

Runs PARENT, CHANGE, CHANGE, PARENT (CHANGE defaults to this script's
directory), each in a fresh process that imports that checkout's
``bpe_transformer_tpu_torch``, builds its kernels and times each kernel by
CUDA-graph replay (device time, inputs cycled past the 50 MB L2) at the
GPT2_SMALL_32K serving and training shapes and the TINYSTORIES_4L float32
training shape: the flash forward with its lse (and with RoPE in the
kernel), the prefill forward, the ring's non-causal forward, the bf16 flash
backward kernels (dK/dV and dQ, causal at the training shape and
non-causal at the ring's launch shape), the SwiGLU forward at a decode tick
and at the training m, the int8 matmul with bf16 x at a tick (m 8) and a
prefill chunk (m 256) of 768 -> 2048 and at a tick of the 768 -> 32000
head, and the decode kernels at a tick.  Prints one line per run and writes them to
``chiprun_out/kernel_ab.jsonl``.  Two versions are compared only inside one
call, on one card, as the turns above do.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def graph_ms(torch, fn, sets, iters=20) -> float:
    for t in sets:
        fn(*t)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from bpe_transformer_tpu_torch.kernels import _build
    from bpe_transformer_tpu_torch.kernels import decode_attention as da
    from bpe_transformer_tpu_torch.kernels import flash_attention as fa
    from bpe_transformer_tpu_torch.kernels import quant_matmul as qm
    from bpe_transformer_tpu_torch.kernels import swiglu as sw
    from bpe_transformer_tpu_torch.ops.quant import quantize_weight
    from bpe_transformer_tpu_torch.ops.rope import rope_tables

    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, dtype=bf, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    times = {}
    for dtype, shape in ((f32, (16, 8, 256, 32)), (f32, (8, 12, 1024, 64)),
                         (bf, (8, 12, 1024, 64))):
        s, d = shape[-2:]
        sets = [tuple(rnd(*shape, dtype=dtype) for _ in range(3)) for _ in range(4)]
        cos, sin = rope_tables(d, s, dtype=dtype, device="cuda")
        tag = f"{str(dtype)[6:]} {shape}"
        times[f"flash fwd+lse {tag}"] = graph_ms(
            torch, lambda q, k, v: fa._forward(q, k, v, with_lse=True), sets)
        times[f"flash rope fwd+lse {tag}"] = graph_ms(
            torch, lambda q, k, v: fa._forward(q, k, v, cos, sin, with_lse=True), sets)
    sets = [tuple(rnd(1, 12, 1024, 64) for _ in range(3)) for _ in range(8)]
    times["flash prefill bf16 (1, 12, 1024, 64)"] = graph_ms(torch, fa._forward, sets)
    sets = [tuple(rnd(4, 8, 12, 256, 64) for _ in range(3)) for _ in range(4)]
    times["flash nc fwd+lse bf16 4 x (8, 12, 256, 64)"] = graph_ms(
        torch, lambda q, k, v: fa._forward(q, k, v, with_lse=True, causal=False), sets)
    for shape, causal in (((8, 12, 1024, 64), True), ((4, 8, 12, 256, 64), False)):
        sets = []
        for _ in range(4):
            q, k, v, g = (rnd(*shape) for _ in range(4))
            out, lse = fa._forward(q, k, v, with_lse=True, causal=causal)
            sets.append((q, k, v, g, lse, (g.float() * out.float()).sum(-1).contiguous()))
        for which in ("dkdv", "dq"):
            times[f"flash bwd {which}{'' if causal else ' nc'} bf16 {shape}"] = graph_ms(
                torch, lambda q, k, v, g, lse, delta, which=which, causal=causal: fa._launch_bwd(
                    which, q, k, v, g, lse, delta, causal), sets)
    for m, k_in, n_out in ((8, 768, 2048), (256, 768, 2048), (8, 768, 32000)):
        sets = []
        for _ in range(max(2, min(16, math.ceil(128e6 / (n_out * k_in))))):
            w = torch.randn(n_out, k_in, generator=gen, device="cuda") * 0.02
            qw = quantize_weight(w)
            sets.append((rnd(m, k_in), qw["q"], qw["scale"]))
        times[f"quant_matmul bf16 m={m} {k_in}->{n_out}"] = graph_ms(
            torch, qm.quant_matmul, sets, 48)
    for m in (8, 8192):
        sets = [(rnd(m, 768), rnd(2048, 768, std=0.02), rnd(768, 2048, std=0.02),
                 rnd(2048, 768, std=0.02)) for _ in range(4)]
        times[f"swiglu bf16 m={m} d=768 ff=2048"] = graph_ms(torch, sw._swiglu_forward, sets)
    pos = torch.tensor([0, 15, 100, 257, 511, 700, 900, 1023], device="cuda")
    for H, KV in ((12, 12), (16, 4)):
        sets = [(rnd(8, H, 64), rnd(8, KV, 1024, 64), rnd(8, KV, 1024, 64), pos)
                for _ in range(8)]
        times[f"decode bf16 H={H} KV={KV} ctx=1024"] = graph_ms(
            torch, da.decode_attention, sets, 48)
    nb = 8 * 64 + 1
    for kv_int8 in (False, True):
        sets = []
        for _ in range(8):
            tables = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1)
            tables = tables[: 8 * 64].reshape(8, 64).to(torch.int32)
            if kv_int8:
                k, v = (torch.randint(-127, 128, (nb, 12, 16, 64), generator=gen,
                                      device="cuda").to(torch.int8) for _ in range(2))
                ks, vs = ((torch.rand(nb, 12, generator=gen, device="cuda") + 0.5) / 60
                          for _ in range(2))
            else:
                k, v = rnd(nb, 12, 16, 64), rnd(nb, 12, 16, 64)
                ks = vs = None
            sets.append((rnd(8, 12, 64), k, v, tables, pos, ks, vs))
        times[f"paged decode bf16 {'int8' if kv_int8 else 'act'} KV"] = graph_ms(
            torch, lambda q, k, v, t, p, ks, vs: da.paged_decode_attention(
                q, k, v, t, p, k_scale=ks, v_scale=vs), sets, 48)
    return {"root": root, "device": torch.cuda.get_device_name(0), "ms": times}


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = str(Path(sys.argv[1]).resolve())
    change = str(Path(sys.argv[2]).resolve()) if len(sys.argv) > 2 else str(HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_ab.jsonl", "a") as sink:
        for label, root in (("parent", parent), ("change", change), ("change", change),
                            ("parent", parent)):
            run = subprocess.run([sys.executable, __file__, "--worker", root],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], file=sys.stderr)
                return 1
            row = {"label": label, "card": smi, **json.loads(run.stdout.strip().splitlines()[-1])}
            sink.write(json.dumps(row) + "\n")
            print(label, " | ".join(f"{k} {v:.4f}" for k, v in row["ms"].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
