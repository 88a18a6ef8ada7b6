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
head, the decode kernels at a tick (B1 with 12 heads on 12 KV heads and 16
on 4; B7 through a block table at act width and int8), the fused tails at
the serving knobs (B9 at 8 rows, B10 at 40, bf16 and int8 heads of
GPT2_SMALL_32K), and the GeLU forward and backward at the training shape
(8192 x 3072 bf16).  Each run also counts the static SASS instructions of
each GeLU kernel of its tree, whole and per element copy in the code (``cuobjdump
-sass`` on the built library; :func:`sass_counts`), and the first line
gives the card's name, power limit and top SM clock.  Prints one line per
run and writes them to
``chiprun_out/kernel_ab.jsonl``.  Two versions are compared only inside one
call, on one card, as the turns above do.
"""

from __future__ import annotations

import importlib
import json
import math
import re
import shutil
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


def sass_counts(lib: Path) -> dict:
    """Static SASS instructions of each GeLU kernel in ``lib``
    (``cuobjdump -sass``), and per element copy in the code: the kernel's
    instructions over its ``MUFU.EX2`` (each element's exp, or tanh's in
    the backward, issues one).  That share includes the kernel's index
    arithmetic, its scalar tail and the code of branches an element does
    not take (the division's slow path, tanhf's second range), so it is an
    upper bound on the instructions one element issues.  Empty without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    counts = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        kind = re.search(r"gelu_(fwd|bwd)_kernel", name)
        if not kind:
            continue
        insts = [m.group(1) for m in (re.match(r"^/\*[0-9a-f]+\*/\s+(\S.*)", line.strip())
                                      for line in chunk.splitlines())
                 if m and not m.group(1).startswith("NOP")]  # NOP: alignment padding
        copies = sum(bool(re.search(r"\bMUFU\.EX2\b", inst)) for inst in insts)
        dtype = "bf16" if "bfloat16" in name else "f32"
        counts[f"{kind.group(1)} {dtype}"] = {
            "instructions": len(insts), "element_copies": copies,
            "per_element": len(insts) / copies if copies else None}
    return counts


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from bpe_transformer_tpu_torch.kernels import _build
    da = importlib.import_module("bpe_transformer_tpu_torch.kernels.decode_attention")
    fa = importlib.import_module("bpe_transformer_tpu_torch.kernels.flash_attention")
    qm = importlib.import_module("bpe_transformer_tpu_torch.kernels.quant_matmul")
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
    from bpe_transformer_tpu_torch.kernels import sample as smp

    vocab, d = 32000, 768
    for name, rows in (("fused_head_sample", 8), ("fused_verify_head", 40)):
        knobs = [((0.0, 0, 2.0), (0.8, 50, 0.95))[i % 2] for i in range(rows)]
        temps = torch.tensor([k[0] for k in knobs], device="cuda")
        top_ks = torch.tensor([k[1] for k in knobs], dtype=torch.int32, device="cuda")
        top_ps = torch.tensor([k[2] for k in knobs], device="cuda")
        for head_kind in ("bf16", "int8"):
            sets = []
            for _ in range(4 if head_kind == "bf16" else 8):
                w = torch.randn(vocab, d, generator=gen, device="cuda") * 0.02
                u = torch.rand(rows, vocab, generator=gen, device="cuda").clamp(min=1e-20)
                sets.append((rnd(rows, d), quantize_weight(w) if head_kind == "int8" else w.to(bf),
                             -torch.log(-torch.log(u)),
                             torch.randint(0, vocab, (rows,), generator=gen, device="cuda"),
                             torch.softmax(torch.randn(rows, vocab, generator=gen,
                                                       device="cuda") * 2, dim=-1),
                             torch.empty(rows, vocab, device="cuda")))
            if name == "fused_head_sample":
                def fn(x, h, g, j, q, ws):
                    return smp.fused_head_sample(x, h, temps, top_ks, top_ps, g, logits_out=ws)
            else:
                def fn(x, h, g, j, q, ws):
                    return smp.fused_verify_head(x, h, temps, top_ks, top_ps, j, q, g,
                                                 logits_out=ws)
            times[f"{name} bf16 R={rows} V={vocab} d={d} {head_kind} head"] = graph_ms(
                torch, fn, sets, 24)
    ge = importlib.import_module("bpe_transformer_tpu_torch.kernels.gelu")

    F = torch.nn.functional
    sets = [(rnd(8192, 3072, std=3.0), rnd(8192, 3072)) for _ in range(4)]
    times["gelu bf16 m=8192 ff=3072"] = graph_ms(torch, lambda x, g: ge._gelu_forward(x), sets, 48)
    times["gelu_bwd bf16 m=8192 ff=3072"] = graph_ms(torch, ge._gelu_backward, sets, 48)
    times["F.gelu tanh bf16 m=8192 (library)"] = graph_ms(
        torch, lambda x, g: F.gelu(x, approximate="tanh"), sets, 48)
    times["aten.gelu_backward tanh bf16 m=8192 (library)"] = graph_ms(
        torch, lambda x, g: torch.ops.aten.gelu_backward(g, x, approximate="tanh"), sets, 48)
    sass = sass_counts(_build.build_dir() / "libgelu.so")
    return {"root": root, "device": torch.cuda.get_device_name(0), "ms": times, "sass": sass}


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = str(Path(sys.argv[1]).resolve())
    change = str(Path(sys.argv[2]).resolve()) if len(sys.argv) > 2 else str(HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"],
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
            print(label, "gelu SASS instructions per element copy:", " | ".join(
                f"{k} {v['per_element']} ({v['instructions']} over {v['element_copies']})"
                for k, v in row.get("sass", {}).items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
