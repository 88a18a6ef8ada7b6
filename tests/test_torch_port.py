"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
nor ``regex``, its entry points (the ``serve``, ``generate`` and ``eval``
commands too) run on the card unless the caller asks for the CPU, and
``chip_smoke.py`` refuses to report without a card or without the repo.
The jax-free run also serves through the paged engine with int8 KV blocks
and int8 weights and through the speculative engine with the fused
sampling tail, serves a ``gelu`` FFN model dense and paged (int8), and
drives the ``train`` CLI on the CPU, resuming from its own checkpoint, and
on a ``--model-config`` whose ``ffn_type`` is ``"gelu"`` and one whose
``ffn_type`` is ``"moe"`` (``moe_aux`` in its stream, its checkpoint through
``verify-checkpoint``), and takes a
sequence-parallel step on a stacked ring of two shards, on the device of the
tensors it is given; and runs the ``train-tokenizer``, ``tokenize``,
``generate``, ``eval`` and offline ``serve`` commands on the CPU.  The
serving fleet's front-end modules (the router, the controller, the fleet
aggregator, the SLO layer, the incident bundler, the monitor and the KV wire
codec) import with ``torch`` refused as well; the ``route``, ``control``,
``fleet`` and ``incident`` commands exist, and ``serve --role`` or
``--evacuate-to`` without ``--paged`` exits with 2 as in the JAX package.
The jax-free ``train`` writes the telemetry stream with every tap, async
checkpoints and prefetch; ``report``, ``monitor`` and ``verify-checkpoint``
run on it jax-free, and their output is the JAX package's tools' byte for
byte; the report, trace, watchdog, supervisor and retention modules and
the CLI module import with ``torch`` refused too."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "bpe_transformer_tpu_torch"

# Runs in a fresh interpreter where importing jax, regex, or anything of the
# JAX package, fails.
_JAX_FREE_SCRIPT = r"""
import dataclasses, importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None
sys.modules["regex"] = None

class RefuseJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "bpe_transformer_tpu" or name.startswith("bpe_transformer_tpu."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, RefuseJaxPackage())

import torch
import bpe_transformer_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, "bpe_transformer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
expected = {
    "bpe_transformer_tpu_torch." + m for m in (
        "checkpointing.checkpoint", "data.dataset", "kernels.flash_attention", "kernels.gelu",
        "kernels.quant_matmul", "kernels.sample", "kernels.swiglu", "models.transformer",
        "ops.core", "ops.grad", "ops.losses", "ops.quant", "optim.adamw", "optim.schedule",
        "parallel.mesh", "parallel.ring_attention", "parallel.sp", "resilience.integrity", "serving.kvpool.blocks", "serving.kvpool.paged_engine",
        "serving.kvpool.radix", "serving.spec", "serving.spec.draft", "serving.spec.engine",
        "training.cli", "training.loop", "training.train_step", "tree",
        "settings", "tokenization.pretokenization", "tokenization.tokenizer",
        "tokenization.trainer", "tokenization.gpt2", "tokenization.unicode_classes",
        "telemetry.schema", "telemetry.spans", "telemetry.sinks", "telemetry.alerts",
        "telemetry.flightrecorder", "telemetry.manifest", "telemetry.resources",
        "telemetry.attribution", "utils.flops", "serving.metrics", "serving.server",
        "training.sampling", "_lazy", "serving.kvpool.migrate", "serving.router",
        "serving.controller", "telemetry.slo", "telemetry.monitor", "telemetry.fleet",
        "telemetry.incident", "resilience.faults", "resilience.supervisor",
        "resilience.signals", "resilience.rollback", "resilience.retention",
        "telemetry.watchdog", "telemetry.timing", "telemetry.health", "telemetry.dynamics",
        "telemetry.report", "telemetry.trace", "utils.profiling", "utils.metrics",
        "models.moe",
    )
}
assert expected <= set(names), sorted(expected - set(names))

from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
from bpe_transformer_tpu_torch.models.transformer import init_params
from bpe_transformer_tpu_torch.serving.kvpool import PagedEngine
from bpe_transformer_tpu_torch.serving.server import ServingEngine
from bpe_transformer_tpu_torch.serving.spec import DraftModel, DraftSpec, SpecEngine

cfg = dataclasses.replace(
    TS_TEST_CONFIG, vocab_size=64, context_length=16, attention_impl="flash", ffn_impl="pallas",
    decode_attention_impl="pallas",
)
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
with ServingEngine(params, cfg, slots=2, min_bucket=4, device="cpu") as serving:
    result = serving.generate([1, 2, 3], max_new_tokens=3, temperature=0.0)
assert len(result.token_ids) == 3 and result.finish_reason == "length", result
with ServingEngine(params, cfg, slots=2, min_bucket=4, paged=True, block_size=4,
                   kv_dtype="int8", weight_dtype="int8", device="cpu") as serving:
    result = serving.generate([1, 2, 3, 4, 5], max_new_tokens=3, temperature=0.0)
assert len(result.token_ids) == 3 and result.finish_reason == "length", result
with ServingEngine(params, cfg, slots=2, min_bucket=4, paged=True, block_size=4, speculate_k=2,
                   draft_spec=DraftSpec(truncate_layers=1), fused_sampling=True,
                   device="cpu") as serving:
    result = serving.generate([1, 2, 3, 4, 5], max_new_tokens=4, temperature=0.8, top_k=5)
assert len(result.token_ids) == 4 and result.finish_reason == "length", result
gelu_cfg = dataclasses.replace(cfg, ffn_type="gelu")
gelu_params = init_params(gelu_cfg, torch.Generator().manual_seed(1), device="cpu")
for kw in ({}, dict(paged=True, block_size=4, kv_dtype="int8", weight_dtype="int8")):
    with ServingEngine(gelu_params, gelu_cfg, slots=2, min_bucket=4, device="cpu",
                       **kw) as serving:
        result = serving.generate([1, 2, 3, 4, 5], max_new_tokens=3, temperature=0.0)
    assert len(result.token_ids) == 3 and result.finish_reason == "length", (kw, result)

import contextlib, io, json, numpy as np
from pathlib import Path
from bpe_transformer_tpu_torch.training.cli import main as cli_main
from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
from bpe_transformer_tpu_torch.training.train_step import TrainHParams

work = Path(sys.argv[1])
tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, 500).astype(np.uint16)
tokens.tofile(work / "tokens.bin")
cfg.to_json(work / "cfg.json")
argv = ["train", "--data", str(work / "tokens.bin"), "--val-data", str(work / "tokens.bin"),
        "--model-config", str(work / "cfg.json"), "--batch-size", "2", "--log-every", "1",
        "--eval-every", "2", "--checkpoint-every", "2", "--checkpoint-dir", str(work / "ck"),
        "--device", "cpu"]
stream = ["--metrics-jsonl", str(work / "m.jsonl"), "--health-stats", "--dynamics-every", "1",
          "--watchdog", "--prefetch", "2", "--async-checkpoint"]
assert cli_main(argv + ["--steps", "2"] + stream) == 0
assert cli_main(argv + ["--steps", "3", "--resume", str(work / "ck")]) == 0
# The training tools, jax-free: report (its trace export too), monitor and
# verify-checkpoint on the stream and checkpoints just written.
for tool in (["report", str(work / "m.jsonl"), "--trace", str(work / "trace.json")],
             ["monitor", str(work / "m.jsonl"), "--once", "--plain"],
             ["verify-checkpoint", str(work / "ck" / "latest.ckpt")]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(tool) == 0, tool
    assert out.getvalue().strip(), tool
assert json.loads((work / "trace.json").read_text())["traceEvents"]
summary = json.loads((work / "ck" / "summary.json").read_text())
assert [r["step"] for r in summary["history"]] == [3], summary
assert (work / "ck" / "step_00000003.ckpt.crc32.json").exists()
gelu_cfg.to_json(work / "gelu.json")
assert json.loads((work / "gelu.json").read_text())["ffn_type"] == "gelu"
gelu_argv = argv[:argv.index("--model-config")] + ["--model-config", str(work / "gelu.json")]
gelu_argv += argv[argv.index("--model-config") + 2:]
gelu_argv[gelu_argv.index(str(work / "ck"))] = str(work / "ck_gelu")
assert cli_main(gelu_argv + ["--steps", "2"]) == 0
summary = json.loads((work / "ck_gelu" / "summary.json").read_text())
assert [r["step"] for r in summary["history"]] == [1, 2], summary
# An MoE config trains with health stats (moe_aux in the stream) and its
# checkpoint passes verify-checkpoint.
moe_cfg = dataclasses.replace(cfg, ffn_type="moe", n_experts=4, router_top_k=2,
                              moe_dispatch="gather")
moe_cfg.to_json(work / "moe.json")
moe_argv = [str(work / "moe.json") if a == str(work / "gelu.json") else
            str(work / "ck_moe") if a == str(work / "ck_gelu") else a for a in gelu_argv]
assert cli_main(moe_argv + ["--steps", "2", "--health-stats", "--metrics-jsonl",
                            str(work / "moe.jsonl")]) == 0
moe_steps = [json.loads(line) for line in (work / "moe.jsonl").read_text().splitlines()]
moe_steps = [r for r in moe_steps if r.get("kind") is None and "loss" in r]
assert len(moe_steps) == 2 and all(np.isfinite(r["moe_aux"]) for r in moe_steps), moe_steps
with contextlib.redirect_stdout(io.StringIO()):
    assert cli_main(["verify-checkpoint", str(work / "ck_moe" / "latest.ckpt")]) == 0

# The serving CLIs, regex-free: train a tokenizer and tokenize with it; then
# generate, eval and offline-batch serve on the trained checkpoint (64-token
# vocabulary) with a tokenizer of the bytes below 63 and one special token.
import pickle
(work / "corpus.txt").write_text("the cat sat on the mat. it's 42 \u4e2d\u6587!\n" * 50)
assert cli_main(["train-tokenizer", "--input", str(work / "corpus.txt"), "--vocab-size", "300",
                 "--output-dir", str(work / "tok300"), "--workers", "1"]) == 0
assert cli_main(["tokenize", "--input", str(work / "corpus.txt"), "--tokenizer-dir",
                 str(work / "tok300"), "--output", str(work / "corpus.bin")]) == 0
assert 256 < int(np.fromfile(work / "corpus.bin", np.uint16).max()) < 300
(work / "tok").mkdir()
(work / "tok" / "vocab.pkl").write_bytes(pickle.dumps({i: bytes([i]) for i in range(63)}))
(work / "tok" / "merges.pkl").write_bytes(pickle.dumps([]))
tok_argv = ["--tokenizer-dir", str(work / "tok")]
ckpt = ["--checkpoint", str(work / "ck" / "step_00000003.ckpt")]
(work / "prompts.txt").write_text("12 34\n5\n")
model_cmds = {
    "generate": ["generate", *ckpt, *tok_argv, "--prompt", "12", "--max-new-tokens", "4",
                 "--print-ids"],
    "eval": ["eval", *ckpt, "--data", str(work / "tokens.bin"), "--batches", "1",
             "--batch-size", "2"],
    "serve": ["serve", *ckpt, *tok_argv, "--prompts-file", str(work / "prompts.txt"),
              "--output", str(work / "out.jsonl"), "--max-new-tokens", "3"],
}
for name, argv in model_cmds.items():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(argv + ["--device", "cpu"]) == 0, name
    assert out.getvalue().strip(), name
assert len((work / "out.jsonl").read_text().splitlines()) == 2
assert "regex" not in sys.modules or sys.modules["regex"] is None

# The fleet's commands exist; roles and evacuation need the block pool.
from bpe_transformer_tpu_torch.training.cli import build_parser
assert {"route", "control", "fleet", "incident"} <= set(
    build_parser()._subparsers._group_actions[0].choices)
for extra in (["--role", "decode"], ["--role", "prefill"], ["--evacuate-to", "127.0.0.1:9"]):
    assert cli_main(["serve", *ckpt, *tok_argv, "--device", "cpu", *extra]) == 2, extra
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli_main(["control", "--fleet", "127.0.0.1:9", "--observe-only", "--once"]) == 0
assert json.loads(out.getvalue().splitlines()[0])["action"] == "hold"

from bpe_transformer_tpu_torch.optim import adamw_init
from bpe_transformer_tpu_torch.parallel import StackedRing, make_sp_train_step, shard_sp_batch

ring = StackedRing(2)
sp_params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
batch = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 2, 16))
xs, ys = shard_sp_batch((batch[0], batch[1]), ring, zigzag=True, device="cpu")
assert xs.shape == (2, 2, 8) and xs.device.type == "cpu", xs.shape
sp_params, _, metrics = make_sp_train_step(cfg, TrainHParams(), ring, zigzag=True)(
    sp_params, adamw_init(sp_params), xs, ys)
assert np.isfinite(float(metrics["loss"])) and sp_params["lm_head"].device.type == "cpu"

if not torch.cuda.is_available():
    for call in (
        lambda: init_params(cfg, torch.Generator()),
        lambda: ServingEngine(params, cfg),
        lambda: PagedEngine(params, cfg),
        lambda: ServingEngine(params, cfg, paged=True),
        lambda: SpecEngine(params, cfg, draft=DraftSpec(truncate_layers=1), speculate_k=2),
        lambda: DraftModel(params, cfg, DraftSpec(truncate_layers=1)),
        lambda: train(cfg, TrainHParams(), LoopConfig(steps=1, batch_size=2), tokens),
        lambda: shard_sp_batch((batch[0], batch[1]), ring),
        *[lambda argv=argv: cli_main(argv) for argv in model_cmds.values()],
    ):
        try:
            call()
        except RuntimeError as exc:
            assert "device='cpu'" in str(exc), exc
        else:
            raise AssertionError("an entry point without device= ran without CUDA")
assert not any(m == "jax" or m.startswith("bpe_transformer_tpu.") for m in sys.modules
               if sys.modules[m] is not None), "a JAX module was imported"
print("JAX-FREE OK", len(names))
"""


# The fleet's front-end modules run on hosts with neither torch nor jax.
_TORCH_FREE_SCRIPT = r"""
import importlib, sys

sys.modules["torch"] = None
sys.modules["jax"] = None
for name in ("serving.router", "serving.controller", "telemetry.fleet", "telemetry.slo",
             "telemetry.incident", "telemetry.monitor", "serving.kvpool.migrate",
             "telemetry.report", "telemetry.trace", "telemetry.watchdog",
             "resilience.supervisor", "resilience.signals", "resilience.retention",
             "resilience.rollback", "resilience.integrity", "training.cli"):
    importlib.import_module("bpe_transformer_tpu_torch." + name)
assert not any(m == "bpe_transformer_tpu" or m.startswith("bpe_transformer_tpu.")
               for m in sys.modules)
print("TORCH-FREE OK")
"""


def _tools_match_jax(work):
    """The port's report (text, ``--trace``, ``--compare`` exit codes) and
    ``monitor --once`` give the JAX package's tools' bytes on the stream the
    jax-free run wrote and on the repo's compare fixtures; verify-checkpoint
    gives the same exit codes on a good and a corrupted checkpoint."""
    import contextlib
    import io

    from bpe_transformer_tpu.resilience.integrity import main as jax_verify
    from bpe_transformer_tpu.telemetry.monitor import main as jax_monitor
    from bpe_transformer_tpu.telemetry.report import main as jax_report
    from bpe_transformer_tpu_torch.resilience.integrity import main as port_verify
    from bpe_transformer_tpu_torch.telemetry.monitor import main as port_monitor
    from bpe_transformer_tpu_torch.telemetry.report import main as port_report

    stream = str(work / "m.jsonl")
    fixtures = REPO / "tests" / "fixtures"
    bad = work / "bad.ckpt"
    raw = bytearray((work / "ck" / "step_00000002.ckpt").read_bytes())
    raw[len(raw) // 2] ^= 1
    bad.write_bytes(bytes(raw))
    shutil.copyfile(work / "ck" / "step_00000002.ckpt.crc32.json", work / "bad.ckpt.crc32.json")
    calls = [
        ("report", [stream], 0),
        ("report", [stream, "--trace", "{out}"], 0),
        ("report", [stream, "--compare", stream], 0),
        ("report", [str(fixtures / "compare_regressed.jsonl"), "--compare",
                    str(fixtures / "compare_base.jsonl")], 3),
        ("monitor", [stream, "--once", "--plain"], 0),
        ("verify", [str(work / "ck" / "latest.ckpt")], 0),
        ("verify", [str(bad)], 1),
    ]
    mains = {"report": (jax_report, port_report), "monitor": (jax_monitor, port_monitor),
             "verify": (jax_verify, port_verify)}
    for name, argv, rc_want in calls:
        results = []
        for i, fn in enumerate(mains[name]):
            out = io.StringIO()
            args = [a.replace("{out}", str(work / f"trace{i}.json")) for a in argv]
            with contextlib.redirect_stdout(out):
                rc = fn(args)
            results.append((rc, out.getvalue().replace(str(work / f"trace{i}.json"), "{out}")))
        assert results[0] == results[1], (name, argv, results)
        assert results[0][0] == rc_want and results[0][1], (name, argv, results[0])
        if "--trace" in argv:
            assert (work / "trace0.json").read_bytes() == (work / "trace1.json").read_bytes()


def test_torch_port_is_jax_free_and_card_first(tmp_path):
    # Statically: no import of jax or of the JAX package in the port's
    # sources or in chip_smoke.py.
    banned = re.compile(r"^\s*(import|from)\s+(jax|bpe_transformer_tpu)\b", re.M)
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources if banned.search(p.read_text())]
    assert not offenders, offenders

    # Dynamically: every module imports and a tiny CPU generate runs with
    # jax and the JAX package refused; entry points without device= raise on
    # a host without CUDA.
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE_SCRIPT, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout
    _tools_match_jax(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _TORCH_FREE_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "TORCH-FREE OK" in proc.stdout, proc.stderr[-3000:]

    # chip_smoke.py fails, printing no result, on a host without a card (or
    # in a directory holding nothing else of the repo).
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone / "chip_smoke.py")
    for cwd in (REPO, lone):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
            timeout=300,
        )
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok"' not in proc.stdout, (cwd, proc.stdout)
