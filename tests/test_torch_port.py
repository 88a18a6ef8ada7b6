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
the CLI module import with ``torch`` refused too, and so do the packages
whose exports resolve lazily.  The native tokenizer
engine encodes jax-free, an adapter computes, ``profile --device cpu``
writes a stream ``report`` renders, and ``warmup`` and ``profile`` print the
JAX package's keys; ``warmup`` refuses the JAX package's flag combinations
with 2.  No module of the port imports ``regex``.  Name by name, every
export and public function of the JAX package has its counterpart in the
port or stands in the no-counterpart list that ROADMAP.md gives reasons
for, and four of the port's example scripts run jax-free on the CPU."""

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
        "models.moe", "native", "native.engine", "native.gen_unicode_tables", "compat",
        "compat.adapters", "utils.compile_cache", "utils.debug", "optim.sharded",
        "parallel.train_step", "parallel.launch",
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
from bpe_transformer_tpu_torch.training.train_step import TrainHParams, make_train_step

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
# Ulysses on the same stacked ring: the tensors' device, the dense step's loss.
sp_params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
xs, ys = shard_sp_batch((batch[0], batch[1]), ring, device="cpu")
want_loss = float(make_train_step(cfg, TrainHParams())(
    init_params(cfg, torch.Generator().manual_seed(2), device="cpu"),
    adamw_init(sp_params), torch.as_tensor(batch[0]), torch.as_tensor(batch[1]))[2]["loss"])
sp_params, _, metrics = make_sp_train_step(cfg, TrainHParams(), ring, ulysses=True)(
    sp_params, adamw_init(sp_params), xs, ys)
assert abs(float(metrics["loss"]) - want_loss) < 1e-5, (float(metrics["loss"]), want_loss)
# Across cards: the train CLI takes pp, the ep strategies and Ulysses; a
# supervised world needs its mesh (the product of its sizes is the world it
# starts) and its checkpoint directory, or exits 2.
from bpe_transformer_tpu_torch.models.transformer import abstract_params
from bpe_transformer_tpu_torch.parallel import (
    initialize_distributed,
    make_gspmd_train_step,
    make_hybrid_mesh,
    make_mesh,
)
parsed = build_parser().parse_args(["train", "--data", "t.bin", "--parallel", "fsdp_ep",
                                    "--pp-microbatches", "2", "--sp-ulysses"])
assert (parsed.parallel, parsed.pp_microbatches, parsed.sp_ulysses) == ("fsdp_ep", 2, True)
for extra in (["--parallel", "pp", "--supervise", "--mesh", "pp=2"],
              ["--parallel", "dp_ep", "--supervise", "--checkpoint-dir", str(work / "sup")]):
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli_main(["train", "--data", str(work / "tokens.bin"), "--model-config",
                         str(work / "cfg.json"), "--device", "cpu", *extra]) == 2, extra

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
        lambda: initialize_distributed(),
        lambda: make_mesh({"data": 1}),
        lambda: train(cfg, TrainHParams(), LoopConfig(steps=1, batch_size=2, parallel="dp"),
                      tokens),
        lambda: train(cfg, TrainHParams(), LoopConfig(steps=1, batch_size=2, parallel="fsdp"),
                      tokens),
        lambda: make_gspmd_train_step(cfg, TrainHParams(), make_mesh({"data": 1}), "fsdp",
                                      example_params=abstract_params(cfg)),
        lambda: train(cfg, TrainHParams(), LoopConfig(steps=1, batch_size=2, parallel="pp"),
                      tokens),
        lambda: make_gspmd_train_step(cfg, TrainHParams(), make_mesh({"expert": 1}), "ep",
                                      example_params=abstract_params(cfg)),
        lambda: make_hybrid_mesh({"data": 1}),
        *[lambda argv=argv: cli_main(argv) for argv in model_cmds.values()],
    ):
        try:
            call()
        except RuntimeError as exc:
            assert "device='cpu'" in str(exc), exc
        else:
            raise AssertionError("an entry point without device= ran without CUDA")
# The native engine, the adapters, profile and warmup, jax-free.
from bpe_transformer_tpu_torch import compat, native
from bpe_transformer_tpu_torch.tokenization import BPETokenizer
if native.is_available():
    tok = BPETokenizer.from_files(work / "tok300" / "vocab.pkl", work / "tok300" / "merges.pkl",
                                  ["<|endoftext|>"])
    assert tok._native_encoder() is not None
    assert tok.encode("the cat sat<|endoftext|>") == native.NativeBPEEncoder(
        tok._byte_id, tok._pair_rank).encode_part("the cat sat") + [256]
lin = compat.run_linear(4, 3, torch.ones(3, 4), torch.ones(2, 4))
assert lin.shape == (2, 3) and float(lin.sum()) == 24.0
prof = ["profile", "--preset", "ts-test", "--batch", "2", "--measure", "1", "--serve",
        "--device", "cpu", "--json", "--metrics-jsonl", str(work / "profile.jsonl")]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli_main(prof) == 0
summary = json.loads(out.getvalue().strip().splitlines()[-1])
assert {r["name"] for r in summary["programs"]} >= {"train_step", "decode_tick[8]"}, summary
assert all(r["bound"] == "unknown" for r in summary["programs"]), summary
assert abs(summary["compute_frac"] + summary["host_gap_frac"] - 1.0) <= 1e-3, summary
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli_main(["report", str(work / "profile.jsonl")]) == 0
assert "== attribution (1 records" in out.getvalue(), out.getvalue()
warm = {}
for mode, extra in (("serve", ["--paged", "--kv-dtype", "int8", "--fused-sampling"]),
                    ("train", ["--train"])):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(["warmup", "--compile-cache", str(work / "cc"), "--preset", "ts-test",
                         "--device", "cpu", *extra]) == 0, mode
    warm[mode] = json.loads(out.getvalue())
    assert warm[mode]["programs_compiled"] == warm[mode]["cache_hits"] == 0, warm
print("WARMUP", json.dumps(warm))
print("PROFILE", json.dumps(summary))
assert not any(m == "jax" or m.startswith("bpe_transformer_tpu.") for m in sys.modules
               if sys.modules[m] is not None), "a JAX module was imported"
print("JAX-FREE OK", len(names))
"""

#: The JSON keys the JAX package's ``warmup`` prints (``cmd_warmup`` and
#: ``_warmup_train`` in its ``training/cli.py``) and its ``profile --json``
#: summary with a measured split (``cmd_profile``).
_JAX_WARMUP_KEYS = {
    "serve": {"programs_compiled", "buckets", "role", "engine", "speculate",
              "decode_attention", "kv_dtypes", "weight_dtypes", "fused_sampling",
              "cache_dir", "cache_hits"},
    "train": {"mode", "programs_compiled", "batch_size", "grad_accum_steps", "inner_steps",
              "health_stats", "remat_policy", "scan_layers", "grads_dtype", "cache_dir",
              "cache_hits"},
}
_JAX_PROFILE_KEYS = {
    "metric", "config", "batch", "platform", "device_kind", "programs", "wall_step_s",
    "device_step_s", "compute_frac", "collective_frac", "host_gap_frac",
    "train_peak_hbm_bytes", "remat_policy", "grads_dtype", "scan_layers",
}

#: ``warmup`` flag combinations that both packages refuse with exit code 2
#: before anything is built.
_WARMUP_REFUSED = (
    ["--train", "--paged"], ["--train", "--role", "decode"], ["--train", "--speculate", "2"],
    ["--train", "--grad-accum-steps", "2", "--inner-steps", "2"],
    ["--train", "--batch-size", "3", "--grad-accum-steps", "2"],
    ["--role", "prefill"], ["--paged", "--role", "prefill", "--speculate", "2"],
    ["--speculate", "2"], ["--paged", "--speculate", "2"], ["--draft-config", "d.json"],
)


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
# The package exports resolve lazily: the packages and their torch-free
# names import without torch.
import bpe_transformer_tpu_torch as port
from bpe_transformer_tpu_torch import resilience, serving, telemetry, training
from bpe_transformer_tpu_torch.serving import kvpool
assert port.__version__ == "0.1.0" and port.BPETokenizer and port.train_bpe
assert serving.Router and serving.FifoScheduler and serving.make_router_http_server
assert kvpool.payload_to_bytes and kvpool.synthetic_decode_payload
assert resilience.supervise and resilience.verify_checkpoint and resilience.EXIT_PREEMPTED
assert telemetry.validate_record and telemetry.run_manifest
assert not any(m == "bpe_transformer_tpu" or m.startswith("bpe_transformer_tpu.")
               for m in sys.modules)
print("TORCH-FREE OK")
"""

#: Public names of the JAX package that the port gives no counterpart,
#: as ``<module path>.<name>`` of the module that defines them (a package
#: re-exporting one needs no entry of its own); ``ROADMAP.md`` (queue A,
#: "Names without a counterpart") gives each its reason and must list
#: exactly these.
_NO_COUNTERPART = {
    "compat.ensure_shard_map",
    "parallel.mesh.batch_sharding",
    "parallel.mesh.replicated",
    "parallel.sharding.param_shardings",
    "parallel.sharding.zero1_opt_shardings",
    "optim.schedule.cosine_schedule_jax",
    "ops.quant.quant_linear_xla",
    "serving.engine.gumbel_rows",
    "telemetry.dynamics.tensor_path",
    "settings.PAT",
    "settings.ENCODING_STD",
    "training.cli.cmd_control",
    "training.cli.cmd_fleet",
    "training.cli.cmd_incident",
    "training.cli.cmd_monitor",
    "training.cli.cmd_report",
    "training.cli.cmd_route",
    "training.cli.cmd_verify_checkpoint",
}

#: The example scripts run here (``--device cpu`` where they take one, a
#: tiny corpus), with the closing lines ``tests/test_examples.py`` asserts
#: for their JAX twins.
_CPU_EXAMPLES = (
    ("1_pretokenization.py", ["--workers", "2"], ("paths agree",)),
    ("2_train_bpe.py", ["--vocab-size", "300"], ("longest learned token",)),
    ("3_encode_decode.py", [], ("roundtrip OK",)),
    ("8_kv_cache_decode.py", ["--new-tokens", "8", "--device", "cpu"],
     ("decode demo OK", "GQA")),
)

# Runs one example script as ``__main__`` with jax, regex and the JAX
# package refused.
_EXAMPLE_RUNNER = r"""
import importlib.abc, os, runpy, sys

sys.modules["jax"] = None
sys.modules["regex"] = None

class RefuseJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "bpe_transformer_tpu" or name.startswith("bpe_transformer_tpu."):
            raise ImportError(f"the example imported {name}")
        return None

sys.meta_path.insert(0, RefuseJaxPackage())
script = sys.argv[1]
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(script))
runpy.run_path(script, run_name="__main__")
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


def _warmup_and_profile_match_jax(stdout: str):
    """The jax-free run's ``warmup`` and ``profile --json`` lines carry the
    JAX package's keys; the flag combinations the JAX ``warmup`` refuses
    exit with 2 in both packages."""
    import contextlib
    import io
    import json

    from bpe_transformer_tpu.training.cli import main as jax_main
    from bpe_transformer_tpu_torch.training.cli import main as port_main

    lines = dict(line.split(" ", 1) for line in stdout.splitlines()
                 if line.startswith(("WARMUP ", "PROFILE ")))
    warm = json.loads(lines["WARMUP"])
    for mode, keys in _JAX_WARMUP_KEYS.items():
        assert keys <= set(warm[mode]), (mode, keys - set(warm[mode]))
    assert _JAX_PROFILE_KEYS <= set(json.loads(lines["PROFILE"]))
    for extra in _WARMUP_REFUSED:
        argv = ["warmup", "--compile-cache", "unused", "--preset", "ts-test", *extra]
        with contextlib.redirect_stderr(io.StringIO()):
            assert jax_main(argv) == 2, extra
            assert port_main(argv + ["--device", "cpu"]) == 2, extra


# One gloo rank of the GSPMD world: the port's sharded steps, with JAX and
# the JAX package refused.
_GSPMD_RANK = r"""
import json, os, pickle, sys
sys.modules["jax"] = None
sys.modules["bpe_transformer_tpu"] = None
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from bpe_transformer_tpu_torch.models import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import abstract_params, params_from_jax
from bpe_transformer_tpu_torch.parallel import (
    gather_params, make_gspmd_train_step, make_hybrid_mesh, make_mesh, shard_batch)
from bpe_transformer_tpu_torch.telemetry.dynamics import flatten_dynamics
from bpe_transformer_tpu_torch.telemetry.health import flatten_health
from bpe_transformer_tpu_torch.training.loop import _fetch
from bpe_transformer_tpu_torch.training.train_step import TrainHParams
from bpe_transformer_tpu_torch.tree import tree_leaves
work = Path(sys.argv[1])
spec = json.loads((work / "spec.json").read_text())
inits = pickle.loads((work / "inits.pkl").read_bytes())
batch = np.load(work / "batch.npz")
out = {}
for name, cfg_kw, strategy, axes, kw in spec["cases"]:
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh(axes, device="cpu")
    step = make_gspmd_train_step(cfg, TrainHParams(**spec["hparams"]), mesh, strategy,
                                 example_params=abstract_params(cfg), **kw)
    lay = step.layout
    params, opt = lay.shard(params_from_jax(inits[name], "cpu")), lay.init_opt_state()
    losses = []
    for x, y in spec["calls"][name]:
        x, y = np.asarray(x), np.asarray(y)
        params, opt, m = step(params, opt, *shard_batch((x, y), mesh, stacked=x.ndim == 3))
        m = _fetch(m)
        losses.append(m["loss"])
    moments = [gather_params(t, mesh, specs=lay.moment_specs) for t in (opt.m, opt.v)]
    out[name] = {"losses": losses, "grad_norm": m["grad_norm"], "step": int(opt.step),
                 "params": [t.numpy() for t in tree_leaves(lay.gather(params))],
                 "opt": [t.numpy() for t in tree_leaves(moments)],
                 "block_shapes": [tuple(t.shape) for t in tree_leaves(opt.m)]}
    if kw.get("health"):
        out[name]["health"] = flatten_health(m["health"])
        out[name]["dynamics"] = flatten_dynamics(m["dynamics"])
    if name == "fsdp_ep zero1":
        # Each distinct block written by the lowest rank that holds it.
        from bpe_transformer_tpu_torch.checkpointing.checkpoint import save_checkpoint_sharded
        save_checkpoint_sharded(work / "port_ep_dir", params=params, opt_state=opt,
                                iteration=int(opt.step), layout=lay)
    if name == "dp_tp zero1":
        # The GSPMD probe: off the card no trace splits the collectives off.
        from bpe_transformer_tpu_torch.telemetry.attribution import StepProbe
        probe = StepProbe(cfg, TrainHParams(**spec["hparams"]), batch_size=4, mesh=mesh,
                          parallel=strategy, opt_sharding="zero1", iters=1, device="cpu")
        out["probe"] = probe.attribution_record(params, opt, step=2, wall_step_s=1.0, t=0.0)
# The hybrid mesh: the degenerate case, the JAX function's errors, and the
# rank order with a dcn axis over two hosts of two ranks.
out["hybrid"] = {"plain": make_hybrid_mesh({"data": 2, "model": 2}, device="cpu").shape}
for ici, dcn in (({"data": 4}, {"model": 2}), ({"data": 4}, {"data": 2})):
    try:
        make_hybrid_mesh(ici, dcn, device="cpu")
    except ValueError as exc:
        out["hybrid"][json.dumps([ici, dcn])] = str(exc)
os.environ["LOCAL_WORLD_SIZE"] = "2"
hm = make_hybrid_mesh({"data": 2, "model": 1}, {"model": 2}, device="cpu")
grids = [None] * 4
torch.distributed.all_gather_object(grids, (hm.shape, hm.grid.tolist(), hm.coords))
out["hybrid"]["grids"] = grids
if mesh.rank == 0:
    (work / "gspmd_out.pkl").write_bytes(pickle.dumps(out))
torch.distributed.destroy_process_group()
"""


def _gspmd_matches_jax(tmp_path):
    """Slice 10c's specs and steps held against the JAX package's.  The
    specs need no process: the port's ``param_specs`` and
    ``zero1_opt_specs`` (abstract leaves on the ``meta`` device) equal
    JAX's (``eval_shape`` leaves on conftest's 8 CPU devices) for every
    leaf, under ``dp``, ``fsdp``, ``tp``, ``fsdp_tp`` and ``dp_tp`` on
    ``{"data": 8}``, ``{"data": 4, "model": 2}`` and ``{"data": 2,
    "model": 4}``, for the tiny test config, a GQA config whose kv heads do
    not divide ``model``, one whose head count does not, TINYSTORIES_MOE,
    and GPT2_SMALL_32K's and GPT2_MEDIUM's shapes, and under ``ep``,
    ``dp_ep`` and ``fsdp_ep`` on ``{"expert": 8}``, ``{"data": 4, "expert":
    2}`` and ``{"data": 2, "expert": 4}`` too (an MoE leaf's expert dim
    split, FSDP after it).  The steps: a gloo world of 4 ranks (``parallel/launch.py``, jax
    refused) runs ``make_gspmd_train_step`` against JAX's on the same mesh
    shape (4 of conftest's devices), float32: fsdp on ``data=4``, tp on
    ``model=4``, fsdp_tp, dp_tp with ZeRO-1 (the moments split over
    ``data`` on top of ``model``), accumulation and inner steps under
    fsdp_tp, health and dynamics under fsdp_tp with ZeRO-1, the GQA and
    odd-head configs under tp (their attention gathered over ``model``),
    a TINYSTORIES_MOE-shaped tiny MoE under fsdp (the tokens of every
    data rank routed as one group, as XLA routes the global batch), and
    expert parallelism on it: ep on ``{"expert": 4}``, dp_ep (the gather
    dispatch) and fsdp_ep and dp_ep with ZeRO-1 on ``{"data": 2, "expert":
    2}`` (the router gathered, each rank's experts on their slots, the
    outputs gathered, each gather's gradient this rank's block):
    losses, grad norms, every weight and every moment within 2e-5 (the JAX
    ZeRO-1 test's tolerance), the taps' records within ``_same_flat``'s.
    The world also builds hybrid meshes: the degenerate one, JAX's two
    errors word for word, and the rank grid with a dcn axis under a faked
    ``LOCAL_WORLD_SIZE``.  The fsdp_ep rank state's directory is read by
    JAX's ``load_checkpoint_sharded`` as JAX's own step, and JAX's by the
    port."""
    import dataclasses
    import json
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from jax.sharding import PartitionSpec

    from bpe_transformer_tpu.checkpointing import load_checkpoint_sharded as jax_load_sharded
    from bpe_transformer_tpu.checkpointing import save_checkpoint_sharded as jax_save_sharded
    from bpe_transformer_tpu.models import init_params as jax_init_params
    from bpe_transformer_tpu.models.config import ModelConfig as JaxModelConfig
    from bpe_transformer_tpu.optim import AdamWState as JaxAdamWState
    from bpe_transformer_tpu.optim import adamw_init as jax_adamw_init
    from bpe_transformer_tpu.parallel import make_hybrid_mesh as jax_make_hybrid_mesh
    from bpe_transformer_tpu.parallel import make_mesh as jax_make_mesh
    from bpe_transformer_tpu.parallel import sharding as jax_sharding
    from bpe_transformer_tpu.parallel.train_step import make_gspmd_train_step as jax_gspmd_step
    from bpe_transformer_tpu.parallel.train_step import shard_batch as jax_shard_batch
    from bpe_transformer_tpu.telemetry import dynamics as jax_dynamics
    from bpe_transformer_tpu.telemetry import health as jax_health
    from bpe_transformer_tpu.telemetry.attribution import StepProbe as JaxStepProbe
    from bpe_transformer_tpu.training.train_step import TrainHParams as JaxTrainHParams
    from bpe_transformer_tpu_torch.models import (
        GPT2_MEDIUM,
        GPT2_SMALL_32K,
        TINYSTORIES_MOE,
        TS_TEST_CONFIG,
        ModelConfig,
    )
    from bpe_transformer_tpu_torch.models.transformer import abstract_params
    from bpe_transformer_tpu_torch.parallel import launch
    from bpe_transformer_tpu_torch.parallel.sharding import (
        param_specs,
        spec_leaves,
        zero1_opt_specs,
    )

    def _same_flat(got: dict, want: dict, what: str) -> None:
        # test_torch_training's rule: the same keys in order, values within
        # 1e-5 relative (attention entropy 1e-4 absolute), paths equal.
        assert list(got) == list(want), (what, list(got), list(want))
        for key, w in want.items():
            if isinstance(w, str):
                assert got[key] == w, (what, key)
            elif key.startswith("attn_entropy/"):
                np.testing.assert_allclose(got[key], w, atol=1e-4, rtol=0, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-7, equal_nan=True,
                                           err_msg=f"{what} {key}")

    def jax_cfg(cfg):
        return JaxModelConfig(**dataclasses.asdict(cfg))

    tiny = dataclasses.replace(TS_TEST_CONFIG, vocab_size=256, num_layers=2)
    gqa = dataclasses.replace(tiny, num_kv_heads=2)
    odd = dataclasses.replace(tiny, d_model=96, num_heads=3)
    moe = dataclasses.replace(tiny, ffn_type="moe", n_experts=8, router_top_k=2,
                              capacity_factor=1.25)

    # The specs, leaf for leaf.
    meshes = {"8": {"data": 8}, "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
              "e8": {"expert": 8}, "4xe2": {"data": 4, "expert": 2},
              "2xe4": {"data": 2, "expert": 4}}
    jax_meshes = {k: jax_make_mesh(axes) for k, axes in meshes.items()}
    for cfg in (tiny, gqa, odd, TINYSTORIES_MOE, GPT2_SMALL_32K, GPT2_MEDIUM):
        full = abstract_params(cfg)
        shapes = jax.eval_shape(lambda c=jax_cfg(cfg): jax_init_params(jax.random.PRNGKey(0), c))
        for strategy in ("dp", "fsdp", "tp", "fsdp_tp", "dp_tp", "ep", "dp_ep", "fsdp_ep"):
            for key, axes in meshes.items():
                for port_fn, jax_fn in ((param_specs, jax_sharding.param_specs),
                                        (zero1_opt_specs, jax_sharding.zero1_opt_specs)):
                    got = spec_leaves(full, port_fn(full, axes, strategy))
                    want = jax.tree_util.tree_flatten(
                        jax_fn(shapes, jax_meshes[key], strategy),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
                    want = [tuple(w) + (None,) * (len(g) - len(w)) for g, w in zip(got, want)]
                    assert got == want, (cfg.d_model, cfg.ffn_type, strategy, key, port_fn)

    # The steps, world 4 against JAX on 4 devices.
    hp = dict(warmup_iters=1, cosine_cycle_iters=10)
    S, B = tiny.context_length, 4
    rng = np.random.default_rng(17)
    x, y = (rng.integers(0, tiny.vocab_size, size=(2, B, S)) for _ in range(2))
    grid = {"data": 2, "model": 2}
    cases = [
        ("fsdp", tiny, "fsdp", {"data": 4}, {}),
        ("tp", tiny, "tp", {"model": 4}, {}),
        ("fsdp_tp", tiny, "fsdp_tp", grid, {}),
        ("dp_tp zero1", tiny, "dp_tp", grid, {"opt_sharding": "zero1"}),
        ("fsdp_tp accum", tiny, "fsdp_tp", grid, {"accum_steps": 2}),
        ("fsdp_tp inner", tiny, "fsdp_tp", grid, {"inner_steps": 2}),
        ("fsdp_tp zero1 taps", tiny, "fsdp_tp", grid,
         {"opt_sharding": "zero1", "health": True, "dynamics": True}),
        ("tp gqa", gqa, "tp", {"model": 4}, {}),
        ("tp odd heads", odd, "tp", {"model": 4}, {}),
        ("fsdp moe", moe, "fsdp", {"data": 4}, {}),
        ("ep", moe, "ep", {"expert": 4}, {}),
        ("dp_ep gather", dataclasses.replace(moe, moe_dispatch="gather"), "dp_ep",
         {"data": 2, "expert": 2}, {}),
        ("fsdp_ep zero1", moe, "fsdp_ep", {"data": 2, "expert": 2}, {"opt_sharding": "zero1"}),
        ("dp_ep zero1", moe, "dp_ep", {"data": 2, "expert": 2}, {"opt_sharding": "zero1"}),
    ]

    def calls_of(kw):
        if kw.get("inner_steps"):
            return [(x, y)]
        if kw.get("accum_steps"):
            return [(a.reshape(2, B // 2, S), b.reshape(2, B // 2, S)) for a, b in zip(x, y)]
        return list(zip(x, y))[:1 if kw.get("health") else None]

    inits = {name: jax.device_get(jax_init_params(jax.random.PRNGKey(17), jax_cfg(cfg)))
             for name, cfg, *_ in cases}
    work = tmp_path / "gspmd"
    work.mkdir()
    (work / "inits.pkl").write_bytes(pickle.dumps(inits))
    np.savez(work / "batch.npz", x=x, y=y)
    (work / "spec.json").write_text(json.dumps({
        "hparams": hp,
        "cases": [(name, dataclasses.asdict(cfg), strategy, axes, kw)
                  for name, cfg, strategy, axes, kw in cases],
        "calls": {name: [(a.tolist(), b.tolist()) for a, b in calls_of(kw)]
                  for name, _, _, _, kw in cases},
    }))
    (work / "rank.py").write_text(_GSPMD_RANK)
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(launch, [work / "rank.py", work], 4, env=env, timeout=400)
        want = {}
        for name, cfg, strategy, axes, kw in cases:
            mesh = jax_make_mesh(axes, devices=jax.devices()[:4])
            p = jax_sharding.shard_params(jax.tree_util.tree_map(jnp.asarray, inits[name]), mesh,
                                          strategy)
            opt = jax_adamw_init(p)
            if kw.get("opt_sharding"):
                sh = jax_sharding.zero1_opt_shardings(p, mesh, strategy)
                opt = JaxAdamWState(step=opt.step, m=jax.device_put(opt.m, sh),
                                    v=jax.device_put(opt.v, sh))
            step = jax_gspmd_step(jax_cfg(cfg), JaxTrainHParams(**hp), mesh, strategy,
                                  example_params=p, **kw)
            losses = []
            for a, b in calls_of(kw):
                p, opt, m = step(p, opt, *jax_shard_batch((jnp.asarray(a), jnp.asarray(b)),
                                                          mesh, stacked=a.ndim == 3))
                m = jax.device_get(m)
                losses.append(float(m["loss"]))
            want[name] = {"losses": losses, "grad_norm": float(m["grad_norm"]),
                          "step": int(opt.step),
                          "params": jax.tree_util.tree_leaves(jax.device_get(p)),
                          "opt": jax.tree_util.tree_leaves(jax.device_get((opt.m, opt.v))),
                          "block_shapes": [tuple(a.addressable_shards[0].data.shape)
                                           for a in jax.tree_util.tree_leaves(opt.m)]}
            if kw.get("health"):
                want[name]["health"] = jax_health.flatten_health(m["health"])
                want[name]["dynamics"] = jax_dynamics.flatten_dynamics(m["dynamics"])
            if name == "fsdp_ep zero1":
                jax_save_sharded(work / "jax_ep_dir", params=p, opt_state=opt,
                                 iteration=int(opt.step))
                jax_ep_state = jax.tree_util.tree_leaves(jax.device_get((p, opt)))
        jax_errors = {}
        for ici, dcn in (({"data": 4}, {"model": 2}), ({"data": 4}, {"data": 2})):
            with pytest.raises(ValueError) as info:
                jax_make_hybrid_mesh(ici, dcn, devices=jax.devices()[:4])
            jax_errors[json.dumps([ici, dcn])] = str(info.value)
        plain = jax_make_hybrid_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
        mesh = jax_make_mesh(grid, devices=jax.devices()[:4])
        p = jax_sharding.shard_params(jax.tree_util.tree_map(jnp.asarray, inits["fsdp"]), mesh,
                                      "dp_tp")
        jax_record = JaxStepProbe(jax_cfg(tiny), JaxTrainHParams(**hp), batch_size=4, iters=1,
                                  mesh=mesh, parallel="dp_tp").attribution_record(
            p, jax_adamw_init(p), step=2, wall_step_s=1.0, t=0.0)
        world.result()
    got = pickle.loads((work / "gspmd_out.pkl").read_bytes())
    for name, *_ in cases:
        g, w = got[name], want[name]
        np.testing.assert_allclose(g["losses"], w["losses"], atol=2e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], atol=2e-5, rtol=0,
                                   err_msg=name)
        assert g["step"] == w["step"] and g["block_shapes"] == w["block_shapes"], name
        for a, b in zip(g["params"] + g["opt"], w["params"] + w["opt"], strict=True):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=0, err_msg=name)
        if "health" in w:
            _same_flat(g["health"], w["health"], f"{name} health")
            _same_flat(g["dynamics"], w["dynamics"], f"{name} dynamics")
    # fsdp_ep's directories, both ways.
    ours = jax_load_sharded(work / "port_ep_dir")
    assert ours["iteration"] == 2
    for a, b in zip(jax.tree_util.tree_leaves((ours["params"], ours["opt_state"])),
                    jax_ep_state, strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=0, err_msg="ep dir")
    from bpe_transformer_tpu_torch.checkpointing.checkpoint import load_checkpoint_sharded
    from bpe_transformer_tpu_torch.tree import tree_leaves as port_leaves

    theirs = load_checkpoint_sharded(work / "jax_ep_dir")
    for a, b in zip(port_leaves((theirs["params"], theirs["opt_state"])), jax_ep_state,
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    record = got["probe"]
    assert set(record) == set(jax_record) | {"probe_wall_step_s", "device_time_from"}, (
        set(record) ^ set(jax_record))
    assert record["collective_frac"] is None and jax_record["collective_frac"] is None
    hybrid = got["hybrid"]
    assert hybrid["plain"] == dict(plain.shape) == {"data": 2, "model": 2}
    assert {k: v for k, v in hybrid.items() if k.startswith("[")} == jax_errors
    # ici data=2 inside a host of two ranks, dcn model=2 across the hosts:
    # rank = host * 2 + data index, host = the model index.
    grids = hybrid["grids"]
    assert all(list(g[:2]) == [{"data": 2, "model": 2}, [[0, 2], [1, 3]]] for g in grids), grids
    assert [g[2] for g in grids] == [{"data": r % 2, "model": r // 2} for r in range(4)]


def _roadmap_no_counterpart() -> set:
    """The names of ROADMAP.md's "Names without a counterpart" list."""
    lines = (REPO / "ROADMAP.md").read_text().splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("**Names without a counterpart"))
    names = set()
    for ln in lines[start + 1:]:
        if not ln.strip():
            break
        if ln.startswith("- `"):
            names.update(re.findall(r"`([\w.]+)`", ln.split(":", 1)[0]))
    return names


def _public_surface_matches_jax(tmp_path):
    """Name by name: every ``__all__`` of the JAX package's ``__init__``s
    (``kernels/pallas`` against the port's ``kernels``) and every public
    function and class of its modules resolves in the port's counterpart,
    or stands in ``_NO_COUNTERPART``, whose names the JAX package has, the
    port has not, and ROADMAP.md lists.  Then the example scripts of
    ``_CPU_EXAMPLES`` run on the CPU with jax refused and end with their
    closing lines."""
    import ast
    import importlib

    jax_root = REPO / "bpe_transformer_tpu"
    resolved = 0
    for init in sorted(jax_root.rglob("__init__.py")):
        rel = init.parent.relative_to(jax_root).parts
        tree = ast.parse(init.read_text())
        exported = [ast.literal_eval(e) for n in tree.body if isinstance(n, ast.Assign)
                    and any(getattr(t, "id", None) == "__all__" for t in n.targets)
                    for e in n.value.elts if isinstance(e, ast.Constant)]
        port_rel = ("kernels",) if rel == ("kernels", "pallas") else rel
        module = importlib.import_module(".".join(("bpe_transformer_tpu_torch", *port_rel)))
        prefix = "".join(part + "." for part in rel)
        for name in exported:
            # A re-export of a name without a counterpart in a submodule.
            if any(q.startswith(prefix) and q.endswith("." + name) for q in _NO_COUNTERPART):
                assert not hasattr(module, name), (port_rel, name)
                continue
            assert hasattr(module, name), f"{module.__name__} lacks {name}"
            resolved += 1
    assert resolved == 197, resolved  # of 203: six have no counterpart
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).with_suffix("").parts
        if rel[0] == "kernels" or rel[-1] == "__init__" or rel == ("compat", "shardmap"):
            continue
        port_file = PORT.joinpath(*rel).with_suffix(".py")
        assert port_file.exists(), rel
        ours = ast.parse(port_file.read_text())
        have = {n.name for n in ours.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        have |= {t.id for n in ours.body if isinstance(n, (ast.Assign, ast.AnnAssign))
                 for t in (n.targets if isinstance(n, ast.Assign) else [n.target])
                 if isinstance(t, ast.Name)}
        have |= {a.asname or a.name for n in ours.body
                 if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name[0] != "_":
                qualified = ".".join((*rel, node.name))
                assert (node.name in have) != (qualified in _NO_COUNTERPART), qualified
    for qualified in _NO_COUNTERPART:
        mod, name = qualified.rsplit(".", 1)
        jax_mod = importlib.import_module(f"bpe_transformer_tpu.{mod}")
        assert hasattr(jax_mod, name), qualified
        assert not hasattr(importlib.import_module(f"bpe_transformer_tpu_torch.{mod}"), name)
    assert _roadmap_no_counterpart() == _NO_COUNTERPART, (
        _roadmap_no_counterpart() ^ _NO_COUNTERPART)

    examples = PORT / "examples"
    assert sorted(p.name for p in examples.glob("[0-9]*.py")) == sorted(
        p.name for p in (REPO / "examples").glob("[0-9]*.py"))
    sample = tmp_path / "examples_corpus.txt"
    sample.write_text("<|endoftext|>".join(
        f"Once upon a time {i}, there was a pretty girl named Lily. She liked her {i % 7} "
        f"red balls!" for i in range(300)), encoding="utf-8")
    procs = []
    for script, args, closing in _CPU_EXAMPLES:
        work = tmp_path / script.split("_")[0]
        work.mkdir()
        procs.append((script, closing, work, subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE_RUNNER, str(examples / script), "--input",
             str(sample), *args], cwd=work, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    for script, closing, work, proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (script, out[-2000:], err[-3000:])
        assert all(line in out for line in closing), (script, out[-2000:])
    assert (tmp_path / "2" / "bpe_artifacts" / "vocab.pkl").exists()


def test_torch_port_is_jax_free_and_card_first(tmp_path):
    # Statically: no import of jax or of the JAX package in the port's
    # sources (its example scripts included) or in chip_smoke.py.
    banned = re.compile(r"^\s*(import|from)\s+(jax|bpe_transformer_tpu|regex)\b", re.M)
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len([p for p in sources if p.parent.name == "examples"]) == 11, sources
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
    _warmup_and_profile_match_jax(proc.stdout)
    _gspmd_matches_jax(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _TORCH_FREE_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "TORCH-FREE OK" in proc.stdout, proc.stderr[-3000:]
    _public_surface_matches_jax(tmp_path)

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
