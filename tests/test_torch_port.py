"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its entry points run on the card unless the caller asks for the CPU, and
``chip_smoke.py`` refuses to report without a card or without the repo.
The jax-free run also drives the ``train`` CLI on the CPU, resuming from its
own checkpoint."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "bpe_transformer_tpu_torch"

# Runs in a fresh interpreter where importing jax, or anything of the JAX
# package, fails.
_JAX_FREE_SCRIPT = r"""
import dataclasses, importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None

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
        "checkpointing.checkpoint", "data.dataset", "kernels.flash_attention",
        "kernels.swiglu", "models.transformer", "ops.core", "ops.grad", "ops.losses",
        "optim.adamw", "optim.schedule", "resilience.integrity", "training.cli",
        "training.loop", "training.train_step", "tree",
    )
}
assert expected <= set(names), sorted(expected - set(names))

from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG
from bpe_transformer_tpu_torch.models.transformer import init_params
from bpe_transformer_tpu_torch.serving.server import ServingEngine

cfg = dataclasses.replace(
    TS_TEST_CONFIG, vocab_size=64, context_length=16, attention_impl="flash", ffn_impl="pallas",
    decode_attention_impl="pallas",
)
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
with ServingEngine(params, cfg, slots=2, min_bucket=4, device="cpu") as serving:
    result = serving.generate([1, 2, 3], max_new_tokens=3, temperature=0.0)
assert len(result.token_ids) == 3 and result.finish_reason == "length", result

import json, numpy as np
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
assert cli_main(argv + ["--steps", "2"]) == 0
assert cli_main(argv + ["--steps", "3", "--resume", str(work / "ck")]) == 0
summary = json.loads((work / "ck" / "summary.json").read_text())
assert [r["step"] for r in summary["history"]] == [3], summary
assert (work / "ck" / "step_00000003.ckpt.crc32.json").exists()

if not torch.cuda.is_available():
    for call in (
        lambda: init_params(cfg, torch.Generator()),
        lambda: ServingEngine(params, cfg),
        lambda: train(cfg, TrainHParams(), LoopConfig(steps=1, batch_size=2), tokens),
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
