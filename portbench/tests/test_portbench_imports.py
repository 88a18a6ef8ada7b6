"""Nothing a run loads is JAX or the JAX package, and the reference takes
nothing of the program."""

import ast
import json
import subprocess
import sys

from portbench import guard
from portbench.tests.helpers import ROOT


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["bpe_transformer_tpu_torch", "bpe_transformer_tpu_torch.x",
                                    "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["jax", "jaxlib.xla", "flax.linen",
                                    "bpe_transformer_tpu.models"]) == [
        "bpe_transformer_tpu.models", "flax.linen", "jax", "jaxlib.xla"]


def test_the_harness_and_every_reader_load_no_jax():
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench import run, spec, guard, calibrate\n"
        "from portbench.runners import train, serve\n"
        "import bpe_transformer_tpu_torch.serving.server, "
        "bpe_transformer_tpu_torch.parallel.train_step, bpe_transformer_tpu_torch.data\n"
        "[spec.metric_reader(p.stem) for p in (spec.HERE / 'metrics').glob('*.py')]\n"
        "print(json.dumps(guard.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("bpe_transformer_tpu_torch", "bpe_transformer_tpu", "jax",
                                   "jaxlib", "flax"), (path.name, n)
