"""What the benchmark runs, found by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells; each cell
names a configuration, a traffic mix and a chip count.  Everything that
belongs to one of them lives in a file of its own, found by its name:

* a configuration: the ``file`` its ``configs`` entry gives
  (``portbench/configs/<config>.json``);
* a configuration's architecture: ``portbench/reference/<name>.py``, where
  the configuration's file names ``"architecture": "<name>"``, and today's
  block (``portbench/reference/model.py``) where it names none.  The module
  gives the parameter layout and init laws the seeded weights follow, the
  float32 reference the correctness check runs, whether that reference
  takes a step's batch whole, and the model FLOPs the ``mfu`` metrics read
  (``reference/model.py`` says what each is);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a per-layer metric: ``portbench/metrics/<metric>.py``, whose ``read(run)``
  returns the value or None (a kernel's roofline share reads the launches
  its kernel made in the traced stretch, ``calls``, and names its kernels
  by a pattern of its own where ``readers.KERNEL_PATTERNS`` has none);
* a cell's correctness limits: ``portbench/limits/<cell>.json``.

So a later change adds a configuration (of a new architecture too), a mix,
a metric or a cell by adding files and entries, and edits nothing that is
here.  A cell whose files are here but which ``BENCHMARK.json`` does not
run yet keeps the entries it would add there in
``portbench/pending/<cell>.json``, which only the benchmark's tests read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file as run (``model``, ``serving``, ...)."""
    entry = _by_name(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def architecture(conf: dict):
    """The architecture module of a configuration's file (``conf``):
    ``portbench.reference.<name>`` where it names ``"architecture":
    "<name>"``, else ``portbench.reference.model``."""
    name = conf.get("architecture", "model")
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"architecture {name!r} is not the name of a module")
    return importlib.import_module(f"portbench.reference.{name}")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def limits(cell: str, here: Path = HERE) -> dict:
    """``{number: limit}`` of the cell's correctness check."""
    return json.loads((here / "limits" / f"{cell}.json").read_text())["limits"]


def metric_reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _reports(m, cell)]


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
