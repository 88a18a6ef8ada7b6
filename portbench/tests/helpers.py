"""Whole runs of the benchmark on the CPU at a tiny size, for its tests.

``run_cell`` copies the benchmark into a temporary directory, adds to the
copy a tiny configuration and a tiny traffic mix for the cell (its widths
and sizes cut down, every other setting as the cell has it) and points the
cell's entry in the copy's ``BENCHMARK.json`` at them, so that the cell
keeps its name and its limits file; then it runs ``portbench/run.py`` there
on the CPU.  The files of the benchmark itself are not changed.

A cell held back from ``BENCHMARK.json`` keeps the entries it would add
there in ``portbench/pending/<cell>.json``; the tests add them to their
copy, as a later change adds them to the benchmark."""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PENDING = ROOT / "portbench" / "pending"


def with_pending(bench: dict) -> dict:
    """``bench`` with the entries of every held-back cell added."""
    bench = json.loads(json.dumps(bench))
    for path in sorted(PENDING.glob("*.json")):
        held = json.loads(path.read_text())
        for group in ("workloads", "end_to_end", "per_layer"):
            bench[group] += held[group]
    return bench

TINY_MODEL = {"vocab_size": 512, "context_length": 128, "d_model": 64, "num_layers": 2,
              "num_heads": 4, "d_ff": 128}
TINY_MOE = {**TINY_MODEL, "d_ff": 96}
TINY_TRAIN = {"batch": 4, "seq": 64, "pool_tokens": 20000, "ref_block_rows": 2,
              "profile_steps": 2}
TINY_DP = {**TINY_TRAIN, "world": 2, "batch": 2}
TINY_SERVE = {"slots": 8, "clients": 8, "max_queue": 16, "pool": 256, "strata": 16,
              "warm_s": 1, "trace_ticks": 4,
              "prompt": {"median": 24, "sigma": 0.6, "min": 4, "max": 64},
              "output": {"median": 16, "sigma": 0.5, "min": 4, "max": 48}}


def tiny(cell: str) -> tuple[dict, dict]:
    """``(model widths, traffic sizes)`` that replace the cell's own."""
    if "serve" in cell:
        return TINY_MODEL, TINY_SERVE
    model = TINY_MOE if cell.startswith("tsmoe") else TINY_MODEL
    return model, TINY_DP if "dp4" in cell else TINY_TRAIN


def copy_benchmark(dest: Path) -> Path:
    """The benchmark's files (its tests left out) and ``BENCHMARK.json``
    copied into ``dest``, the program linked beside them."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "bpe_transformer_tpu_torch").symlink_to(ROOT / "bpe_transformer_tpu_torch")
    return dest


def add_tiny_twin(root: Path, cell: str) -> None:
    """Points ``cell`` in ``root``'s copy at a tiny configuration and
    traffic mix, written there as new files."""
    bench = with_pending(json.loads((root / "BENCHMARK.json").read_text()))
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    model, sizes = tiny(cell)
    conf = json.loads((root / config["file"]).read_text())
    name = f"tiny_{cell.replace('-', '_')}"
    conf = {**conf, "name": name, "model": {**conf["model"], **model}}
    (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "portbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps({**traffic, **sizes}))
    bench["configs"].append({**config, "name": name, "file": f"portbench/configs/{name}.json"})
    entry.update(config=name, traffic=name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def run_in(root: Path, cell: str, seed: int, seconds: float = 1.0, trace: int = 0,
           fault=None) -> dict:
    """One run of ``root``'s ``portbench/run.py`` on the CPU in a
    subprocess; returns the last line of standard output as JSON."""
    cmd = [sys.executable, str(root / "portbench" / "run.py"), "--workload", cell, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu"]
    if fault:
        cmd += ["--fault", fault]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def run_cell(cell: str, seed: int, seconds: float = 1.0, trace: int = 0, fault=None) -> dict:
    """One run of ``cell`` at the tiny size, in a temporary copy."""
    with tempfile.TemporaryDirectory() as tmp:
        root = copy_benchmark(Path(tmp))
        add_tiny_twin(root, cell)
        return run_in(root, cell, seed, seconds, trace, fault)


def calibrate_in(root: Path, cell: str, seeds: str, *args: str) -> list[dict]:
    """``root``'s ``portbench/calibrate.py`` on the CPU; one JSON object a
    seed."""
    cmd = [sys.executable, str(root / "portbench" / "calibrate.py"), "--workload", cell,
           "--seeds", seeds, "--device", "cpu", *args]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]
