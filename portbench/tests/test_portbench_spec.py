"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.helpers import (ROOT, TINY_MODEL, TINY_TRAIN, copy_benchmark, run_in,
                                     with_pending)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = spec.load_benchmark()
#: As committed, and with the cells held back in ``portbench/pending`` added:
#: both have to follow the contract.
BOTH = pytest.mark.parametrize("bench", [BENCH, with_pending(BENCH)],
                               ids=["committed", "with_pending"])


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(_one_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@BOTH
def test_names_units_and_one_line_fields(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _one_line(w["why"])


@BOTH
def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in spec.end_to_end_for(bench, cell)}
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = {x["name"] for x in spec.end_to_end_for(bench, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer_for(bench, cell)


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in with_pending(BENCH)["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    bench = with_pending(BENCH)
    w = spec.workload(bench, cell)
    conf = spec.config(bench, w["config"])
    assert conf["name"] == w["config"] and conf["reduced"] == next(
        c["reduced"] for c in bench["configs"] if c["name"] == w["config"])
    traffic = spec.traffic(w["traffic"])
    assert traffic["kind"] in ("train", "serve")
    assert spec.limits(cell)
    for m in spec.per_layer_for(bench, cell):
        assert callable(spec.metric_reader(m["name"]))


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"]) and (ROOT / f).is_file()


def test_an_added_traffic_mix_cell_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell,
    its limits and a per-layer metric by added files and entries only, and
    runs them."""
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/gpt2_small_32k.json").read_text())
    (root / "portbench/configs/dummy_model.json").write_text(json.dumps(
        {**conf, "name": "dummy_model", "model": {**conf["model"], **TINY_MODEL}}))
    traffic = json.loads((ROOT / "portbench/traffic/train_b8s1024.json").read_text())
    (root / "portbench/traffic/train_dummy.json").write_text(
        json.dumps({**traffic, **TINY_TRAIN, "batch": 2, "seq": 32}))
    (root / "portbench/limits/dummy-cell.json").write_text(
        (ROOT / "portbench/limits/gpt2s-train-b8s1024.json").read_text())
    (root / "portbench/metrics/steps_seen.train.py").write_text(
        "def read(run):\n    return float(run['ranks'][0]['steps'])\n")
    bench["configs"].append({"name": "dummy_model", "source": "a test",
                             "file": "portbench/configs/dummy_model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy_model",
                               "traffic": "train_dummy", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training step",
                               "moves": "train_tokens_per_s", "workloads": ["dummy-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("dummy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_in(root, "dummy-cell", 7, trace=1)
    assert out["correct"] is True, out["checked"]
    assert out["metrics"]["steps_seen.train"]["value"] >= 1


#: A new architecture, added as a file: today's block with the LM head tied
#: to the token embedding (the program's ``tie_embeddings``), which has no
#: ``lm_head`` leaf.
TIED_REFERENCE = '''"""Today's block with the LM head tied to the token embedding."""

from portbench.reference import model as base
from portbench.reference.model import (  # noqa: F401
    decode_tick_flops, prefill_flops, train_step_flops, whole_batch)


def _tied(params):
    return {**params, "lm_head": params["token_embeddings"]}


def layout(cfg):
    return [leaf for leaf in base.layout(cfg) if leaf[0] != ("lm_head",)]


def logits(params, ids, cfg, precision="fp32"):
    return base.logits(_tied(params), ids, cfg, precision)


def loss(params, x, y, cfg, precision="fp32"):
    return base.loss(_tied(params), x, y, cfg, precision)


def train(params, batches, cfg, hp, precision="fp32", block_rows=None):
    return base.train(params, batches, cfg, hp, precision, block_rows, objective=loss)
'''
#: A per-layer metric of a kernel that ``readers.KERNEL_PATTERNS`` does not
#: know, its kernel-name pattern in its own file.  It refuses a run whose
#: traced stretch brings it no ``calls``.
TIED_ROOFLINE = '''"""The roofline share of the kernels the program launches as
``tied_head``."""

from portbench import readers

PATTERN = r"\\btied_head_kernel\\b"


def read(run):
    traces = readers.traces(run)
    if not traces or any("calls" not in t for t in traces):
        raise RuntimeError("the traced stretch's calls did not reach the reader")

    def least(run, tr):
        return readers.least(run, 2.0e9 * tr["calls"].get("tied_head", 0), 0.0)

    return readers.roofline(run, "tied_head", least, pattern=PATTERN)
'''


def _tree(root) -> dict:
    return {p: p.read_bytes() for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _run_raw(root, cell: str, seed: int) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), "--workload", cell, "--seed",
         str(seed), "--seconds", "1", "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=root,
        env={**os.environ, "OMP_NUM_THREADS": "2"})


def test_an_added_architecture_needs_no_edit(tmp_path):
    """A copy of the benchmark gains an architecture the program runs and
    today's block cannot state (tied embeddings), with its reference,
    configuration, traffic, limits, cell and a kernel's roofline metric,
    by added files and entries only.  Its sound run is correct, its
    half-batch fault is not, and the same configuration without its
    ``architecture`` key gives no correct result."""
    root = copy_benchmark(tmp_path)
    before = _tree(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/gpt2_small_32k.json").read_text())
    tied = {**conf, "name": "tied_model", "architecture": "tied_head",
            "model": {**conf["model"], **TINY_MODEL, "tie_embeddings": True}}
    (root / "portbench/configs/tied_model.json").write_text(json.dumps(tied))
    (root / "portbench/reference/tied_head.py").write_text(TIED_REFERENCE)
    traffic = json.loads((ROOT / "portbench/traffic/train_b8s1024.json").read_text())
    (root / "portbench/traffic/train_tied.json").write_text(json.dumps({**traffic, **TINY_TRAIN}))
    (root / "portbench/limits/tied-cell.json").write_text(
        (ROOT / "portbench/limits/gpt2s-train-b8s1024.json").read_text())
    (root / "portbench/metrics/tied_head_roofline.train.py").write_text(TIED_ROOFLINE)
    bench["configs"].append({"name": "tied_model", "source": "a test",
                             "file": "portbench/configs/tied_model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tied-cell", "config": "tied_model",
                               "traffic": "train_tied", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tied_head_roofline.train", "unit": "%",
                               "better": "higher", "source": "device_trace", "layer": "kernels",
                               "moves": "train_tokens_per_s", "workloads": ["tied-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tied-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    sound = run_in(root, "tied-cell", 2**31 + 41, trace=1)
    assert sound["correct"] is True, sound["checked"]
    # On the CPU no launch counter moves: the reader was called with the
    # stretch's calls and found nothing to read.
    assert "tied_head_roofline.train" not in sound["metrics"]
    broken = run_in(root, "tied-cell", 2**31 + 42, fault="half_batch")
    assert broken["correct"] is False, broken["checked"]

    # The reader takes its kernels by the pattern of its own file.
    reader = spec.metric_reader("tied_head_roofline.train", here=root / "portbench")
    run = {"device_kind": "NVIDIA H100 80GB HBM3", "ranks": [{"trace": {
        "kernels": {"void tied_head_kernel<float>": [4e-3, 2], "flash_fwd_kernel<x>": [1.0, 9]},
        "calls": {"flash_attention_rope": 0, "swiglu": 0, "tied_head": 2}}}]}
    assert reader(run) == pytest.approx(100.0 * 4e9 / 989e12 / 4e-3)
    run["ranks"][0]["trace"]["kernels"] = {"flash_fwd_kernel<x>": [1.0, 9]}
    assert reader(run) is None

    # Nothing that was there before changed.
    after = _tree(root)
    assert {p: after[p] for p in before} == before

    # Without its architecture the configuration runs today's block, whose
    # untied head the program does not have.
    del tied["architecture"]
    (root / "portbench/configs/tied_model.json").write_text(json.dumps(tied))
    out = _run_raw(root, "tied-cell", 2**31 + 43)
    assert out.returncode != 0 or json.loads(
        out.stdout.strip().splitlines()[-1])["correct"] is False, out.stdout[-2000:]
