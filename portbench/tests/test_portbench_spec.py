"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import re

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
