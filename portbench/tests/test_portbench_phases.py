"""The step-phase reading (``portbench/phases.py``) and the per-layer
metrics in ``BENCHMARK.json`` that read it, from the phases the training
runner keeps of its host-operator stretch.  On the CPU at a tiny size: the
program's ``bpt.*`` ranges read from a traced step, the benchmark's reading
held to the program's own (``phase_table``) on that trace and on a
synthetic one with kernels and launches, each reader over one rank and over
two, and whole traced runs that report them."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import phases, spec, weights
from portbench.runners import train
from portbench.tests.helpers import TINY_MODEL, TINY_MOE, run_cell, tiny

PHASE_METRICS = ("step_host_ms.train", "forward_host_ms.train", "backward_host_ms.train",
                 "optimizer_host_ms.train", "optimizer_launches.train", "moe_host_ms.train")
ENTRIES = [m for m in spec.load_benchmark()["per_layer"] if m["name"] in PHASE_METRICS]
A, C, D = "gpt2s-train-b8s1024", "tsmoe-train-b16s512", "gpt2s-train-dp4-zero1"
STEP = ["forward", "backward", "grad_reduce", "clip", "adamw"]
MOE = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def _traced(cell: str, steps: int = 2):
    """The profiler of ``steps`` updates of the cell's step at the tiny
    size, recorded with host operators on the CPU."""
    bench = spec.load_benchmark()
    conf = spec.config(bench, spec.workload(bench, cell)["config"])
    model = {**conf["model"], **(TINY_MOE if cell == C else TINY_MODEL)}
    traffic = {**spec.traffic(spec.workload(bench, cell)["traffic"]), **tiny(cell)[1]}
    params = weights.make_params(spec.architecture(conf).layout(model), 3, torch.device("cpu"))
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.training.train_step import make_train_step

    step = make_train_step(train.model_config({"model": model}), train.hparams(traffic))
    opt = adamw_init(params)
    x = torch.randint(0, model["vocab_size"], (2, 32))
    params, opt, _ = step(params, opt, x, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            params, opt, _ = step(params, opt, x, x)
    return prof


def _traced_phases(cell: str, steps: int = 2) -> dict:
    return phases.read(_traced(cell, steps), steps)


def test_read_names_every_phase_of_a_traced_step():
    got = _traced_phases(C)
    assert set(got) == {"train_step", *STEP, *MOE}, got
    for name, figures in got.items():
        assert set(figures) == {"host_ms", "device_ms", "launches"}
        assert figures["host_ms"] > 0 and figures["device_ms"] == 0 and figures["launches"] == 0
    assert sum(got[n]["host_ms"] for n in STEP) <= got["train_step"]["host_ms"]
    assert sum(got[n]["host_ms"] for n in MOE) <= got["forward"]["host_ms"]


def _synthetic_trace() -> list:
    """Two updates with kernels and launches on two threads: the
    backward's come from autograd's thread while the step's waits."""
    def ev(name, a, b, kernels=()):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=a, end=b),
            kernels=[types.SimpleNamespace(duration=d) for d in kernels])

    events = []
    for t0, k in ((0.0, 50.0), (1000.0, 60.0)):
        events += [ev("bpt.train_step", t0, t0 + 900), ev("bpt.forward", t0 + 10, t0 + 300),
                   ev("aten::mm", t0 + 20, t0 + 40, kernels=[k]),
                   ev("cudaLaunchKernel", t0 + 30, t0 + 35),
                   ev("bpt.backward", t0 + 300, t0 + 800),
                   ev("autograd::engine::evaluate_function", t0 + 400, t0 + 450,
                      kernels=[70.0, 5.0]),
                   ev("cudaLaunchKernel", t0 + 410, t0 + 412),
                   ev("cuLaunchKernel", t0 + 420, t0 + 422)]
    events.append(ev("cudaLaunchKernel", 950.0, 951.0))  # between the updates
    return events


def test_the_benchmarks_reading_agrees_with_the_programs():
    """``phases`` keeps its own copy of the arithmetic, so that the program
    cannot move the yardstick; today the two give the same table."""
    from bpe_transformer_tpu_torch.telemetry.attribution import phase_table

    events = _traced(C).events()
    got = phases.table(events)
    assert set(got) == {"train_step", *STEP, *MOE} and got == phase_table(events)
    events = _synthetic_trace()
    got = phases.table(events)
    assert got == phase_table(events)
    assert got["forward"] == pytest.approx({"host_ms": 0.29, "device_ms": 0.055, "launches": 1})
    assert got["backward"] == pytest.approx({"host_ms": 0.5, "device_ms": 0.075, "launches": 2})


def test_read_gives_nothing_without_the_ranges():
    """A program without the ranges (the parent of the change that added
    them) gives an empty reading."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum()
    assert phases.read(prof, 3) == {}


@pytest.mark.parametrize("cell,ranks", [(A, 1), (C, 1), (D, 2)])
def test_each_held_metric_reads_the_phases(cell, ranks):
    table = _traced_phases(C if cell == C else A)
    run = {"ranks": [{"trace": {"phases": table}} for _ in range(ranks)]}
    for m in ENTRIES:
        value = spec.metric_reader(m["name"])(run)
        if cell in m["workloads"]:
            assert value is not None and value >= 0, m["name"]
    assert spec.metric_reader("optimizer_host_ms.train")(run) == pytest.approx(
        table["clip"]["host_ms"] + table["adamw"]["host_ms"])
    assert spec.metric_reader("step_host_ms.train")(run) == pytest.approx(
        table["train_step"]["host_ms"])


def test_every_held_entry_has_its_reader_and_follows_the_contract():
    cells = {w["name"] for w in spec.load_benchmark()["workloads"]}
    assert sorted(m["name"] for m in ENTRIES) == sorted(PHASE_METRICS)
    for m in ENTRIES:
        assert callable(spec.metric_reader(m["name"]))
        assert m["source"] == "program_span" and m["moves"] == "train_tokens_per_s"
        assert set(m["workloads"]) == ({C} if m["name"] == "moe_host_ms.train" else {A, C, D})
    assert not (spec.HERE / "pending" / "step-phases.json").exists()


@pytest.mark.parametrize("cell", [A, C, D])
def test_a_traced_run_reports_the_phase_metrics_of_its_cell(cell):
    """The runner keeps the phases of its host-operator stretch, so a
    traced run's result line carries every phase metric that lists its
    cell, each with a value."""
    out = run_cell(cell, 2**31 + 31, trace=1)
    assert out["correct"] is True, out["checked"]
    wanted = {m["name"] for m in ENTRIES if cell in m["workloads"]}
    assert wanted <= set(out["metrics"]), out["metrics"]
    for name in wanted:
        assert out["metrics"][name]["value"] >= 0, name
    assert out["metrics"]["step_host_ms.train"]["value"] > 0
