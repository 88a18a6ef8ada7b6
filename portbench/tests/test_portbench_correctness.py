"""The comparison that decides ``correct``: a sound run passes, and each
fault a cell can have, planted in the timed path, fails it.  Runs the
whole harness but its look for a card, on the CPU at a tiny size (the
program's plain versions run there)."""

import tempfile
from pathlib import Path

import pytest
import torch

from portbench import spec
from portbench.calibrate import train_control
from portbench.reference import compare
from portbench.tests.helpers import (add_tiny_twin, calibrate_in, copy_benchmark, run_cell,
                                     tiny, with_pending)

A, B, C, D = ("gpt2s-train-b8s1024", "gpt2s-serve-c256", "tsmoe-train-b16s512",
              "gpt2s-train-dp4-zero1")


@pytest.mark.parametrize("cell", [A, C])
def test_a_sound_training_run_is_correct(cell):
    out = run_cell(cell, 2**31 + 11)
    assert out["correct"] is True, out["checked"]
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
    assert list(out)[-1] == "checked"


@pytest.mark.parametrize("cell,fault", [(A, "frozen_state"), (A, "half_batch"),
                                        (C, "frozen_state"), (C, "half_batch")])
def test_a_broken_training_step_is_not_correct(cell, fault):
    out = run_cell(cell, 2**31 + 12, fault=fault)
    assert out["correct"] is False, out["checked"]


def test_a_sound_serving_run_is_correct_and_traced():
    out = run_cell(B, 2**31 + 13, seconds=2, trace=1)
    assert out["correct"] is True, out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "tick_ms.serve" in out["metrics"]


def test_an_altered_token_is_not_correct():
    out = run_cell(B, 2**31 + 14, seconds=2, fault="altered_token")
    assert out["correct"] is False, out["checked"]


def test_data_parallel_zero1_sound_and_without_its_exchange():
    sound = run_cell(D, 2**31 + 15)
    assert sound["correct"] is True, sound["checked"]
    assert sound["checked"]["rank_mismatch"]["value"] == 0
    broken = run_cell(D, 2**31 + 15, fault="no_exchange")
    assert broken["correct"] is False, broken["checked"]


@pytest.mark.parametrize("cell,precision", [(A, "fp8"), (C, "tf32"), (D, "fp8")])
def test_the_control_fails_a_limit(cell, precision):
    """The reference in the precision below the configuration's, put in the
    program's place (in D over the global batch of every rank), reads over
    at least one of the cell's limits.  (TF32 exists only on the card: its
    readings at C's size are in PERF.md and in the test on the card.)"""
    if precision == "tf32":
        pytest.skip("TF32 rounds only on the card; its readings are in PERF.md")
    bench = spec.load_benchmark()
    conf = spec.config(bench, spec.workload(bench, cell)["config"])
    model, sizes = tiny(cell)
    traffic = {**spec.traffic(spec.workload(bench, cell)["traffic"]), **sizes}
    low = train_control({**conf, "model": {**conf["model"], **model}}, traffic, 5, precision,
                        torch.device("cpu"))
    assert not compare.within(compare.held(low["numbers"], spec.limits(cell))), low


def test_the_serving_control_stands_in_the_programs_place():
    """B's control, the reference in fp8 at each position of the served
    requests, is what ``served_gap`` judges when it is read, the program's
    own gap going to the notes.  (Whether it goes over B's limit is read on
    the card at B's size, below: the limit is a gap of logits at B's widths,
    and the tiny model's logits, a tenth of those in spread, leave fp8 gaps
    of 0.01-0.04.)"""
    with tempfile.TemporaryDirectory() as tmp:
        root = copy_benchmark(Path(tmp))
        add_tiny_twin(root, B)
        line = calibrate_in(root, B, "2147483659", "--control", "fp8", "--seconds", "2")[0]
    assert line["notes"]["control"] == "fp8" and line["notes"]["checked_tokens"] > 0, line
    assert line["numbers"]["served_gap"] > line["notes"]["program_served_gap"], line
    assert "served_gap" in compare.held(line["numbers"], spec.limits(B))


@pytest.mark.chip
@pytest.mark.parametrize("cell,precision", [(A, "fp8"), (B, "fp8"), (C, "tf32"), (D, "fp8")])
def test_the_control_on_the_card_at_the_cells_size(cell, precision):
    """The control at the cell's own size on three seeds, in the program's
    place: each reading goes over one of the cell's limits (B's at its
    own load, over a window of the run's length)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control is read at the cell's own size")
    import time

    from portbench.runners import serve

    bench = with_pending(spec.load_benchmark())
    conf = spec.config(bench, spec.workload(bench, cell)["config"])
    traffic = spec.traffic(spec.workload(bench, cell)["traffic"])
    readings = []
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        if cell == B:
            run = serve.run(conf, traffic, seed, float(bench["run_seconds"]), False, time.time(),
                            control=precision)
            low = {"numbers": run["numbers"], "notes": run["notes"]}
        else:
            low = train_control(conf, traffic, seed, precision, torch.device("cuda"))
        print(cell, seed, low, flush=True)
        readings.append(low["numbers"])
    for numbers in readings:
        assert not compare.within(compare.held(numbers, spec.limits(cell))), (cell, readings)
