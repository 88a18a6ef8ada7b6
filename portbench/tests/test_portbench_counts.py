"""The benchmark's frozen arithmetic, pinned to figures worked by hand."""

import json

import pytest

from portbench import counts
from portbench.tests.helpers import ROOT

GPT2 = json.loads((ROOT / "portbench/configs/gpt2_small_32k.json").read_text())["model"]
MOE = json.loads((ROOT / "portbench/configs/tinystories_moe.json").read_text())["model"]
H100 = "NVIDIA H100 80GB HBM3"


def test_train_step_flops_gpt2_small_batch_8():
    # Matmul parameters: 12 x (4 x 768^2 + 3 x 768 x 2048) + 768 x 32000
    # = 109,510,656; forward = 2 N x 8192 + 4 x 12 x 1024 x 768 x 8192
    # = 1.79423e12 + 3.09238e11; a step is three forwards.
    assert counts.matmul_param_count(GPT2) == 109_510_656
    assert counts.train_step_flops(GPT2, 8) == pytest.approx(6.310e12, rel=5e-4)


def test_train_step_flops_tinystories_moe_batch_16():
    # 12 x (4 x 512^2 + 2 x 3 x 512 x 1365 + 512 x 8) + 512 x 10000 = 68,071,424;
    # forward = 2 N x 8192 + 4 x 12 x 512 x 512 x 8192 = 1.11528e12 + 1.03079e11.
    assert counts.matmul_param_count(MOE) == 68_071_424
    assert counts.train_step_flops(MOE, 16) == pytest.approx(3.655e12, rel=5e-4)


def test_b5_bound_matches_the_kernel_table():
    # PERF.md's kernel table, row 5: 0.0152 ms at (8, 12, 1024, 64) bf16
    # (bytes-bound: q, k, v, out, lse and the cos/sin rows, 50.86 MB).
    flops, nbytes = counts.flash_attention_rope_work(8, 12, 1024, 64, 2)
    assert nbytes == 50_855_936
    assert counts.least_seconds(flops, nbytes, H100) * 1e3 == pytest.approx(0.0152, abs=5e-5)


def test_b3_bound_matches_the_kernel_table():
    # Row 3: 0.0782 ms at m 8192, d 768, ff 2048 bf16 (ops-bound: 77.3 GFLOP).
    flops, nbytes = counts.swiglu_work(8192, 768, 2048, 2)
    assert flops == 6 * 8192 * 768 * 2048
    assert counts.least_seconds(flops, nbytes, H100) * 1e3 == pytest.approx(0.0782, abs=5e-5)


def test_b1_bound_matches_the_kernel_table():
    # Row 1: 0.00323 ms for 8 slots x 12 heads, d 64, bf16, positions
    # 0, 15, 100, 257, 511, 700, 900, 1023 (3,514 visible rows).
    visible = sum(p + 1 for p in (0, 15, 100, 257, 511, 700, 900, 1023))
    flops, nbytes = counts.decode_attention_work(8, 12, 12, 64, visible, 2)
    assert nbytes == 10_819_648
    assert counts.least_seconds(flops, nbytes, H100) * 1e3 == pytest.approx(0.00323, abs=5e-6)


def test_no_peak_row_means_no_bound():
    assert counts.peaks("cpu") is None and counts.least_seconds(1.0, 1.0, "cpu") is None
    assert counts.peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
