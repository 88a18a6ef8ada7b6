"""The lookup of a configuration's architecture changes nothing of today's
cells: readings pinned from the benchmark before the lookup (each existing
configuration at the tiny widths on the CPU, seed 2147483725), and the
refusal of a model key the program does not know."""

import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import spec, weights
from portbench.runners import model_config
from portbench.tests.helpers import (ROOT, TINY_MODEL, TINY_MOE, add_tiny_twin, copy_benchmark)

SEED = 2**31 + 77
HP = {"lr": 6e-4, "min_lr": 6e-5, "warmup": 1, "cosine_cycle": 100000}
#: Per configuration: its tiny widths, the reference's block of rows, and
#: the readings (a digest of the seeded float32 leaves with their shapes;
#: the reference's three losses and first-gradient norms by leaf).
PINNED = {
    "gpt2_small_32k": (TINY_MODEL, 2, {
        "digest": "988b52bd3daf91f9ca201e42d85d14f17c0dac88345478ea1aaed9a51e95ea57",
        "losses": [6.220937728881836, 6.249501705169678, 6.232390403747559],
        "first_grad": [
            0.004586629569530487, 0.27847719192504883, 0.004605231806635857, 0.3085179030895233,
            0.06649848818778992, 0.06596323847770691, 0.06693240255117416, 0.005110204219818115,
            0.002032147953286767, 0.0034837203565984964, 0.2691231369972229,
            0.003794783493503928, 0.2559775412082672, 0.0654216855764389, 0.06393313407897949,
            0.0651525929570198, 0.0049797361716628075, 0.0016919942572712898,
            0.5704120397567749, 0.011020006611943245, 0.5812315344810486]}),
    "tinystories_moe": (TINY_MOE, None, {
        "digest": "751ccb756c30e6813cde60d61e0ff85146baf0cf70120c1ed90decc49d97174b",
        "losses": [6.232883453369141, 6.266983509063721, 6.263596534729004],
        "first_grad": [
            0.004662454128265381, 0.2939305901527405, 0.00487088318914175, 0.2757139205932617,
            0.004470507148653269, 0.035982728004455566, 0.035811226814985275,
            0.035776037722826004, 0.005074973218142986, 0.0009101860341615975,
            0.003562155645340681, 0.26067203283309937, 0.003439676947891712, 0.2691488564014435,
            0.00426101079210639, 0.029800495132803917, 0.03016809932887554,
            0.030711032450199127, 0.005911353509873152, 0.0008281666086986661,
            0.5947179794311523, 0.011375723406672478, 0.5801774263381958]}),
}
#: ``train_step_flops`` of each cell's configuration at its own batch (every
#: rank's rows) and sequence, and the serving counts at a few sizes.
FLOPS = [
    ("gpt2_small_32k", "train_step_flops", (8, 1024), 6310380699648.0),
    ("tinystories_moe", "train_step_flops", (16, 512), 3655084277760.0),
    ("gpt2_small_32k", "train_step_flops", (32, 1024), 25241522798592.0),
    ("gpt2_small_32k", "prefill_flops", (300,), 69024153600.0),
    ("gpt2_small_32k", "decode_tick_flops", (256, 40000), 57544015872.0),
    ("tinystories_moe", "prefill_flops", (300,), 43054694400.0),
    ("tinystories_moe", "decode_tick_flops", (1, 700), 153346048.0),
]


def _conf(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def _tiny(name: str):
    conf = _conf(name)
    widths, block, readings = PINNED[name]
    conf = {**conf, "model": {**conf["model"], **widths}}
    arch = spec.architecture(conf)
    return conf, arch, block, readings


@pytest.mark.parametrize("name", sorted(PINNED))
def test_seeded_parameters_are_as_pinned(name):
    conf, arch, _, readings = _tiny(name)
    params = weights.make_params(arch.layout(conf["model"]), SEED, torch.device("cpu"))
    digest = hashlib.sha256()
    for p in weights.leaves(params):
        digest.update(str(tuple(p.shape)).encode())
        digest.update(p.detach().numpy().tobytes())
    assert digest.hexdigest() == readings["digest"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_reference_losses_and_first_gradients_are_as_pinned(name):
    conf, arch, block, readings = _tiny(name)
    model = conf["model"]
    params = weights.make_params(arch.layout(model), SEED, torch.device("cpu"))
    rng = np.random.default_rng([SEED, 9])
    batches = []
    for _ in range(3):
        rows = torch.from_numpy(rng.integers(0, model["vocab_size"], (4, 33)))
        batches.append((rows[:, :-1], rows[:, 1:]))
    assert arch.whole_batch(model) == (block is None)
    ref = arch.train(params, batches, model, HP, "fp32", block)
    # Float32 sums, whose order may follow the host's thread count.
    assert ref["losses"] == pytest.approx(readings["losses"], rel=1e-5)
    assert ref["first_grad"] == pytest.approx(readings["first_grad"], rel=1e-5)


@pytest.mark.parametrize("name,count,args,value", FLOPS)
def test_model_flops_are_as_pinned(name, count, args, value):
    conf = _conf(name)
    assert getattr(spec.architecture(conf), count)(conf["model"], *args) == value


def test_a_model_key_the_program_lacks_is_refused_by_name(tmp_path):
    conf = _conf("gpt2_small_32k")
    model_config(conf)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        model_config({**conf, "model": {**conf["model"], "kv_lora_rank": 512}})
    # A whole run of a cell whose configuration carries one fails in set-up,
    # with no result and the key named.
    root = copy_benchmark(tmp_path)
    cell = "gpt2s-train-b8s1024"
    add_tiny_twin(root, cell)
    path = root / "portbench" / "configs" / "tiny_gpt2s_train_b8s1024.json"
    tiny = json.loads(path.read_text())
    tiny["model"]["kv_lora_rank"] = 512
    path.write_text(json.dumps(tiny))
    out = subprocess.run([sys.executable, str(root / "portbench" / "run.py"), "--workload", cell,
                          "--seed", "5", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "kv_lora_rank" in out.stderr
