"""The readings that a cell's correctness limits are set from, several seeds
in one process (the benchmark's runs never do this):

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--program] [--control fp8|bf16|tf32] [--fault <fault>] [--seconds 10]

``--program`` reads the numbers the benchmark compares for each seed, of
the program as the cell runs it (with ``--fault``, with that fault planted
in the timed path); ``--control`` reads them of the reference computed in
the named lower precision put in the program's place.  A training cell
needs no measured window for either; a serving cell runs its loop for
``--seconds`` at the cell's own load, and with ``--control`` the control
stands in the program's place on the same prompts and served tokens: its
``numbers`` are the control's, the program's own gap is in its notes.
Prints one JSON line a seed and reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import spec, weights  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference import model as reference  # noqa: E402


def train_control(conf: dict, traffic: dict, seed: int, precision: str, device) -> dict:
    """The configuration's reference in ``precision`` against its float32
    reference, from the seed's weights over the rows the cell's feed draws
    for its checked steps."""
    from bpe_transformer_tpu_torch.data import get_batch

    model, arch = conf["model"], spec.architecture(conf)
    params = weights.make_params(arch.layout(model), seed, device)
    pool = weights.token_pool(seed, model["vocab_size"], traffic["pool_tokens"])
    rng = np.random.default_rng([int(seed), 2])
    rows = traffic["batch"] * traffic.get("world", 1)
    batches = []
    for _ in range(traffic["check_steps"]):
        x, y = get_batch(pool, rows, traffic["seq"], rng)
        batches.append((torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)))
    block = None if arch.whole_batch(model) else traffic.get("ref_block_rows")
    hp = {k: traffic[k] for k in ("lr", "min_lr", "warmup", "cosine_cycle")}
    ref = arch.train(params, batches, model, hp, "fp32", block)
    low = arch.train(params, batches, model, hp, precision, block)
    return compare.train_numbers(low, ref, weights.leaf_names(params))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", default=None, choices=reference.PRECISIONS[1:])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    conf = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if traffic["kind"] == "serve":
            from portbench.runners import serve

            run = serve.run(conf, traffic, seed, args.seconds, False, t0, fault=args.fault,
                            device=args.device, control=args.control)
            line = {"seed": seed, "numbers": run["numbers"], "notes": run["notes"]}
        else:
            from portbench.runners import train

            line = {"seed": seed}
            if args.program:
                out = train.train_rank(conf, traffic, seed, 0.0, False, dev, fault=args.fault)
                line["program"] = out["check"]["numbers"]
                line["program_where"] = out["check"]["where"]
            if args.control:
                low = train_control(conf, traffic, seed, args.control, dev)
                line["control"] = low["numbers"]
                line["control_where"] = low["where"]
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
