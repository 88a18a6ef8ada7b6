"""The benchmark of ``bpe_transformer_tpu_torch`` (the PyTorch and CUDA
program), one cell a run:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a host with the cards the cell asks for.
The cell (``BENCHMARK.json``) names a configuration, a traffic mix and a
chip count; set-up builds the cell's system from the seed and warms every
shape it will use, the window measures for ``--seconds``, and the outputs of
the timed path are then compared with the plain reference
(``portbench/reference``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checked``: each
number compared beside its limit.  The same numbers end standard error.

Exits non-zero with no result when the host lacks the cards, when JAX or
the JAX package was loaded, or when anything of the run fails.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Any kernel cache a library might keep lives at a fixed path in the
# checkout (the program's own nvcc build root is bpe_transformer_tpu_torch/_build).
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from portbench import guard, spec  # noqa: E402
from portbench.reference import compare  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # For the benchmark's own tests, which drive whole runs on the CPU (the
    # program's plain versions run there) and plant faults in the timed path.
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _fail(msg: str, code: int = 1):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def execute(args, t_start: float = T_START) -> dict:
    """Run one cell; returns the result object (not yet printed)."""
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    conf = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device: this benchmark measures the program on the card", 2)
        if torch.cuda.device_count() < cell["chips"]:
            _fail(f"cell {cell['name']} needs {cell['chips']} cards, the host has "
                  f"{torch.cuda.device_count()}", 2)
    kind = traffic["kind"]
    if kind == "train":
        from portbench.runners import train as runner
    elif kind == "serve":
        from portbench.runners import serve as runner
    else:
        _fail(f"traffic {cell['traffic']} has an unknown kind {kind!r}")
    run = runner.run(conf, traffic, args.seed, args.seconds, bool(args.trace), t_start,
                     fault=args.fault, device=args.device)
    found = guard.forbidden_modules() + [m for r in run.get("ranks", []) for m in
                                         r.get("forbidden", [])]
    if found:
        _fail(f"modules of JAX or of the JAX package were loaded: {sorted(set(found))}", 3)

    run.update(cell=cell["name"], conf=conf, model=conf["model"], traffic=traffic,
               chips=cell["chips"], device_kind=_device_kind(args.device))
    names = spec.per_layer_for(bench, cell["name"]) if args.trace else \
        spec.end_to_end_for(bench, cell["name"])
    metrics = {}
    for m in names:
        value = run["e2e"].get(m["name"]) if not args.trace else spec.metric_reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # The numbers the cell's limits file names are compared; the others are
    # reported in the notes.
    checked = compare.held(run["numbers"], limits)
    correct = run["failed"] == 0 and compare.within(checked)
    ranks = run.get("ranks") or [run]
    device = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": run["device_kind"],
        "count": cell["chips"],
        "memory_peak_bytes": max(r.get("memory_peak_bytes", 0) for r in ranks),
    }
    result = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        traces = [r["trace"] for r in ranks if r.get("trace")]
        if traces:
            device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
            device["window_s"] = traces[0]["window_s"]
            result["breakdown"] = {"device_ops": traces[0]["device_ops"],
                                   "idle_gaps": traces[0]["idle_gaps"]}
    result["checked"] = checked
    result["notes"] = {**run.get("notes", {}), "numbers": run["numbers"]}
    return result


def _device_kind(device: str) -> str:
    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


def main(argv=None) -> int:
    args = parse(argv)
    result = execute(args)
    checked = result.pop("checked")
    notes = result.pop("notes")
    result["checked"] = checked
    print(json.dumps({"notes": notes}), file=sys.stderr)
    print(f"correct {result['correct']}; the numbers compared and their limits:",
          file=sys.stderr)
    for name, c in checked.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"checked {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
