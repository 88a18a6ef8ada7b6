"""Training cells: one object (the step, its model and its AdamW state)
built in set-up, driven from the seed through its first three steps, then
handed to the measured window.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "train"``):
``batch`` rows a rank, ``seq``, ``world`` ranks (one a card), optional
``opt_sharding`` (``"zero1"``), the schedule ``lr``, ``min_lr``,
``warmup``, ``cosine_cycle``, ``pool_tokens`` (the seeded token array the
feed samples windows from), ``check_steps`` (steps the reference follows),
``profile_steps`` (steps in the traced stretch) and ``ref_block_rows``
(rows a reference block, unless the architecture's ``whole_batch`` says
its reference takes the whole batch, as an MoE model's does, whose expert
capacity the batch shares).

The weights, the reference and its batching are the configuration's
architecture's (``spec.architecture``).

Each step's rows come from the program's ``data.get_batch`` over the token
array, with a generator seeded from the run's seed: every row differs, and
the same seed gives the same rows.  In a world of several ranks every rank
draws the same global batch and takes its rows with the program's
``shard_batch``.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import sys
import time

import numpy as np
import torch

from portbench import devices, phases, spec, trace, weights
from portbench.reference import compare
from portbench.runners import model_config


def hparams(traffic: dict):
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams

    return TrainHParams(max_learning_rate=traffic["lr"], min_learning_rate=traffic["min_lr"],
                        warmup_iters=traffic["warmup"],
                        cosine_cycle_iters=traffic["cosine_cycle"])


def _feed(traffic: dict, pool: np.ndarray, seed: int, device, mesh):
    """``feed() -> ((x, y) global on the host, x, y of this rank on the
    card)``."""
    from bpe_transformer_tpu_torch.data import get_batch

    world = traffic.get("world", 1)
    rows, seq = traffic["batch"] * world, traffic["seq"]
    rng = np.random.default_rng([int(seed), 2])

    def feed():
        x, y = get_batch(pool, rows, seq, rng)
        if mesh is not None:
            from bpe_transformer_tpu_torch.parallel.train_step import shard_batch

            xs, ys = shard_batch((x, y), mesh)
        else:
            xs, ys = devices.to_device(x, device), devices.to_device(y, device)
        return (x, y), xs, ys

    return feed


def _launches() -> dict:
    """The program's launch counter of every kernel name it has counted,
    and of :data:`KERNELS` (0 until counted)."""
    from bpe_transformer_tpu_torch.kernels import _build

    return {**_build.read_launches(KERNELS), **_build.launches}


#: Launch names that every traced stretch's ``calls`` holds, 0 where none
#: ran; any other name of the program's counter is there where it moved.
KERNELS = ("flash_attention_rope", "swiglu")


def train_rank(conf: dict, traffic: dict, seed: int, seconds: float, traced: bool,
               device, mesh=None, fault=None, t_start: float | None = None,
               window_group=None) -> dict:
    """Set-up, the window, the traced stretch and the reference check on
    this rank.  Returns what the metrics and the result read (the
    comparison only on rank 0).  ``fault`` (tests only) breaks the timed
    path underneath: ``"frozen_state"`` (the step returns its state
    unchanged), ``"half_batch"`` (half of the rows left out, the mean over
    the rest), ``"no_exchange"`` (the gradient exchange between ranks left
    out).  ``window_group`` (a gloo group of the world's ranks) makes every
    rank end the window after the same step."""
    from bpe_transformer_tpu_torch.optim import adamw_init, sharded_adamw_init
    from bpe_transformer_tpu_torch.training.train_step import make_train_step

    t_start = time.time() if t_start is None else t_start
    cfg = model_config(conf)
    model = conf["model"]
    arch = spec.architecture(conf)
    hp = hparams(traffic)
    world = traffic.get("world", 1)
    rank = 0 if mesh is None else mesh.rank
    zero1 = traffic.get("opt_sharding") == "zero1"

    params = weights.make_params(arch.layout(model), seed, device)
    names = weights.leaf_names(params)
    p0_host = ([p.detach().to("cpu", copy=True) for p in weights.leaves(params)]
               if rank == 0 else None)
    p0 = [p.detach().clone() for p in weights.leaves(params)]
    if mesh is None:
        opt_state = adamw_init(params)
        step = make_train_step(cfg, hp)
    else:
        from bpe_transformer_tpu_torch.parallel.train_step import make_dp_train_step

        opt_state = sharded_adamw_init(params, world, mesh=mesh) if zero1 else adamw_init(params)
        step = make_dp_train_step(cfg, hp, mesh, opt_sharding="zero1" if zero1 else None)
    step = _faulty(step, fault, mesh)
    pool = weights.token_pool(seed, model["vocab_size"], traffic["pool_tokens"])
    feed = _feed(traffic, pool, seed, device, mesh)

    # The checked steps: the window's own call and feed, from the seed.
    batches, losses = [], []
    for i in range(traffic["check_steps"]):
        host, x, y = feed()
        batches.append(host)
        params, opt_state, m = step(params, opt_state, x, y)
        losses.append(m["loss"])
        if i == 0:
            first_grad = _first_grad(opt_state, params, mesh, zero1)
    change = [float(torch.linalg.vector_norm(p.detach().float() - q.float()))
              for p, q in zip(weights.leaves(params), p0)]
    losses = [float(v) for v in losses]
    del p0
    devices.sync(device)
    if mesh is not None:
        torch.distributed.barrier()
    t_open = time.time()

    # The window.
    devices.reset_peak(device)
    steps, dispatch = 0, []
    t0 = time.perf_counter()
    go = _agreed_clock(window_group)
    while go(time.perf_counter() - t0 < seconds):
        _, x, y = feed()
        ts = time.perf_counter()
        params, opt_state, m = step(params, opt_state, x, y)
        dispatch.append(time.perf_counter() - ts)
        steps += 1
    last_loss = float(m["loss"])  # the window ends in this sync
    devices.sync(device)
    window_s = time.perf_counter() - t0
    peak_window = devices.peak_bytes(device)

    out = {
        "rank": rank, "t_open": t_open, "setup_s": t_open - t_start, "steps": steps,
        "window_s": window_s, "dispatch_s": dispatch, "last_loss": last_loss,
        "peak_window_bytes": peak_window,
    }
    if traced:
        out["trace"] = _profile(step, params, opt_state, feed, traffic["profile_steps"], device)
    out["memory_peak_bytes"] = devices.peak_bytes(device)
    out["param_sums"] = [int(p.detach().float().view(torch.int32).to(torch.int64).sum())
                         for p in weights.leaves(params)]
    del params, opt_state, step, m
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        out["check"] = _check(arch, model, traffic, p0_host, names, batches, device,
                              {"losses": losses, "first_grad": first_grad, "change": change})
    return out


def _agreed_clock(group):
    """``go(in_time) -> bool``: whether to run one more step of the window.
    On one card, the clock's answer.  Across ranks, every rank must run the
    same steps (a step holds collectives), so each step posts the rank's
    answer to a minimum over ``group`` without waiting, and the next step
    waits for it: all ranks stop after the same step, and a rank whose host
    is ahead waits for the others' answers one step late."""
    if group is None:
        return lambda in_time: in_time
    import torch.distributed as dist

    pending = []

    def go(in_time: bool) -> bool:
        if pending:
            work, flag = pending.pop()
            work.wait()
            if not int(flag[0]):
                return False
        flag = torch.tensor([int(in_time)], dtype=torch.int32)
        pending.append((dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group,
                                        async_op=True), flag))
        return True

    return go


def _faulty(step, fault, mesh):
    if fault is None:
        return step
    if fault == "frozen_state":
        def frozen(params, opt_state, x, y):
            _, _, m = step(copy.deepcopy(params), copy.deepcopy(opt_state), x, y)
            return params, opt_state, m
        return frozen
    if fault == "half_batch":
        def half(params, opt_state, x, y):
            n = x.shape[0] // 2
            return step(params, opt_state, x[:n], y[:n])
        return half
    if fault == "no_exchange":
        from bpe_transformer_tpu_torch.optim import sharded

        def alone(params, opt_state, x, y):
            # Each rank keeps its own gradient rows: the reduce-scatter
            # becomes a local slice (times the width, which the update
            # divides out again).
            saved = sharded._reduce_scatter

            def local(out, flat, group):
                n = out.numel()
                out.copy_(flat[mesh.rank * n:(mesh.rank + 1) * n] * mesh.world_size)

            sharded._reduce_scatter = local
            try:
                return step(params, opt_state, x, y)
            finally:
                sharded._reduce_scatter = saved
        return alone
    raise ValueError(f"unknown fault {fault!r}")


def _first_grad(opt_state, params, mesh, zero1: bool) -> list[float]:
    """Per-leaf norms of the first step's gradient as AdamW got it:
    ``m / (1 - beta1)`` after one step (ZeRO-1: the ranks' rows gathered)."""
    b1 = 0.9
    if not zero1:
        return [float(torch.linalg.vector_norm(m)) / (1 - b1)
                for m in weights.leaves(opt_state.m)]
    row = opt_state.m.reshape(-1)
    flat = torch.empty(row.numel() * mesh.world_size, dtype=row.dtype, device=row.device)
    torch.distributed.all_gather_into_tensor(flat, row)
    out, offset = [], 0
    for p in weights.leaves(params):
        n = p.numel()
        out.append(float(torch.linalg.vector_norm(flat[offset:offset + n])) / (1 - b1))
        offset += n
    return out


def _profile(step, params, opt_state, feed, n_steps: int, device) -> dict:
    """Two ``torch.profiler`` traces of ``n_steps`` steps after the window,
    each read after it stopped.  The first records the device alone (the
    CUDA runtime's calls too), whose cost to the host is small: the busy
    time, the kernels and the launches over it (``calls``: :data:`KERNELS`
    and every launch name whose counter moved) come from it.  The second
    also records every host operator, which slows the host by several
    microseconds an operator: it names the idle gaps, and its ``bpt.*``
    ranges give the step's phases (``phases.read``)."""
    from torch.profiler import profile

    def stretch(host_ops):
        batches = [feed() for _ in range(n_steps)]
        devices.sync(device)
        before = _launches()
        nonlocal params, opt_state
        with profile(activities=devices.activities(host_ops)) as prof:
            t0 = time.perf_counter()
            for _, x, y in batches:
                params, opt_state, _ = step(params, opt_state, x, y)
            devices.sync(device)
            window_s = time.perf_counter() - t0
        after = _launches()
        out = trace.summarize(prof, window_s)
        out["calls"] = {k: n - before.get(k, 0) for k, n in after.items()
                        if k in KERNELS or n != before.get(k, 0)}
        if host_ops:
            out["phases"] = phases.read(prof, n_steps)
        return out

    out = stretch(False)
    host = stretch(True)
    out["idle_gaps"], out["phases"] = host["idle_gaps"], host["phases"]
    out["steps"] = n_steps
    return out


def _check(arch, model: dict, traffic: dict, p0_host: list, names: list, batches: list,
           device, prog: dict, precision: str = "fp32") -> dict:
    """The architecture's reference over the checked steps, from the same
    weights and rows, and the numbers compared."""
    start = weights.tree_from(arch.layout(model), p0_host, device)
    ref_batches = [tuple(torch.from_numpy(a).to(device) for a in b) for b in batches]
    block = None if arch.whole_batch(model) else traffic.get("ref_block_rows")
    t0 = time.perf_counter()
    ref = arch.train(start, ref_batches, model, _ref_hp(traffic), precision, block)
    result = compare.train_numbers(prog, ref, names)
    result["reference_s"] = time.perf_counter() - t0
    result["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    return result


def _ref_hp(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("lr", "min_lr", "warmup", "cosine_cycle")}


# ------------------------------------------------------------- the cell


def run(conf: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        t_start: float, fault=None, device="cuda") -> dict:
    """The cell on one card, or across a world of ranks started with the
    program's ``parallel/launch.py`` (one process a card).  Returns the
    end-to-end readings (``e2e``), the numbers compared (``numbers``), the
    steps attempted and failed, and every rank's readings (``ranks``)."""
    model_config(conf)  # refuses, before any rank starts, a key the program lacks
    world = traffic.get("world", 1)
    if world == 1:
        ranks = [train_rank(conf, traffic, seed, seconds, traced, torch.device(device),
                            fault=fault, t_start=t_start)]
    else:
        from bpe_transformer_tpu_torch.parallel.launch import launch

        job = {"conf": conf, "traffic": traffic, "seed": seed, "seconds": seconds,
               "traced": traced, "fault": fault, "t_start": t_start, "device": device}
        outs = launch(["-m", "portbench.runners.train", json.dumps(job)], world,
                      timeout=330.0, cwd=str(_ROOT),
                      env={"PYTHONPATH": str(_ROOT), "OMP_NUM_THREADS": "4"})
        ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    r0 = ranks[0]
    tokens = r0["steps"] * traffic["batch"] * world * traffic["seq"]
    numbers = dict(r0["check"]["numbers"])
    if world > 1:
        # The ranks end with equal parameters: leaves whose bits differ.
        numbers["rank_mismatch"] = sum(
            len({r["param_sums"][i] for r in ranks}) > 1 for i in range(len(r0["param_sums"])))
    finite = all(math.isfinite(r["last_loss"]) for r in ranks)
    return {
        "ranks": ranks,
        "e2e": {"train_tokens_per_s": tokens / r0["window_s"], "setup_s": r0["setup_s"]},
        "numbers": numbers,
        "attempted": r0["steps"],
        "failed": 0 if finite else r0["steps"],
        "notes": {"steps": r0["steps"], "window_s": r0["window_s"],
                  "window_loss": [r["last_loss"] for r in ranks],
                  "worst_leaf": r0["check"]["where"], "losses": r0["check"]["losses"],
                  "reference_s": r0["check"]["reference_s"]},
    }


_ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


def _rank_main(job: dict) -> None:
    from bpe_transformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": job["traffic"]["world"]}, device=job["device"])
    window_group = torch.distributed.new_group(backend="gloo")
    out = train_rank(job["conf"], job["traffic"], job["seed"], job["seconds"], job["traced"],
                     mesh.device, mesh=mesh, fault=job["fault"], t_start=job["t_start"],
                     window_group=window_group)
    from portbench.guard import forbidden_modules

    out["forbidden"] = forbidden_modules()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    _rank_main(json.loads(sys.argv[1]))
