"""The single-device training loop (port of the one-device path of
``bpe_transformer_tpu/training/loop.py``): token array -> per-iteration
seeded batches -> train steps on one device -> periodic eval, logs and
checkpoints, with the JAX loop's telemetry and resilience.

Batches are a pure function of ``(seed, iteration)`` (and, after a NaN
rollback, of the rollback salt), as in the JAX loop, so a resumed run
samples exactly the batches an uninterrupted run would, and the same seed
gives the same batches in both packages.  The metrics are read back once
per ``log_every`` steps: that read is the loop's only sync with the card
between evals and checkpoints, and the health and dynamics taps ride it
(they run on the updates that end on a log boundary only).

What the loop wires, as the JAX loop does:

* the telemetry stream (``metrics_jsonl``, ``wandb_project``): the run
  manifest, spans, step records with throughput and MFU, ``resources``
  records at every log boundary, ``health`` fields and ``dynamics``
  records, the footer, and the flight recorder's dumps;
* the watchdog: hang detection against the trailing median step time, and
  the ``raise`` / ``skip`` / ``rollback`` policies for a non-finite state
  found at a log boundary (rollback reloads the last valid snapshot under
  ``RollbackBudget`` and salts the batch seed);
* graceful preemption: SIGTERM/SIGINT stops the loop at the next step
  boundary, writes an emergency checkpoint (unless the state is not
  finite) and returns ``summary["preempted"]``, which the CLI maps to
  ``EXIT_PREEMPTED``;
* the ``BT_FAULTS`` hooks (``resilience/faults.py``), retention
  (``keep_checkpoints``), batch prefetch on a worker thread, scanned inner
  steps and asynchronous checkpoints.

``latest.ckpt`` is a relative symlink to the newest snapshot (and
``latest.ckpt.crc32.json`` to its sidecar), so the state is on disk once.

* performance attribution (``attribution_every``): at every N-th step, a
  log boundary, ``telemetry/attribution.py``'s probe times a clone of the
  step and splits the window's wall step time into compute and host gap
  (``kind="attribution"`` records), watchdog-paused and outside the
  throughput window; the probe is built at the first such boundary and
  the other steps never see it.

``LoopConfig`` keeps every field of the JAX package's.  Those that select
another slice's machinery raise ``NotImplementedError`` when set: the
multi-GPU strategies and optimizer sharding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from bpe_transformer_tpu_torch.checkpointing.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint_with_fallback,
    save_checkpoint,
    training_state,
)
from bpe_transformer_tpu_torch.data.dataset import (
    BatchPrefetcher,
    check_dataset_geometry,
    get_batch,
)
from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import init_params
from bpe_transformer_tpu_torch.optim.adamw import adamw_init
from bpe_transformer_tpu_torch.resilience.faults import FaultInjector
from bpe_transformer_tpu_torch.resilience.integrity import atomic_write_json, sidecar_path
from bpe_transformer_tpu_torch.resilience.retention import gc_checkpoints
from bpe_transformer_tpu_torch.resilience.rollback import RollbackBudget, RollbackExhausted
from bpe_transformer_tpu_torch.resilience.signals import GracefulShutdown
from bpe_transformer_tpu_torch.telemetry.dynamics import dynamics_record, flatten_dynamics
from bpe_transformer_tpu_torch.telemetry.flightrecorder import FlightRecorder
from bpe_transformer_tpu_torch.telemetry.health import flatten_health
from bpe_transformer_tpu_torch.telemetry.manifest import run_manifest
from bpe_transformer_tpu_torch.telemetry.report import nonfinite_fields
from bpe_transformer_tpu_torch.telemetry.resources import sample_resources, tree_bytes_per_device
from bpe_transformer_tpu_torch.telemetry.sinks import MetricsLogger
from bpe_transformer_tpu_torch.telemetry.spans import Telemetry
from bpe_transformer_tpu_torch.telemetry.timing import StepTimer
from bpe_transformer_tpu_torch.telemetry.watchdog import NonFiniteError, Watchdog
from bpe_transformer_tpu_torch.tree import tree_leaves
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    make_eval_step,
    make_grad_accum_train_step,
    make_scanned_train_step,
    make_train_step,
)
from bpe_transformer_tpu_torch.utils.flops import train_step_flops


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    steps: int = 1000
    batch_size: int = 32
    log_every: int = 50
    eval_every: int = 500
    eval_batches: int = 8
    checkpoint_every: int = 1000
    checkpoint_dir: str | None = None
    #: The telemetry stream: a JSONL file, and a wandb project (imported
    #: only when set).
    metrics_jsonl: str | None = None
    wandb_project: str | None = None
    #: Health stats in the step (``telemetry/health.py``), logged with every
    #: step record.
    health_stats: bool = False
    #: ``kind="dynamics"`` records every N steps (a multiple of log_every).
    dynamics_every: int = 0
    #: ``kind="attribution"`` records every N steps (a multiple of
    #: log_every; 0 = off): the probe's measured compute / host-gap split
    #: of the step, with the analytic roofline on the first record.
    attribution_every: int = 0
    #: Hang detection and the non-finite policy (``telemetry/watchdog.py``):
    #: "raise", "skip" or "rollback" (needs checkpoint_dir).
    watchdog: bool = False
    watchdog_factor: float = 10.0
    watchdog_policy: str = "raise"
    #: The rollback breaker: abort after max_rollbacks rollbacks without
    #: recovery_min_progress steps of training between them.
    max_rollbacks: int = 3
    recovery_min_progress: int = 1
    #: Keep only the newest N ``step_*.ckpt`` snapshots (None: keep all);
    #: the one ``latest.ckpt`` points at is never deleted.
    keep_checkpoints: int | None = None
    seed: int = 0
    parallel: str | None = None
    mesh_axes: dict | None = None
    pp_microbatches: int = 4
    sp_zigzag: bool = False
    sp_ulysses: bool = False
    #: Optimizer updates a step call (``make_scanned_train_step``); the log,
    #: eval and checkpoint cadences must be multiples.
    inner_steps: int = 1
    opt_sharding: str | None = None
    #: Batches sampled ahead on a worker thread (0: synchronous).
    prefetch: int = 0
    #: Microbatches per optimizer update (must divide batch_size).
    grad_accum_steps: int = 1
    #: Write checkpoints on a background thread after a synchronous copy to
    #: the host (one host copy of the state per save).
    async_checkpoint: bool = False


#: LoopConfig fields that select the machinery of a later slice.  Sequence
#: parallelism on one card is ``parallel.sp.make_sp_train_step``; the loop
#: wiring (``parallel="sp"``) comes with the multi-GPU slice.
_MULTI_GPU = "multi-GPU training (ROADMAP slice 10)"
_OTHER_SLICES = {
    "parallel": _MULTI_GPU,
    "mesh_axes": _MULTI_GPU,
    "opt_sharding": _MULTI_GPU,
    "sp_zigzag": _MULTI_GPU,
    "sp_ulysses": _MULTI_GPU,
}


def _check_loop(loop: LoopConfig) -> None:
    """The JAX loop's single-device config errors (raised before any sink
    opens), then the refusal of other slices' fields."""
    if loop.dynamics_every < 0:
        raise ValueError(f"dynamics_every must be >= 0, got {loop.dynamics_every}")
    if loop.dynamics_every and loop.dynamics_every % loop.log_every:
        raise ValueError(
            f"dynamics_every={loop.dynamics_every} must be a multiple of "
            f"log_every={loop.log_every} — dynamics records ride the log-cadence "
            "metric fetch (no extra host syncs)"
        )
    if loop.attribution_every < 0:
        raise ValueError(f"attribution_every must be >= 0, got {loop.attribution_every}")
    if loop.attribution_every and loop.attribution_every % loop.log_every:
        raise ValueError(
            f"attribution_every={loop.attribution_every} must be a multiple of "
            f"log_every={loop.log_every} — attribution probes run at log boundaries so "
            "untouched steps pay zero extra host syncs"
        )
    if loop.prefetch < 0:
        raise ValueError(f"prefetch must be >= 0, got {loop.prefetch}")
    if loop.watchdog and loop.watchdog_policy not in Watchdog.POLICIES:
        raise ValueError(
            f"watchdog_policy must be one of {Watchdog.POLICIES}, got {loop.watchdog_policy!r}"
        )
    if loop.watchdog and loop.watchdog_policy == "rollback":
        if loop.checkpoint_dir is None:
            raise ValueError(
                'watchdog_policy="rollback" needs checkpoint_dir — recovery reloads the '
                "last valid snapshot"
            )
        if loop.checkpoint_every % loop.log_every:
            # Detection happens at log boundaries: a checkpoint on a
            # detection boundary can never hold an undetected poisoned state.
            raise ValueError(
                f"checkpoint_every={loop.checkpoint_every} must be a multiple of "
                f'log_every={loop.log_every} under watchdog_policy="rollback" — '
                "checkpoints must land on detection boundaries so a non-finite state "
                "is never saved"
            )
    stride = loop.inner_steps
    if stride > 1:
        for name in ("log_every", "eval_every", "checkpoint_every"):
            if getattr(loop, name) % stride:
                raise ValueError(
                    f"{name}={getattr(loop, name)} must be a multiple of inner_steps={stride}"
                )
    if loop.grad_accum_steps > 1 and stride > 1:
        raise ValueError("grad_accum_steps and inner_steps cannot both exceed 1")
    if loop.grad_accum_steps < 1 or loop.batch_size % loop.grad_accum_steps:
        raise ValueError(
            f"batch_size={loop.batch_size} must divide by "
            f"grad_accum_steps={loop.grad_accum_steps}"
        )
    defaults = LoopConfig()
    for name, slice_name in _OTHER_SLICES.items():
        if getattr(loop, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"LoopConfig.{name}={getattr(loop, name)!r} is not ported yet: it comes "
                f"with the {slice_name} slice (the port trains on one device)"
            )


def _fetch(metrics):
    """The step's metrics on the host in ONE device read: every tensor
    (scalars and the per-layer activation vectors) goes through a single
    float64 copy; counts come back as ints.  Dicts come back in sorted key
    order, as a fetched JAX pytree does."""
    tensors: list[torch.Tensor] = []

    def collect(node):
        if isinstance(node, dict):
            for key in sorted(node):
                collect(node[key])
        elif isinstance(node, torch.Tensor):
            tensors.append(node.detach())

    collect(metrics)
    values = iter(())
    if tensors:
        flat = torch.cat([t.reshape(-1).double() for t in tensors]).cpu().tolist()
        values = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, torch.Tensor):
            cast = float if node.is_floating_point() else int
            items = [cast(next(values)) for _ in range(node.numel())]
            return items if node.ndim else items[0]
        return node

    return build(metrics)


def _point_latest(ckpt_dir: Path, ckpt_path: Path) -> None:
    """Point ``latest.ckpt`` (and its sidecar) at ``ckpt_path`` with
    relative symlinks, each swapped in atomically; a file or directory left
    there by another layout is replaced."""
    for link, target in ((ckpt_dir / "latest.ckpt", ckpt_path.name),
                         (sidecar_path(ckpt_dir / "latest.ckpt"), sidecar_path(ckpt_path).name)):
        if link.is_dir() and not link.is_symlink():
            shutil.rmtree(link)
        tmp = link.with_name(f"{link.name}.tmp-link-{os.getpid()}")
        tmp.unlink(missing_ok=True)
        tmp.symlink_to(target)
        os.replace(tmp, link)


def train(
    model_config: ModelConfig,
    hparams: TrainHParams,
    loop: LoopConfig,
    train_data: np.ndarray,
    val_data: np.ndarray | None = None,
    resume_from: str | Path | None = None,
    log_fn=print,
    device: str | torch.device = "cuda",
    fault_injector: FaultInjector | None = None,
) -> dict:
    """Run the loop on ``device``; returns a summary dict (``steps``,
    ``final_train_loss``, ``final_val_loss``, ``history`` of the step
    records; ``preempted`` and ``stopped_at_step`` after a preemption,
    ``rollbacks`` after a rollback).  The parameters start from
    ``torch.Generator().manual_seed(loop.seed)`` (:func:`init_params`; other
    values than the JAX package's ``PRNGKey(seed)``), or from
    ``resume_from``, a checkpoint file or a directory holding
    ``latest.ckpt`` (the port's or the JAX package's), restored through
    :func:`load_checkpoint_with_fallback`.  ``fault_injector`` defaults to
    the ``BT_FAULTS`` plan of the environment (none: every hook is a
    no-op)."""
    dev = resolve_device(device)
    _check_loop(loop)
    check_dataset_geometry(
        train_data, model_config.context_length, loop.batch_size, name="train_data"
    )
    if val_data is not None:
        check_dataset_geometry(
            val_data, model_config.context_length, loop.batch_size, name="val_data"
        )
    injector = fault_injector if fault_injector is not None else FaultInjector.from_env()
    telemetry = Telemetry()
    setup_span = telemetry.start_span("setup")
    rollback_mode = loop.watchdog and loop.watchdog_policy == "rollback"
    on_cuda = dev.type == "cuda"

    def load_state(src: Path):
        """Fallback-aware restore shared by resume and NaN rollback:
        ``(params, opt_state, iteration, used_path)``."""
        if src.is_dir():
            src = src / "latest.ckpt"
        payload, used = load_checkpoint_with_fallback(src)
        loaded_params, loaded_opt = training_state(payload, dev)
        if loaded_opt is None:
            loaded_opt = adamw_init(loaded_params)
        return loaded_params, loaded_opt, payload["iteration"], used

    start_iteration = 0
    if resume_from is not None:
        params, opt_state, start_iteration, used_path = load_state(Path(resume_from))
        log_fn(f"resumed from {used_path} at iteration {start_iteration}")
    else:
        params = init_params(model_config, torch.Generator().manual_seed(loop.seed), device=dev)
        opt_state = adamw_init(params)

    stride = loop.inner_steps
    accum = loop.grad_accum_steps
    health = loop.health_stats
    dynamics = loop.dynamics_every > 0

    def build_steps(n: int = stride):
        """``(plain, tapped)`` steps for ``n`` updates a call (a tail shorter
        than ``inner_steps`` gets its own).  The tapped one runs only the
        updates that end on a log boundary, the only ones whose health and
        dynamics values are read: the records are those of a step tapped
        every time, without the cost on the others."""
        if n > 1:
            make, args = make_scanned_train_step, (n,)
        elif accum > 1:
            make, args = make_grad_accum_train_step, (accum,)
        else:
            make, args = make_train_step, ()
        plain = make(model_config, hparams, *args)
        if not (health or dynamics):
            return plain, plain
        return plain, make(model_config, hparams, *args, health=health, dynamics=dynamics)

    plain_step, tapped_step = build_steps()
    async_saver = (
        AsyncCheckpointer() if loop.async_checkpoint and loop.checkpoint_dir is not None else None
    )
    eval_step = make_eval_step(model_config)
    ctx = model_config.context_length
    tokens_per_step = loop.batch_size * ctx

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev, non_blocking=True)

    def run_eval() -> float:
        handle = telemetry.start_span("eval", step=iteration, batches=loop.eval_batches)
        try:
            eval_rng = np.random.default_rng(loop.seed + 1)
            losses = []
            for _ in range(loop.eval_batches):
                ex, ey = get_batch(val_data, loop.batch_size, ctx, eval_rng)
                losses.append(float(eval_step(params, to_device(ex), to_device(ey))))
            return float(np.mean(losses))
        finally:
            # Eval time is not step time.
            timer.exclude(handle.end())

    history: list[dict] = []
    timer = StepTimer(
        n_chips=1,
        flops_per_token=train_step_flops(model_config, loop.batch_size) / tokens_per_step,
        device_kind=torch.cuda.get_device_name(dev) if on_cuda else None,
    )
    sinks = MetricsLogger(jsonl_path=loop.metrics_jsonl, wandb_project=loop.wandb_project)
    # The manifest first, so every stream this loop writes is self-describing.
    telemetry.attach(sinks.log)
    telemetry.emit(
        run_manifest(
            kind="train", model_config=model_config, loop_config=loop,
            extra={"start_iteration": start_iteration, "n_chips": 1},
        )
    )
    #: The decision ring: rollbacks, preemption and watchdog transitions,
    #: dumped as kind="blackbox" on a NaN, a hang and at preemption.
    recorder = FlightRecorder("train")
    wd = None
    if loop.watchdog:
        wd = Watchdog(factor=loop.watchdog_factor, steps_per_beat=loop.log_every,
                      policy=loop.watchdog_policy, telemetry=telemetry, recorder=recorder)
        wd.start()

    def wd_pause():
        """Suspend hang detection around a known long phase (the first
        step, eval, a checkpoint save)."""
        return wd.pause() if wd is not None else contextlib.nullcontext()

    #: Built at the first attribution boundary (telemetry/attribution.py).
    attribution_probe = None
    last_loss = val_loss = float("nan")
    first_dispatch = True
    prev_sync_iteration = start_iteration
    excluded_steps = 0
    clean_exit = False
    #: SIGTERM/SIGINT set a flag polled at each step boundary (no-op off the
    #: main thread).
    stop = GracefulShutdown(recorder=recorder)
    stop.install()
    preempted: str | None = None
    rollback_budget = (
        RollbackBudget(loop.max_rollbacks, loop.recovery_min_progress) if rollback_mode else None
    )
    #: Advanced by each NaN rollback and mixed into the batch seed, so the
    #: retry samples other data over the replayed window; 0 keeps the
    #: historical seeding.
    batch_salt = 0

    def batch_rng(it: int) -> np.random.Generator:
        if batch_salt:
            return np.random.default_rng((loop.seed, it, batch_salt))
        return np.random.default_rng((loop.seed, it))

    def make_host_batch(it: int):
        """``(x, y, n)`` for iteration ``it``, numpy only (the prefetch
        worker runs it): ``n`` updates' batches, fewer than the stride only
        on the tail (a 1-update tail unstacked, as a plain step takes it)."""
        injector.on_batch_read(it)
        if stride > 1:
            n = min(stride, loop.steps - it)
            batches = [get_batch(train_data, loop.batch_size, ctx, batch_rng(it + j))
                       for j in range(n)]
            if n == 1:
                return batches[0][0], batches[0][1], n
            return np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]), n
        x, y = get_batch(train_data, loop.batch_size, ctx, batch_rng(it))
        if accum > 1:  # (B, S) -> (accum, B / accum, S) microbatches
            x = x.reshape(accum, loop.batch_size // accum, -1)
            y = y.reshape(accum, loop.batch_size // accum, -1)
        return x, y, 1

    prefetcher = BatchPrefetcher(make_host_batch, depth=loop.prefetch)

    def save_snapshot(sync: bool = False) -> Path:
        """One checkpoint at the current iteration (step file, the
        ``latest.ckpt`` links, retention); ``sync`` bypasses the async
        saver (the emergency save of a preempted run)."""
        ckpt_handle = telemetry.start_span(
            "checkpoint", step=iteration, async_save=async_saver is not None and not sync
        )
        ckpt_dir = Path(loop.checkpoint_dir)
        ckpt_path = ckpt_dir / f"step_{iteration:08d}.ckpt"
        state_kwargs = dict(
            params=params, opt_state=opt_state, iteration=iteration,
            extra={
                "val_loss": None if math.isnan(val_loss) else val_loss,
                "train_loss": None if math.isnan(last_loss) else last_loss,
                "model_config": dataclasses.asdict(model_config),
            },
        )

        def update_latest(ckpt_path=ckpt_path):
            _point_latest(ckpt_dir, ckpt_path)
            if loop.keep_checkpoints:
                gc_checkpoints(ckpt_dir, loop.keep_checkpoints, log_fn=log_fn)

        with wd_pause():
            if async_saver is not None and not sync:
                # The copy to the host happens now; pickling and IO overlap
                # the next steps.
                async_saver.save(ckpt_path, on_complete=update_latest, **state_kwargs)
            else:
                save_checkpoint(ckpt_path, **state_kwargs)
                update_latest()
        # The span covers the synchronous part: save time is not step time.
        timer.exclude(ckpt_handle.end())
        return ckpt_path

    iteration = start_iteration
    try:
        setup_span.end()
        timer.snapshot()  # set-up is not step time
        while iteration < loop.steps:
            # Chaos hooks (no-ops without a BT_FAULTS plan), then the
            # preemption poll, before more compute.
            injector.at_step(iteration)
            if stop.triggered:
                preempted = stop.signame or "signal"
                break
            hx, hy, n = prefetcher.get(iteration)
            if stride > 1 and n != stride:
                # The tail, shorter than the stride, gets its own steps.
                plain_step, tapped_step = build_steps(n)
                first_dispatch = True
            on_log = (iteration + n) % loop.log_every == 0 or iteration + n == loop.steps
            step_fn = tapped_step if on_log else plain_step
            for ahead in range(1, loop.prefetch + 1):
                if iteration + ahead * n < loop.steps:
                    prefetcher.schedule(iteration + ahead * n)
            # The copy to the card stays on the main thread.
            x, y = to_device(hx), to_device(hy)
            if first_dispatch:
                # The first step of a (re)built step function loads its
                # kernel libraries: fenced, spanned, out of the throughput
                # window, and outside hang detection.
                handle = telemetry.start_span("compile_first_step", step=iteration)
                with wd_pause():
                    params, opt_state, metrics = step_fn(params, opt_state, x, y)
                    if on_cuda:
                        torch.cuda.synchronize(dev)
                timer.exclude(handle.end())
                excluded_steps += n
                first_dispatch = False
            else:
                params, opt_state, metrics = step_fn(params, opt_state, x, y)
                timer.update(tokens_per_step * n)
            iteration += n
            if injector.active:
                # A planned NaN lands in the params here, so the detection
                # and rollback below face the real thing.
                params = injector.poison_params(params, iteration)

            is_last = iteration == loop.steps
            if iteration % loop.log_every == 0 or is_last:
                fetched = _fetch(metrics)  # the sync point
                dyn_flat = flatten_dynamics(fetched["dynamics"]) if dynamics else None
                last_loss = fetched["loss"]
                rates = timer.snapshot()
                real_steps = iteration - prev_sync_iteration - excluded_steps
                step_wall_s = rates["window_seconds"] / max(real_steps, 1)
                prev_sync_iteration = iteration
                excluded_steps = 0
                record = {
                    "step": iteration,
                    "loss": last_loss,
                    "lr": float(fetched["lr"]),
                    "grad_norm": fetched["grad_norm"],
                    "tokens_per_sec": rates["tokens_per_sec"],
                    "tokens_per_sec_per_chip": rates["tokens_per_sec_per_chip"],
                    "step_wall_s": step_wall_s,
                    "window_seconds": rates["window_seconds"],
                }
                if "mfu" in rates:
                    record["mfu"] = rates["mfu"]
                if health:
                    record.update(flatten_health(fetched["health"]))
                if dyn_flat and "first_nonfinite" in dyn_flat:
                    # The tensor path rides the step record, so the
                    # watchdog's event and error name it.
                    record["nonfinite_path"] = dyn_flat["first_nonfinite"]
                history.append(record)
                recorder.record("step", coalesce=True, step=iteration, loss=last_loss,
                                step_wall_s=round(step_wall_s, 6))
                telemetry.emit(record)
                if dyn_flat is not None and (iteration % loop.dynamics_every == 0 or is_last):
                    telemetry.emit(dynamics_record(iteration, dyn_flat))
                telemetry.emit(
                    sample_resources(
                        step=iteration,
                        params_bytes=tree_bytes_per_device(params),
                        opt_state_bytes=tree_bytes_per_device(opt_state),
                    )
                )
                log_fn(
                    f"step {iteration:>6d}  loss {last_loss:.4f}  lr {record['lr']:.2e}  "
                    f"gnorm {record['grad_norm']:.3f}  tok/s {record['tokens_per_sec']:,.0f}"
                )
                if loop.attribution_every and iteration % loop.attribution_every == 0:
                    # Exact cadence only: a run that never reaches it pays
                    # nothing.  The probe times a clone of the step (the
                    # live state is never touched), watchdog-paused and out
                    # of the throughput window.
                    from bpe_transformer_tpu_torch.telemetry.attribution import StepProbe

                    attr_handle = telemetry.start_span("attribution_probe", step=iteration,
                                                       compile_probe=attribution_probe is None)
                    with wd_pause():
                        if attribution_probe is None:
                            attribution_probe = StepProbe(
                                model_config, hparams, batch_size=loop.batch_size,
                                accum_steps=accum, inner_steps=stride, seed=loop.seed,
                                device=dev,
                            )
                        attr_record = attribution_probe.attribution_record(
                            params, opt_state, step=iteration, wall_step_s=step_wall_s,
                            t=telemetry.now(),
                        )
                    timer.exclude(attr_handle.end())
                    telemetry.emit(attr_record)
                    log_fn(
                        f"step {iteration:>6d}  attribution: compute "
                        f"{attr_record['compute_frac']:.0%}  collective "
                        f"{attr_record['collective_frac']:.0%}  host gap "
                        f"{attr_record['host_gap_frac']:.0%}"
                    )
                if wd is not None:
                    # A window of only first steps has no step time to learn.
                    wd.beat(step_wall_s if real_steps > 0 else None)
                bad_fields = nonfinite_fields(record)
                if bad_fields or record.get("nonfinite_path"):
                    # Dump, then the policy.
                    if wd is not None:
                        wd.on_nonfinite(record, bad_fields)
                    else:
                        telemetry.event("nonfinite", step=iteration, fields=bad_fields)
                    if rollback_mode:
                        detect_step = iteration
                        nonfinite_path = record.get("nonfinite_path")
                        try:
                            rollbacks = rollback_budget.note(detect_step)
                        except RollbackExhausted as exc:
                            telemetry.event("recovery_abort", step=detect_step,
                                            rollbacks=rollback_budget.total, error=str(exc))
                            raise NonFiniteError(str(exc), record=record) from exc
                        handle = telemetry.start_span("rollback", step=detect_step)
                        with wd_pause():
                            if async_saver is not None:
                                # A snapshot of the poisoned state must never
                                # land: join before reloading.
                                async_saver.wait()
                            try:
                                params, opt_state, restored, used = load_state(
                                    Path(loop.checkpoint_dir)
                                )
                            except Exception as exc:  # noqa: BLE001
                                telemetry.event("recovery_abort", step=detect_step,
                                                error=repr(exc))
                                raise NonFiniteError(
                                    "rollback failed: no valid checkpoint to restore "
                                    f"({exc}); state dumped to the telemetry stream",
                                    record=record,
                                ) from exc
                        timer.exclude(handle.end())
                        recorder.record("rollback", step=detect_step, restored_step=restored,
                                        rollbacks=rollbacks, nonfinite_path=nonfinite_path)
                        batch_salt += 1
                        # Prefetched batches carry the old salt; a fault one
                        # of them consumed surfaces here.
                        prefetcher.invalidate(reraise=True)
                        telemetry.emit({
                            "kind": "recovery",
                            "t": telemetry.now(),
                            "step": detect_step,
                            "restored_step": restored,
                            "rollbacks": rollbacks,
                            "lost_steps": detect_step - restored,
                            **({"nonfinite_path": nonfinite_path} if nonfinite_path else {}),
                        })
                        log_fn(
                            f"rollback #{rollbacks}: non-finite at step {detect_step}"
                            + (f" (localized to {nonfinite_path})" if nonfinite_path else "")
                            + f"; restored {used} at step {restored}, data window advanced"
                        )
                        iteration = restored
                        prev_sync_iteration = iteration
                        excluded_steps = 0
                        timer.snapshot()  # recovery time is not step time
                        continue

            if val_data is not None and (iteration % loop.eval_every == 0 or is_last):
                with wd_pause():
                    val_loss = run_eval()
                telemetry.emit({"step": iteration, "val_loss": val_loss})
                log_fn(f"step {iteration:>6d}  val_loss {val_loss:.4f}")

            if loop.checkpoint_dir is not None and (
                iteration % loop.checkpoint_every == 0 or is_last
            ):
                save_snapshot()

        if preempted is not None:
            # An emergency snapshot at the stop boundary, then the
            # preemption record before the footer.
            emergency = None
            state_poisoned = False
            if loop.checkpoint_dir is not None:
                if async_saver is not None:
                    async_saver.wait()
                # A signal between a NaN-making step and the boundary that
                # would have caught it must not make the poisoned state the
                # newest snapshot: check every leaf (one read) first.
                state_poisoned = not bool(torch.stack(
                    [torch.isfinite(leaf).all() for leaf in tree_leaves(params)]
                ).all())
                if not state_poisoned:
                    emergency = save_snapshot(sync=True)
            telemetry.emit({
                "kind": "preemption",
                "t": telemetry.now(),
                "step": iteration,
                "signal": preempted,
                "checkpoint": str(emergency) if emergency else None,
                **({"skipped_nonfinite_state": True} if state_poisoned else {}),
            })
            recorder.record("preemption", step=iteration, signal=preempted,
                            checkpoint=str(emergency) if emergency else None)
            telemetry.emit(recorder.blackbox(
                "preemption", context={"step": iteration, "signal": preempted}, force=True,
            ))
            log_fn(
                f"preempted by {preempted} at step {iteration}"
                + (f"; emergency checkpoint {emergency}" if emergency else "")
                + ("; emergency save SKIPPED (non-finite state — prior snapshot remains "
                   "the resume target)" if state_poisoned else "")
            )
        clean_exit = True

    finally:
        stop.uninstall()
        prefetcher.close()
        try:
            if async_saver is not None:
                # A finished run always has its final checkpoint; a failed
                # background write surfaces here.
                async_saver.close()
        finally:
            if wd is not None:
                wd.stop()
            telemetry.footer(
                steps=iteration,
                clean=clean_exit,
                watchdog_hang_events=wd.hang_events if wd is not None else 0,
                watchdog_nonfinite_events=wd.nonfinite_events if wd is not None else 0,
                **({"preempted": preempted} if preempted else {}),
            )
            sinks.close()
    summary = {
        "steps": loop.steps,
        "final_train_loss": last_loss,
        "final_val_loss": None if math.isnan(val_loss) else val_loss,
        "history": history,
    }
    if preempted is not None:
        summary["preempted"] = preempted
        summary["stopped_at_step"] = iteration
    if rollback_budget is not None and rollback_budget.total:
        summary["rollbacks"] = rollback_budget.total
    if loop.checkpoint_dir is not None:
        atomic_write_json(Path(loop.checkpoint_dir) / "summary.json", summary)
    return summary
