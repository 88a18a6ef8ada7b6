"""The single-device training loop (port of the one-device path of
``bpe_transformer_tpu/training/loop.py``): token array -> per-iteration
seeded batches -> train steps on one device -> periodic eval, logs and
checkpoints.

Batches are a pure function of ``(seed, iteration)``, as in the JAX loop, so
a resumed run samples exactly the batches an uninterrupted run would, and
the same seed gives the same batches in both packages.  The loss, learning
rate and gradient norm are read back once per ``log_every`` steps; that read
is the loop's only sync with the card between evals.

``LoopConfig`` keeps every field of the JAX package's.  Those that select
another slice's machinery (multi-GPU strategies, optimizer sharding, the
telemetry stream and its taps, the watchdog, batch prefetch, scanned inner
steps, async checkpoints, wandb) raise ``NotImplementedError`` when set to
anything but their default.
"""

from __future__ import annotations

import dataclasses
import math
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from bpe_transformer_tpu_torch.checkpointing.checkpoint import (
    load_checkpoint_with_fallback,
    save_checkpoint,
    training_state,
)
from bpe_transformer_tpu_torch.data.dataset import check_dataset_geometry, get_batch
from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import init_params
from bpe_transformer_tpu_torch.optim.adamw import adamw_init
from bpe_transformer_tpu_torch.resilience.integrity import (
    SNAPSHOT_RE,
    atomic_write_json,
    sidecar_path,
)
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    make_eval_step,
    make_grad_accum_train_step,
    make_train_step,
)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    steps: int = 1000
    batch_size: int = 32
    log_every: int = 50
    eval_every: int = 500
    eval_batches: int = 8
    checkpoint_every: int = 1000
    checkpoint_dir: str | None = None
    metrics_jsonl: str | None = None
    wandb_project: str | None = None
    health_stats: bool = False
    dynamics_every: int = 0
    attribution_every: int = 0
    watchdog: bool = False
    watchdog_factor: float = 10.0
    watchdog_policy: str = "raise"
    max_rollbacks: int = 3
    recovery_min_progress: int = 1
    #: Keep only the newest N ``step_*.ckpt`` snapshots (None: keep all).
    #: ``latest.ckpt`` is a separate copy and is never deleted.
    keep_checkpoints: int | None = None
    seed: int = 0
    parallel: str | None = None
    mesh_axes: dict | None = None
    pp_microbatches: int = 4
    sp_zigzag: bool = False
    sp_ulysses: bool = False
    inner_steps: int = 1
    opt_sharding: str | None = None
    prefetch: int = 0
    #: Microbatches per optimizer update (must divide batch_size).
    grad_accum_steps: int = 1
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
    "metrics_jsonl": "telemetry",
    "wandb_project": "telemetry",
    "health_stats": "telemetry",
    "dynamics_every": "telemetry",
    "attribution_every": "telemetry",
    "watchdog": "telemetry and resilience",
    "prefetch": "a later training slice (batch prefetch)",
    "inner_steps": "a later training slice (scanned inner steps)",
    "async_checkpoint": "a later training slice (async checkpoints)",
}


def _check_loop(loop: LoopConfig) -> None:
    defaults = LoopConfig()
    for name, slice_name in _OTHER_SLICES.items():
        if getattr(loop, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"LoopConfig.{name}={getattr(loop, name)!r} is not ported yet: it comes "
                f"with the {slice_name} slice (the port trains on one device)"
            )
    if loop.grad_accum_steps < 1 or loop.batch_size % loop.grad_accum_steps:
        raise ValueError(
            f"batch_size={loop.batch_size} must divide by "
            f"grad_accum_steps={loop.grad_accum_steps}"
        )


def _gc_checkpoints(ckpt_dir: Path, keep: int, log_fn) -> None:
    """Delete all but the newest ``keep`` step snapshots and their sidecars."""
    snaps = sorted(
        (int(m.group(1)), p)
        for p in ckpt_dir.iterdir()
        if (m := SNAPSHOT_RE.match(p.name))
    )
    for _, path in snaps[: max(len(snaps) - keep, 0)]:
        path.unlink()
        sidecar_path(path).unlink(missing_ok=True)
        log_fn(f"retention: deleted {path.name}")


def train(
    model_config: ModelConfig,
    hparams: TrainHParams,
    loop: LoopConfig,
    train_data: np.ndarray,
    val_data: np.ndarray | None = None,
    resume_from: str | Path | None = None,
    log_fn=print,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the loop on ``device``; returns a summary dict (``steps``,
    ``final_train_loss``, ``final_val_loss``, ``history`` of the log
    records).  The parameters start from ``torch.Generator().manual_seed(
    loop.seed)`` (:func:`init_params`; other values than the JAX package's
    ``PRNGKey(seed)``), or from ``resume_from``, a checkpoint file or a
    directory holding ``latest.ckpt`` (the port's or the JAX package's),
    restored through :func:`load_checkpoint_with_fallback`: a snapshot that
    fails its CRC32 check is quarantined and the newest valid earlier one
    is loaded."""
    dev = resolve_device(device)
    _check_loop(loop)
    check_dataset_geometry(
        train_data, model_config.context_length, loop.batch_size, name="train_data"
    )
    if val_data is not None:
        check_dataset_geometry(
            val_data, model_config.context_length, loop.batch_size, name="val_data"
        )

    start_iteration = 0
    opt_state = None
    if resume_from is not None:
        src = Path(resume_from)
        if src.is_dir():
            src = src / "latest.ckpt"
        payload, used = load_checkpoint_with_fallback(src)
        params, opt_state = training_state(payload, dev)
        start_iteration = payload["iteration"]
        log_fn(f"resumed from {used} at iteration {start_iteration}")
    else:
        params = init_params(model_config, torch.Generator().manual_seed(loop.seed), device=dev)
    if opt_state is None:
        opt_state = adamw_init(params)

    accum = loop.grad_accum_steps
    if accum > 1:
        step_fn = make_grad_accum_train_step(model_config, hparams, accum)
    else:
        step_fn = make_train_step(model_config, hparams)
    eval_step = make_eval_step(model_config)
    ctx = model_config.context_length
    tokens_per_step = loop.batch_size * ctx

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev, non_blocking=True)

    def run_eval() -> float:
        eval_rng = np.random.default_rng(loop.seed + 1)
        losses = []
        for _ in range(loop.eval_batches):
            ex, ey = get_batch(val_data, loop.batch_size, ctx, eval_rng)
            losses.append(float(eval_step(params, to_device(ex), to_device(ey))))
        return float(np.mean(losses))

    def save_snapshot() -> None:
        ckpt_dir = Path(loop.checkpoint_dir)
        path = ckpt_dir / f"step_{iteration:08d}.ckpt"
        save_checkpoint(
            path, params=params, opt_state=opt_state, iteration=iteration,
            extra={
                "val_loss": None if math.isnan(val_loss) else val_loss,
                "train_loss": None if math.isnan(last_loss) else last_loss,
                "model_config": dataclasses.asdict(model_config),
            },
        )
        latest = ckpt_dir / "latest.ckpt"
        shutil.copyfile(path, latest)
        shutil.copyfile(sidecar_path(path), sidecar_path(latest))
        if loop.keep_checkpoints:
            _gc_checkpoints(ckpt_dir, loop.keep_checkpoints, log_fn)

    history: list[dict] = []
    last_loss = val_loss = float("nan")
    iteration = start_iteration
    # Throughput window between log records; eval and checkpoint time is
    # excluded from it.
    window_start, window_steps, excluded = time.perf_counter(), 0, 0.0
    while iteration < loop.steps:
        rng = np.random.default_rng((loop.seed, iteration))
        x, y = get_batch(train_data, loop.batch_size, ctx, rng)
        if accum > 1:  # (B, S) -> (accum, B / accum, S) microbatches
            x = x.reshape(accum, loop.batch_size // accum, -1)
            y = y.reshape(accum, loop.batch_size // accum, -1)
        params, opt_state, metrics = step_fn(params, opt_state, to_device(x), to_device(y))
        iteration += 1
        window_steps += 1
        is_last = iteration == loop.steps

        if iteration % loop.log_every == 0 or is_last:
            last_loss = float(metrics["loss"])  # the sync point
            elapsed = time.perf_counter() - window_start - excluded
            record = {
                "step": iteration,
                "loss": last_loss,
                "lr": metrics["lr"],
                "grad_norm": float(metrics["grad_norm"]),
                "tokens_per_sec": tokens_per_step * window_steps / elapsed,
                "step_wall_s": elapsed / window_steps,
            }
            history.append(record)
            log_fn(
                f"step {iteration:>6d}  loss {last_loss:.4f}  lr {record['lr']:.2e}  "
                f"gnorm {record['grad_norm']:.3f}  tok/s {record['tokens_per_sec']:,.0f}"
            )
            window_start, window_steps, excluded = time.perf_counter(), 0, 0.0
        t0 = time.perf_counter()
        if val_data is not None and (iteration % loop.eval_every == 0 or is_last):
            val_loss = run_eval()
            log_fn(f"step {iteration:>6d}  val_loss {val_loss:.4f}")
        if loop.checkpoint_dir is not None and (
            iteration % loop.checkpoint_every == 0 or is_last
        ):
            save_snapshot()
        excluded += time.perf_counter() - t0

    summary = {
        "steps": loop.steps,
        "final_train_loss": last_loss,
        "final_val_loss": None if math.isnan(val_loss) else val_loss,
        "history": history,
    }
    if loop.checkpoint_dir is not None:
        atomic_write_json(Path(loop.checkpoint_dir) / "summary.json", summary)
    return summary
