"""Train steps across cards (port of ``bpe_transformer_tpu/parallel/train_step.py``).

:func:`make_dp_train_step` runs the shared update body
(``training.train_step.train_step_fn``) on every rank of a process-group
mesh, one rank per card: every rank holds the whole parameters, takes its
rows of the global batch (:func:`shard_batch`), computes its gradients and
all-reduces their mean over the ``data`` axis (one collective over one flat
buffer) before the same AdamW update runs everywhere; or, with
``opt_sharding="zero1"``, reduce-scatters them into ZeRO-1's sharded update
(``optim/sharded.py``).  :func:`make_gspmd_train_step` runs the GSPMD
strategies (``fsdp``, ``tp``, ``fsdp_tp``, ``dp_tp``, ``ep``, ``dp_ep``,
``fsdp_ep``, ...): every rank holds
its blocks of the parameters and moments and the step writes the
collectives that XLA derives in the JAX package (``parallel/gspmd.py``).
The collectives are NCCL's on the card and gloo's on the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    grad_accum_step_fn,
    scanned_step_fn,
    train_step_fn,
)

def _multi_step_body(
    config: ModelConfig,
    hparams: TrainHParams,
    accum_steps: int,
    inner_steps: int,
    reduce_axis,
    health: bool = False,
    dynamics: bool = False,
    zero1_shards: int | None = None,
    layout=None,
) -> tuple[Callable, bool]:
    """``(body, stacked)``: the per-rank update for the accumulation or
    scan mode, and whether batches carry a leading stacked dim
    (``(accum|inner, micro_batch, seq)`` instead of ``(batch, seq)``)."""
    if accum_steps > 1 and inner_steps > 1:
        raise ValueError("accum_steps and inner_steps cannot both exceed 1")
    if accum_steps > 1:
        return grad_accum_step_fn(config, hparams, accum_steps, reduce_axis, health=health,
                                  dynamics=dynamics, zero1_shards=zero1_shards,
                                  layout=layout), True
    if inner_steps > 1:
        return scanned_step_fn(config, hparams, inner_steps, reduce_axis, health=health,
                               dynamics=dynamics, zero1_shards=zero1_shards,
                               layout=layout), True
    return train_step_fn(config, hparams, reduce_axis, health=health, dynamics=dynamics,
                         zero1_shards=zero1_shards, layout=layout), False


def make_dp_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    mesh,
    axis: str = "data",
    accum_steps: int = 1,
    inner_steps: int = 1,
    health: bool = False,
    dynamics: bool = False,
    opt_sharding: str | None = None,
) -> Callable:
    """Data-parallel step with an explicit gradient all-reduce over
    ``axis`` of ``mesh`` (:func:`parallel.mesh.make_mesh`): ``(params,
    opt_state, x, y) -> (params, opt_state, metrics)`` on this rank's batch
    rows (:func:`shard_batch`), the parameters and moments updated in
    place; every rank ends the step with the same parameters and metrics.

    ``accum_steps > 1``: each rank accumulates its microbatches and the
    all-reduce runs once per update; batches are ``(accum_steps,
    micro_batch, seq)`` with the micro batch split on ``axis``.
    ``inner_steps > 1``: several updates a call, each with its own
    all-reduce; batches ``(inner_steps, batch, seq)``.
    ``opt_sharding="zero1"`` replaces the all-reduce and the replicated
    AdamW with ZeRO-1: ``opt_state`` is this rank's
    :class:`optim.sharded.ShardedAdamWState` row (``sharded_adamw_init(...,
    mesh=mesh)`` or ``restore_opt_state``)."""
    if opt_sharding not in (None, "zero1"):
        raise ValueError(f"unknown opt_sharding: {opt_sharding!r}")
    reduce_axis = mesh.axis(axis)
    n_shards = reduce_axis.size if opt_sharding == "zero1" else None
    body, _ = _multi_step_body(config, hparams, accum_steps, inner_steps, reduce_axis,
                               health=health, dynamics=dynamics, zero1_shards=n_shards)
    return body


def make_gspmd_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    mesh,
    strategy: str = "fsdp",
    example_params=None,
    accum_steps: int = 1,
    inner_steps: int = 1,
    health: bool = False,
    dynamics: bool = False,
    opt_sharding: str | None = None,
) -> Callable:
    """The step of a GSPMD strategy on a process-group mesh: ``(params,
    opt_state, x, y) -> (params, opt_state, metrics)`` on this rank's
    blocks of the parameters (:func:`parallel.sharding.shard_params` under
    the strategy's specs) and of the moments (the same specs, or
    ``zero1_opt_specs`` under ``opt_sharding="zero1"``; ``step.layout
    .init_opt_state()`` makes them), on this rank's batch rows
    (:func:`shard_batch`), updated in place.

    ``example_params`` is a tree with the whole shapes (``meta`` tensors
    do: ``models.transformer.abstract_params``), from which the specs come.
    ``accum_steps``/``inner_steps`` stack the batches as the dp step's do.
    The JAX function's errors."""
    from bpe_transformer_tpu_torch.parallel.gspmd import GspmdLayout

    if example_params is None:
        raise ValueError("example_params is required to derive shardings")
    if opt_sharding not in (None, "zero1"):
        raise ValueError(f"unknown opt_sharding: {opt_sharding!r}")
    layout = GspmdLayout(config, mesh, strategy, opt_sharding=opt_sharding,
                         grads_dtype=hparams.grads_dtype, full=example_params)
    body, _ = _multi_step_body(config, hparams, accum_steps, inner_steps, None, health=health,
                               dynamics=dynamics, layout=layout)

    def step(params, opt_state, x, y):
        return body(params, opt_state, x, y)

    step.layout = layout
    return step


def shard_batch(batch, mesh, axis: str = "data", stacked: bool = False,
                device: str | torch.device | None = None):
    """This rank's rows of a global host batch (numpy or tensors; one array
    or a tuple), on ``device`` (the mesh's card by default): ``(batch,
    seq)`` arrays split on their first dim along ``axis``, ``stacked=True``
    arrays ``(accum|inner, batch, seq)`` on their second.  Only the rank's
    rows are copied to the card.  On a mesh without ``axis`` (pure tensor
    parallelism) every rank takes the whole batch."""
    dev = torch.device(device) if device is not None else mesh.device
    if axis not in mesh.shape:

        def whole(a):
            if isinstance(a, torch.Tensor):
                return a.contiguous().to(dev)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)

        return tuple(whole(a) for a in batch) if isinstance(batch, (tuple, list)) else whole(batch)
    ax = mesh.axis(axis)

    def place(a):
        dim = 1 if stacked else 0
        rows = a.shape[dim]
        if rows % ax.size:
            raise ValueError(
                f"batch dim {rows} must divide by the {axis!r} mesh axis ({ax.size})"
            )
        n = rows // ax.size
        part = a[:, ax.index * n:(ax.index + 1) * n] if stacked else a[ax.index * n:
                                                                     (ax.index + 1) * n]
        if isinstance(part, torch.Tensor):
            return part.contiguous().to(dev)
        return torch.from_numpy(np.ascontiguousarray(part)).to(dev, non_blocking=True)

    if isinstance(batch, (tuple, list)):
        return tuple(place(a) for a in batch)
    return place(batch)
