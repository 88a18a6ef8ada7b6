"""Train and eval steps (port of the single-device path of
``bpe_transformer_tpu/training/train_step.py``): forward, loss, backward,
the ``grads_dtype`` round trip, global-norm clipping, the cosine schedule
and AdamW, with the metrics ``loss``, ``lr`` and ``grad_norm``.

PyTorch runs eagerly, so the ``make_*`` builders return plain Python
functions where the JAX package returns jitted ones.  ``loss`` and
``grad_norm`` stay on the step's device (reading them is the caller's sync
point, as a metric fetch is in the JAX loop); ``lr`` is a Python float.
The multi-device variants (``reduce_axis``, ZeRO-1) and the health and
dynamics taps belong to later slices and raise; sequence parallelism on one
card is ``parallel/sp.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import (
    forward,
    forward_hidden,
    lm_head_weight,
)
from bpe_transformer_tpu_torch.ops.grad import clip_by_global_norm
from bpe_transformer_tpu_torch.ops.losses import cross_entropy, lm_loss
from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_update
from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """Optimization hyperparameters (the JAX package's defaults)."""

    max_learning_rate: float = 3e-4
    min_learning_rate: float = 3e-5
    warmup_iters: int = 100
    cosine_cycle_iters: int = 10_000
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    #: Width of the gradient tree at the reduction boundary: ``"bfloat16"``
    #: rounds every gradient to bfloat16 and widens it back to float32
    #: before clipping (the JAX package applies the round trip on a single
    #: device too, so one setting means one set of numerics everywhere).
    grads_dtype: str = "float32"

    def __post_init__(self):
        if self.grads_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f'grads_dtype={self.grads_dtype!r} must be "float32" or "bfloat16"'
            )


def make_loss_fn(config: ModelConfig) -> Callable:
    """``loss_fn(params, x, y)``: mean LM cross-entropy, through the chunked
    loss when ``config.loss_chunk`` is set."""
    if config.ffn_type == "moe":
        raise NotImplementedError(
            'ffn_type="moe" is not ported yet: it comes with the multi-GPU training slice'
        )
    if config.loss_chunk:

        def loss_fn(params, x, y):
            hidden, _ = forward_hidden(params, x, config)
            return lm_loss(hidden, lm_head_weight(params, config), y, config.loss_chunk)

    else:

        def loss_fn(params, x, y):
            return cross_entropy(forward(params, x, config), y)

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, x, y) -> (loss, grads)``, ``grads`` in the parameter
    tree's structure (the counterpart of ``jax.value_and_grad``).  The
    parameters are the graph's leaves; no ``.grad`` is accumulated.  A leaf
    the loss does not read (``w3`` of a two-matrix FFN) gets a zero
    gradient, as in JAX."""

    def wrapped(params, x, y):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = loss_fn(params, x, y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    return wrapped


def _reduce_grads(grads, grads_dtype: str):
    """The ``grads_dtype`` round trip (the single-device half of the JAX
    package's reduction boundary)."""
    if grads_dtype == "float32":
        return grads
    narrow = getattr(torch, grads_dtype)
    return tree_map(lambda g: g.to(narrow).float(), grads)


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported yet: the port trains on one device without the "
                "health/dynamics taps (multi-GPU and telemetry are later slices)"
            )


def _update(params, opt_state: AdamWState, loss, grads, hparams: TrainHParams):
    grads = _reduce_grads(grads, hparams.grads_dtype)
    grads, grad_norm = clip_by_global_norm(grads, hparams.grad_clip_norm)
    lr = cosine_schedule(
        int(opt_state.step),
        hparams.max_learning_rate,
        hparams.min_learning_rate,
        hparams.warmup_iters,
        hparams.cosine_cycle_iters,
    )
    params, opt_state = adamw_update(
        params, grads, opt_state, lr,
        betas=hparams.betas, eps=hparams.eps, weight_decay=hparams.weight_decay,
    )
    return params, opt_state, {"loss": loss.float(), "lr": lr, "grad_norm": grad_norm}


def train_step_fn(
    config: ModelConfig,
    hparams: TrainHParams,
    reduce_axis: str | None = None,
    health: bool = False,
    dynamics: bool = False,
    zero1_shards: int | None = None,
) -> Callable:
    """The update ``(params, opt_state, x, y) -> (params, opt_state,
    metrics)`` on one device.  The learning rate is read at
    ``opt_state.step`` before AdamW increments it."""
    _not_ported(reduce_axis=reduce_axis, health=health, dynamics=dynamics,
                zero1_shards=zero1_shards)
    grad_fn = value_and_grad(make_loss_fn(config))

    def step(params, opt_state: AdamWState, x, y):
        loss, grads = grad_fn(params, x, y)
        return _update(params, opt_state, loss, grads, hparams)

    return step


def make_train_step(
    config: ModelConfig, hparams: TrainHParams, health: bool = False, dynamics: bool = False
) -> Callable:
    """The single-device train step (:func:`train_step_fn`); parameters and
    moments are updated in place."""
    return train_step_fn(config, hparams, health=health, dynamics=dynamics)


def accumulate_grads(grad_fn, params, xs, ys, accum_steps: int, context: str = "",
                     layout: str = "micro_batch, seq"):
    """``(loss, grads)`` averaged over the leading microbatch dim of ``xs,
    ys (accum_steps, micro_batch, seq)``: one forward and backward per
    microbatch, gradients summed in float32, so the result equals one step
    on the concatenated batch.  ``layout`` names the dims of one microbatch
    (the sp step's carry a leading ring-rank dim)."""
    ndim = 1 + len(layout.split(","))
    if xs.ndim != ndim or ys.ndim != ndim or xs.shape[0] != accum_steps:
        raise ValueError(
            f"{context or 'grad-accum step'} wants (accum_steps={accum_steps}, "
            f"{layout}) token ids, got xs {tuple(xs.shape)}"
        )
    loss_sum = None
    grad_sum = None
    for i in range(accum_steps):
        loss, grads = grad_fn(params, xs[i], ys[i])
        grads = tree_map(lambda g: g.float(), grads)
        if grad_sum is None:
            loss_sum, grad_sum = loss.float(), grads
        else:
            loss_sum = loss_sum + loss
            grad_sum = tree_map(torch.add, grad_sum, grads)
    inv = 1.0 / accum_steps
    return loss_sum * inv, tree_map(lambda g: g * inv, grad_sum)


def grad_accum_step_fn(
    config: ModelConfig,
    hparams: TrainHParams,
    accum_steps: int,
    reduce_axis: str | None = None,
    health: bool = False,
    dynamics: bool = False,
    zero1_shards: int | None = None,
) -> Callable:
    """One optimizer update from ``accum_steps`` microbatch gradients:
    ``(params, opt_state, xs, ys) -> (params, opt_state, metrics)`` with
    ``xs, ys (accum_steps, micro_batch, seq)``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _not_ported(reduce_axis=reduce_axis, health=health, dynamics=dynamics,
                zero1_shards=zero1_shards)
    grad_fn = value_and_grad(make_loss_fn(config))

    def step(params, opt_state: AdamWState, xs, ys):
        loss, grads = accumulate_grads(grad_fn, params, xs, ys, accum_steps)
        return _update(params, opt_state, loss, grads, hparams)

    return step


def make_grad_accum_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    accum_steps: int,
    health: bool = False,
    dynamics: bool = False,
) -> Callable:
    """The single-device grad-accumulation step (:func:`grad_accum_step_fn`)."""
    return grad_accum_step_fn(config, hparams, accum_steps, health=health, dynamics=dynamics)


def make_eval_step(config: ModelConfig) -> Callable:
    """Pure cross-entropy eval ``(params, x, y) -> loss`` without a graph,
    honouring ``loss_chunk_size`` as the train step does."""
    if config.loss_chunk:

        def eval_loss(params, x, y):
            hidden, _ = forward_hidden(params, x, config)
            return lm_loss(hidden, lm_head_weight(params, config), y, config.loss_chunk)

    else:

        def eval_loss(params, x, y):
            return cross_entropy(forward(params, x, config), y)

    return torch.no_grad()(eval_loss)
