"""Train and eval steps (port of the single-device path of
``bpe_transformer_tpu/training/train_step.py``): forward, loss, backward,
the ``grads_dtype`` round trip, global-norm clipping, the cosine schedule
and AdamW, with the metrics ``loss``, ``lr`` and ``grad_norm``.

PyTorch runs eagerly, so the ``make_*`` builders return plain Python
functions where the JAX package returns jitted ones.  ``loss`` and
``grad_norm`` stay on the step's device (reading them is the caller's sync
point, as a metric fetch is in the JAX loop); ``lr`` is a Python float.
``health=True`` and ``dynamics=True`` append the taps of
``telemetry/health.py`` and ``telemetry/dynamics.py`` to the metrics, as
device tensors: no tap reads a value back.  :func:`make_scanned_train_step`
runs ``n`` updates a call (the JAX package's ``lax.scan``; here a Python
loop with no host sync between the updates).  The multi-device variants
(``reduce_axis``, ZeRO-1) belong to the multi-GPU slice and raise; sequence
parallelism on one card is ``parallel/sp.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import (
    forward,
    forward_hidden,
    forward_hidden_stats,
    lm_head_weight,
)
from bpe_transformer_tpu_torch.ops.core import head_logits
from bpe_transformer_tpu_torch.ops.grad import clip_by_global_norm
from bpe_transformer_tpu_torch.ops.losses import cross_entropy, lm_loss
from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_update
from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
from bpe_transformer_tpu_torch.telemetry.dynamics import dynamics_from_parts, per_tensor_nonfinite
from bpe_transformer_tpu_torch.telemetry.health import health_metrics
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


def make_loss_fn(config: ModelConfig, with_aux: bool = False, with_stats: bool = False) -> Callable:
    """``loss_fn(params, x, y)``: mean LM cross-entropy, through the chunked
    loss when ``config.loss_chunk`` is set, plus ``router_aux_weight`` times
    the MoE load-balance loss for an MoE config.  ``with_aux=True`` returns
    ``(loss, aux)`` with the raw aux (0 for dense FFNs), which the health
    step exports; ``with_stats=True`` (supersedes ``with_aux``) returns
    ``(loss, (aux, act_stats))`` with the per-layer activation statistics of
    :func:`forward_hidden_stats` (the same forward, plus the taps)."""
    is_moe = config.ffn_type == "moe"
    hidden_fn = forward_hidden_stats if with_stats else forward_hidden

    def loss_fn(params, x, y):
        hidden, aux, *act_stats = hidden_fn(params, x, config)
        head_w = lm_head_weight(params, config)
        if config.loss_chunk:
            loss = lm_loss(hidden, head_w, y, config.loss_chunk)
        else:
            loss = cross_entropy(head_logits(hidden, head_w), y)
        if is_moe:
            loss = loss + config.router_aux_weight * aux
        if with_stats:
            return loss, (aux, act_stats[0])
        return (loss, aux) if with_aux else loss

    return loss_fn


def value_and_grad(loss_fn: Callable, has_aux: bool = False) -> Callable:
    """``(params, x, y) -> (loss, grads)``, ``grads`` in the parameter
    tree's structure (the counterpart of ``jax.value_and_grad``; with
    ``has_aux`` the loss function returns ``(loss, aux)`` and the result is
    ``((loss, aux), grads)``).  The parameters are the graph's leaves; no
    ``.grad`` is accumulated.  A leaf the loss does not read (``w3`` of a
    two-matrix FFN) gets a zero gradient, as in JAX."""

    def wrapped(params, x, y):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            out = loss_fn(params, x, y)
            loss = out[0] if has_aux else out
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = tree_unflatten(params, grads)
        if has_aux:
            return (loss.detach(), out[1]), grads
        return loss.detach(), grads

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
                f"{name} is not ported yet: it comes with the multi-GPU training slice "
                "(the port trains on one device)"
            )


def _update(params, opt_state: AdamWState, loss, grads, hparams: TrainHParams,
            health: bool = False, dynamics: bool = False, act_stats=None, moe_aux=None):
    """Clip, schedule and AdamW, with the optional taps.  The dynamics tap
    counts the input params' non-finites before AdamW rewrites them in
    place and takes the update norms from ``adamw_update``'s
    ``delta_norms``: no copy of the weights is kept.  ``moe_aux``, when
    given, joins the health stats as ``moe_aux``."""
    grads = _reduce_grads(grads, hparams.grads_dtype)
    # Dynamics reports the pre-clip gradient magnitudes.
    raw_grads = grads
    nonfinite_params = per_tensor_nonfinite(params) if dynamics else None
    grads, grad_norm = clip_by_global_norm(grads, hparams.grad_clip_norm)
    lr = cosine_schedule(
        int(opt_state.step),
        hparams.max_learning_rate,
        hparams.min_learning_rate,
        hparams.warmup_iters,
        hparams.cosine_cycle_iters,
    )
    delta_norms = [] if dynamics else None
    params, opt_state = adamw_update(
        params, grads, opt_state, lr,
        betas=hparams.betas, eps=hparams.eps, weight_decay=hparams.weight_decay,
        delta_norms=delta_norms,
    )
    metrics = {"loss": loss.float(), "lr": lr, "grad_norm": grad_norm}
    if health:
        # Post-update params: an optimizer-made non-finite shows the same step.
        metrics["health"] = health_metrics(loss, grads, params)
        if moe_aux is not None:
            metrics["health"]["moe_aux"] = moe_aux.detach().float()
    if dynamics:
        metrics["dynamics"] = dynamics_from_parts(
            raw_grads, params, delta_norms, nonfinite_params, act_stats
        )
    return params, opt_state, metrics


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
    ``opt_state.step`` before AdamW increments it.  ``health`` adds
    ``metrics["health"]`` (``telemetry/health.py``), ``dynamics``
    ``metrics["dynamics"]`` (``telemetry/dynamics.py``, with the activation
    statistics tapped from the differentiated forward).  An MoE config's
    health stats also carry ``moe_aux``, the raw load-balance loss."""
    _not_ported(reduce_axis=reduce_axis, zero1_shards=zero1_shards)
    with_aux = health and config.ffn_type == "moe"
    grad_fn = value_and_grad(make_loss_fn(config, with_aux=with_aux, with_stats=dynamics),
                             has_aux=dynamics or with_aux)

    def step(params, opt_state: AdamWState, x, y):
        act_stats = moe_aux = None
        if dynamics:
            (loss, (aux, act_stats)), grads = grad_fn(params, x, y)
            moe_aux = aux if with_aux else None
        elif with_aux:
            (loss, moe_aux), grads = grad_fn(params, x, y)
        else:
            loss, grads = grad_fn(params, x, y)
        return _update(params, opt_state, loss, grads, hparams, health, dynamics, act_stats,
                       moe_aux)

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
    ``xs, ys (accum_steps, micro_batch, seq)``.  The taps read the
    accumulated gradients; dynamics carries no activation statistics and
    health no ``moe_aux`` on this path, as in the JAX package."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _not_ported(reduce_axis=reduce_axis, zero1_shards=zero1_shards)
    grad_fn = value_and_grad(make_loss_fn(config))

    def step(params, opt_state: AdamWState, xs, ys):
        loss, grads = accumulate_grads(grad_fn, params, xs, ys, accum_steps)
        return _update(params, opt_state, loss, grads, hparams, health, dynamics)

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


def make_scanned_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    inner_steps: int,
    health: bool = False,
    dynamics: bool = False,
) -> Callable:
    """``inner_steps`` optimizer updates a call: ``(params, opt_state, xs,
    ys) -> (params, opt_state, metrics)`` with a leading ``(inner_steps,)``
    dim on ``xs``/``ys``; ``metrics`` are the last update's, as the JAX
    package's ``lax.scan`` returns them.  The updates are dispatched back to
    back with no host sync between them, and only the last one runs the
    taps: the others' values would be thrown away."""
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    plain = train_step_fn(config, hparams)
    last = train_step_fn(config, hparams, health=health, dynamics=dynamics)

    def multi(params, opt_state: AdamWState, xs, ys):
        if xs.shape[0] != inner_steps or ys.shape[0] != inner_steps:
            raise ValueError(
                f"scanned step wants (inner_steps={inner_steps}, batch, seq) token ids, "
                f"got xs {tuple(xs.shape)}"
            )
        for i in range(inner_steps - 1):
            params, opt_state, _ = plain(params, opt_state, xs[i], ys[i])
        return last(params, opt_state, xs[-1], ys[-1])

    return multi


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
