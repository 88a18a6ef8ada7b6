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
loop with no host sync between the updates).

``reduce_axis`` is a data axis of a process-group mesh
(:meth:`parallel.mesh.Mesh.axis`): the step all-reduces the mean of the
gradients (one collective over one flat buffer, at the ``grads_dtype``
width), of the loss and of ``moe_aux``, and the taps' activation
statistics reduce as JAX's do (means, a max, a sum).  ``zero1_shards``
swaps the update for ZeRO-1 (:mod:`optim.sharded`).  ``layout`` (a
:class:`parallel.gspmd.GspmdLayout`) runs the step on this rank's blocks of
the parameters and moments (FSDP, tensor parallelism): the sharded forward
and backward, then :func:`_gspmd_update`.  These are the bodies that
:mod:`parallel.train_step` and :mod:`parallel.sp` run on each rank.

Under a ``torch.profiler`` the step marks its phases with
:func:`telemetry.spans.phase` ranges: ``bpt.train_step`` around each update,
and under it ``bpt.forward``, ``bpt.backward``, ``bpt.grad_reduce``,
``bpt.clip`` and ``bpt.adamw`` (ZeRO-1 and the sharded update add
``bpt.param_gather``); with no profiler each costs one flag check.
"""

from __future__ import annotations

import contextlib
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
from bpe_transformer_tpu_torch.ops.grad import scale_grads
from bpe_transformer_tpu_torch.ops.losses import cross_entropy, lm_loss
from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_update, clip_adamw_update
from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
from bpe_transformer_tpu_torch.optim.sharded import sharded_adamw_update
from bpe_transformer_tpu_torch.telemetry.dynamics import dynamics_from_parts, per_tensor_nonfinite
from bpe_transformer_tpu_torch.telemetry.health import health_metrics
from bpe_transformer_tpu_torch.telemetry.spans import phase
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


def make_loss_fn(config: ModelConfig, with_aux: bool = False, with_stats: bool = False,
                 shard=None) -> Callable:
    """``loss_fn(params, x, y)``: mean LM cross-entropy, through the chunked
    loss when ``config.loss_chunk`` is set, plus ``router_aux_weight`` times
    the MoE load-balance loss for an MoE config.  ``with_aux=True`` returns
    ``(loss, aux)`` with the raw aux (0 for dense FFNs), which the health
    step exports; ``with_stats=True`` (supersedes ``with_aux``) returns
    ``(loss, (aux, act_stats))`` with the per-layer activation statistics of
    :func:`forward_hidden_stats` (the same forward, plus the taps).
    ``shard`` (a :class:`parallel.gspmd.GspmdLayout`): the loss of this
    rank's rows on this rank's blocks of the parameters."""
    is_moe = config.ffn_type == "moe"
    hidden_fn = forward_hidden_stats if with_stats else forward_hidden

    def loss_fn(params, x, y):
        hooks = shard.saved_tensors_hooks() if shard is not None else contextlib.nullcontext()
        with hooks:
            hidden, aux, *act_stats = hidden_fn(params, x, config, shard=shard)
            if shard is not None:
                loss = shard.lm_loss(params, hidden, y, config.loss_chunk)
            elif config.loss_chunk:
                loss = lm_loss(hidden, lm_head_weight(params, config), y, config.loss_chunk)
            else:
                loss = cross_entropy(head_logits(hidden, lm_head_weight(params, config)), y)
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
            with phase("forward"):
                out = loss_fn(params, x, y)
            loss = out[0] if has_aux else out
            with phase("backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = tree_unflatten(params, grads)
        if has_aux:
            return (loss.detach(), out[1]), grads
        return loss.detach(), grads

    return wrapped


def _reduce_grads(grads, reduce_axis, grads_dtype: str):
    """The gradient-reduction boundary: round to ``grads_dtype``, mean over
    ``reduce_axis`` (one all-reduce of every leaf in one flat buffer at
    that width), widen back to float32.  The round trip applies on one
    device too, so one ``grads_dtype`` means one set of numerics."""
    narrow = getattr(torch, grads_dtype)
    if reduce_axis is None:
        if grads_dtype == "float32":
            return grads
        return tree_map(lambda g: g.to(narrow).float(), grads)
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).to(narrow) for g in leaves])
    reduce_axis.pmean_(flat)
    out, offset = [], 0
    for g in leaves:
        out.append(flat[offset:offset + g.numel()].view(g.shape).float())
        offset += g.numel()
    return tree_unflatten(grads, out)


def _pmean_scalars(reduce_axis, *values):
    """The mean over ``reduce_axis`` of 0-d tensors, in one all-reduce."""
    stacked = reduce_axis.pmean_(torch.stack([v.detach().float() for v in values]))
    return tuple(stacked.unbind())


def _reduce_act_stats(act_stats: dict, reduce_axis) -> dict:
    """Per-rank activation stats folded to global ones, as JAX's under a
    mapped axis: means average, absmax maxes, non-finite counts sum."""
    return {
        "rms": reduce_axis.pmean_(act_stats["rms"].float().clone()),
        "absmax": reduce_axis.pmax_(act_stats["absmax"].float().clone()),
        "nonfinite": reduce_axis.psum_(act_stats["nonfinite"].clone()),
        "attn_entropy": reduce_axis.pmean_(act_stats["attn_entropy"].float().clone()),
    }


def _check_zero1(zero1_shards, reduce_axis, health, dynamics, context):
    """A ZeRO-1 request needs a data axis to scatter over and never builds
    the global gradient tree the taps read (the JAX package's errors)."""
    if zero1_shards is None:
        return
    if reduce_axis is None:
        raise ValueError(
            f"{context}: zero1_shards requires a mapped reduce_axis (the "
            "sharded update reduce-scatters gradients over the dp axis)"
        )
    if health or dynamics:
        raise ValueError(
            f"{context}: health/dynamics stats are not supported with the "
            "ZeRO-1 sharded update — they read the global gradient tree, "
            "which the reduce-scatter path deliberately never builds; "
            "drop --health-stats/--dynamics-every or --opt-sharding"
        )


def _schedule(opt_state, hparams: TrainHParams) -> float:
    return cosine_schedule(
        int(opt_state.step),
        hparams.max_learning_rate,
        hparams.min_learning_rate,
        hparams.warmup_iters,
        hparams.cosine_cycle_iters,
    )


def _zero1_update(params, opt_state, loss, grads, hparams: TrainHParams, reduce_axis,
                  n_shards: int):
    """The ZeRO-1 tail of a step: the loss's mean over the axis, the
    schedule, then reduce-scatter, the row's AdamW and the all-gather
    (:func:`optim.sharded.sharded_adamw_update`)."""
    with phase("grad_reduce"):
        (loss,) = _pmean_scalars(reduce_axis, loss)
    lr = _schedule(opt_state, hparams)
    params, opt_state, grad_norm = sharded_adamw_update(
        params, grads, opt_state, lr, axis=reduce_axis, n_shards=n_shards,
        betas=hparams.betas, eps=hparams.eps, weight_decay=hparams.weight_decay,
        grad_clip_norm=hparams.grad_clip_norm, grads_dtype=hparams.grads_dtype,
    )
    return params, opt_state, {"loss": loss, "lr": lr, "grad_norm": grad_norm}


def _update(params, opt_state: AdamWState, loss, grads, hparams: TrainHParams,
            health: bool = False, dynamics: bool = False, act_stats=None, moe_aux=None,
            reduce_axis=None):
    """Reduce, clip, schedule and AdamW, with the optional taps.  With
    ``reduce_axis`` the gradients, the loss, ``moe_aux`` and the activation
    stats are first reduced over it (``grads``, ``loss`` and ``moe_aux``
    are this rank's).  The clip and AdamW are one pass
    (:func:`optim.adamw.clip_adamw_update`: on the card two kernel launches
    for the whole tree); the clipped gradients are built only for the
    health tap.  The dynamics tap counts the input params' non-finites
    before AdamW rewrites them in place and takes the update norms from the
    update's ``delta_norms``: no copy of the weights is kept.  ``moe_aux``,
    when given, joins the health stats as ``moe_aux``."""
    with phase("grad_reduce"):
        grads = _reduce_grads(grads, reduce_axis, hparams.grads_dtype)
        if reduce_axis is not None:
            if moe_aux is not None:
                loss, moe_aux = _pmean_scalars(reduce_axis, loss, moe_aux)
            else:
                (loss,) = _pmean_scalars(reduce_axis, loss)
            if act_stats is not None:
                act_stats = _reduce_act_stats(act_stats, reduce_axis)
    nonfinite_params = per_tensor_nonfinite(params) if dynamics else None
    lr = _schedule(opt_state, hparams)
    delta_norms = [] if dynamics else None
    # The clip and AdamW in one pass (phases ``clip`` and ``adamw``); the
    # pre-clip gradients stay as they are, for the dynamics tap.
    params, opt_state, grad_norm = clip_adamw_update(
        params, grads, opt_state, lr, max_norm=hparams.grad_clip_norm,
        betas=hparams.betas, eps=hparams.eps, weight_decay=hparams.weight_decay,
        delta_norms=delta_norms,
    )
    metrics = {"loss": loss.float(), "lr": lr, "grad_norm": grad_norm}
    if health:
        # Post-update params: an optimizer-made non-finite shows the same step.
        clipped = scale_grads(grads, grad_norm, hparams.grad_clip_norm)
        metrics["health"] = health_metrics(loss, clipped, params)
        if moe_aux is not None:
            metrics["health"]["moe_aux"] = moe_aux.detach().float()
    if dynamics:
        # Dynamics reports the pre-clip gradient magnitudes.
        metrics["dynamics"] = dynamics_from_parts(
            grads, params, delta_norms, nonfinite_params, act_stats
        )
    return params, opt_state, metrics


@torch.no_grad()
def _gspmd_update(params, opt_state: AdamWState, loss, grads, hparams: TrainHParams,
                  health: bool = False, dynamics: bool = False, act_stats=None, moe_aux=None,
                  layout=None):
    """The update on this rank's blocks (``layout``, a
    :class:`parallel.gspmd.GspmdLayout`):

    * the gradient mean over ``data``: a leaf split on ``data`` (FSDP) has
      it already (the reduce-scatter of its gather's backward); a leaf that
      ZeRO-1 splits there is reduce-scattered on that dim; every other leaf
      is all-reduced in one flat buffer, all at the ``grads_dtype`` width;
      the loss, ``moe_aux`` and the activation stats are the global batch's;
    * the clip norm over every element of every leaf once: the blocks'
      sums of squares summed over the axes each leaf is split on;
    * AdamW in place on the blocks; a ZeRO-1 leaf's owned slice is updated
      and all-gathered over ``data``;
    * the taps' norms and counts over the blocks, as the clip norm's."""
    # parallel/__init__ imports this module: the collectives come at call time.
    from bpe_transformer_tpu_torch.parallel.mesh import all_gather_dim, reduce_scatter_dim

    leaves = tree_leaves(params)
    g = list(tree_leaves(grads))
    narrow = layout.grads_dtype
    data = layout.data
    zdims = [layout.zero1_dim(i) for i in range(len(leaves))]
    plain = [i for i, spec in enumerate(layout.leaf_specs)
             if zdims[i] is None and not layout.data_reduced(spec)]
    with phase("grad_reduce"):
        if data is None:
            if narrow != torch.float32:
                for i in plain:
                    g[i] = g[i].to(narrow).float()
        else:
            if plain:
                flat = torch.cat([g[i].reshape(-1).to(narrow) for i in plain])
                data.pmean_(flat)
                offset = 0
                for i in plain:
                    n = g[i].numel()
                    g[i] = flat[offset:offset + n].view(g[i].shape).float()
                    offset += n
            for i, dim in enumerate(zdims):
                if dim is not None:
                    g[i] = reduce_scatter_dim(g[i].to(narrow), dim, data).div_(data.size).float()
            if moe_aux is not None:
                loss, moe_aux = _pmean_scalars(data, loss, moe_aux)
            else:
                (loss,) = _pmean_scalars(data, loss)
        if act_stats is not None:
            act_stats = layout.act_stats(act_stats)
    owned_specs = [layout.leaf_moment_specs[i] if zdims[i] is not None else layout.leaf_specs[i]
                   for i in range(len(leaves))]
    reduce_g = layout.leaf_reducer(owned_specs)
    reduce_p = layout.leaf_reducer(layout.leaf_specs)
    nonfinite_params = per_tensor_nonfinite(params, reduce_p) if dynamics else None
    with phase("clip"):
        sumsq = torch.stack([torch.sum(torch.square(t.float())) for t in g])
        grad_norm = torch.sqrt(torch.sum(reduce_g(sumsq)))
        scale = torch.clamp(hparams.grad_clip_norm / (grad_norm + 1e-6), max=1.0)
        clipped = [(t * scale).to(t.dtype) for t in g]
    owned = [p if dim is None else p.narrow(dim, data.index * (p.shape[dim] // data.size),
                                            p.shape[dim] // data.size)
             for p, dim in zip(leaves, zdims)]
    lr = _schedule(opt_state, hparams)
    delta_norms = [] if dynamics else None
    with phase("adamw"):
        _, new_state = adamw_update(
            owned, clipped, AdamWState(opt_state.step, tree_leaves(opt_state.m),
                                       tree_leaves(opt_state.v)), lr,
            betas=hparams.betas, eps=hparams.eps, weight_decay=hparams.weight_decay,
            delta_norms=delta_norms,
        )
    with phase("param_gather"):
        for p, part, dim in zip(leaves, owned, zdims):
            if dim is not None:
                p.copy_(all_gather_dim(part, dim, data))
    opt_state = AdamWState(step=new_state.step, m=opt_state.m, v=opt_state.v)
    metrics = {"loss": loss.float(), "lr": lr, "grad_norm": grad_norm}
    if health:
        metrics["health"] = health_metrics(loss, tree_unflatten(grads, clipped), params,
                                           reduce_g, reduce_p)
        if moe_aux is not None:
            metrics["health"]["moe_aux"] = moe_aux.detach().float()
    if dynamics:
        update_norms = list(torch.sqrt(reduce_g(torch.stack(delta_norms).square())).unbind())
        # Dynamics reports the pre-clip gradient magnitudes.
        metrics["dynamics"] = dynamics_from_parts(tree_unflatten(grads, g), params, update_norms,
                                                  nonfinite_params, act_stats, reduce_g, reduce_p)
    return params, opt_state, metrics


def train_step_fn(
    config: ModelConfig,
    hparams: TrainHParams,
    reduce_axis: str | None = None,
    health: bool = False,
    dynamics: bool = False,
    zero1_shards: int | None = None,
    layout=None,
) -> Callable:
    """The update ``(params, opt_state, x, y) -> (params, opt_state,
    metrics)`` on this rank.  The learning rate is read at
    ``opt_state.step`` before AdamW increments it.  ``health`` adds
    ``metrics["health"]`` (``telemetry/health.py``), ``dynamics``
    ``metrics["dynamics"]`` (``telemetry/dynamics.py``, with the activation
    statistics tapped from the differentiated forward).  An MoE config's
    health stats also carry ``moe_aux``, the raw load-balance loss.
    ``reduce_axis`` (a data axis of a mesh) all-reduces the mean of the
    loss, the gradients and ``moe_aux`` before the update, so every rank
    runs the same update; ``zero1_shards`` (with ``reduce_axis``) makes
    ``opt_state`` a :class:`optim.sharded.ShardedAdamWState` row and the
    update ZeRO-1's.  ``layout`` runs the sharded step (module docstring)."""
    _check_zero1(zero1_shards, reduce_axis, health, dynamics, "train_step_fn")
    with_aux = health and config.ffn_type == "moe"
    grad_fn = value_and_grad(make_loss_fn(config, with_aux=with_aux, with_stats=dynamics,
                                          shard=layout),
                             has_aux=dynamics or with_aux)

    if zero1_shards is not None:

        def zero1_step(params, opt_state, x, y):
            with phase("train_step"):
                loss, grads = grad_fn(params, x, y)
                return _zero1_update(params, opt_state, loss, grads, hparams, reduce_axis,
                                     zero1_shards)

        return zero1_step

    def step(params, opt_state: AdamWState, x, y):
        with phase("train_step"):
            act_stats = moe_aux = None
            if dynamics:
                (loss, (aux, act_stats)), grads = grad_fn(params, x, y)
                moe_aux = aux if with_aux else None
            elif with_aux:
                (loss, moe_aux), grads = grad_fn(params, x, y)
            else:
                loss, grads = grad_fn(params, x, y)
            if layout is not None:
                return _gspmd_update(params, opt_state, loss, grads, hparams, health,
                                     dynamics, act_stats, moe_aux, layout)
            return _update(params, opt_state, loss, grads, hparams, health, dynamics,
                           act_stats, moe_aux, reduce_axis)

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
    layout=None,
) -> Callable:
    """One optimizer update from ``accum_steps`` microbatch gradients:
    ``(params, opt_state, xs, ys) -> (params, opt_state, metrics)`` with
    ``xs, ys (accum_steps, micro_batch, seq)``.  The taps read the
    accumulated gradients; dynamics carries no activation statistics and
    health no ``moe_aux`` on this path, as in the JAX package.
    ``reduce_axis`` reduces ONCE per update, after the local accumulation;
    ``zero1_shards`` reduce-scatters the accumulated gradients."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _check_zero1(zero1_shards, reduce_axis, health, dynamics, "grad_accum_step_fn")
    grad_fn = value_and_grad(make_loss_fn(config, shard=layout))

    def step(params, opt_state, xs, ys):
        with phase("train_step"):
            loss, grads = accumulate_grads(grad_fn, params, xs, ys, accum_steps)
            if layout is not None:
                return _gspmd_update(params, opt_state, loss, grads, hparams, health,
                                     dynamics, layout=layout)
            if zero1_shards is not None:
                return _zero1_update(params, opt_state, loss, grads, hparams, reduce_axis,
                                     zero1_shards)
            return _update(params, opt_state, loss, grads, hparams, health, dynamics,
                           reduce_axis=reduce_axis)

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


def scanned_step_fn(
    config: ModelConfig,
    hparams: TrainHParams,
    inner_steps: int,
    reduce_axis=None,
    body: Callable | None = None,
    health: bool = False,
    dynamics: bool = False,
    zero1_shards: int | None = None,
    layout=None,
) -> Callable:
    """``inner_steps`` optimizer updates a call: ``(params, opt_state, xs,
    ys) -> (params, opt_state, metrics)`` with a leading ``(inner_steps,)``
    dim on ``xs``/``ys``; ``metrics`` are the last update's, as the JAX
    package's ``lax.scan`` returns them.  The updates are dispatched back to
    back with no host sync between them, and only the last one runs the
    taps: the others' values would be thrown away.  ``reduce_axis`` and
    ``zero1_shards`` go to every update (one reduction each); ``body``
    replaces the update (the sp step passes its own)."""
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if body is not None:
        plain = last = body
    else:
        plain = train_step_fn(config, hparams, reduce_axis, zero1_shards=zero1_shards,
                              layout=layout)
        last = train_step_fn(config, hparams, reduce_axis, health=health, dynamics=dynamics,
                             zero1_shards=zero1_shards, layout=layout)

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


def make_scanned_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    inner_steps: int,
    health: bool = False,
    dynamics: bool = False,
) -> Callable:
    """The single-device scanned step (:func:`scanned_step_fn`)."""
    return scanned_step_fn(config, hparams, inner_steps, health=health, dynamics=dynamics)


def make_eval_step(config: ModelConfig, shard=None) -> Callable:
    """Pure cross-entropy eval ``(params, x, y) -> loss`` without a graph,
    honouring ``loss_chunk_size`` as the train step does; ``shard`` (a
    :class:`parallel.gspmd.GspmdLayout`): the sharded forward on this
    rank's rows."""
    if shard is not None:

        def eval_loss(params, x, y):
            hidden, _ = forward_hidden(params, x, config, shard=shard)
            return shard.lm_loss(params, hidden, y, config.loss_chunk)

    elif config.loss_chunk:

        def eval_loss(params, x, y):
            hidden, _ = forward_hidden(params, x, config)
            return lm_loss(hidden, lm_head_weight(params, config), y, config.loss_chunk)

    else:

        def eval_loss(params, x, y):
            return cross_entropy(forward(params, x, config), y)

    return torch.no_grad()(eval_loss)
