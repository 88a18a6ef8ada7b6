"""Pipeline parallelism: GPipe microbatches over a ``pp`` mesh axis (port
of ``bpe_transformer_tpu/parallel/pp.py``).

The layer stack is cut into ``pp`` contiguous stages, one a rank of the
``pp`` axis: a rank holds its stage's blocks, stacked ``(1,
layers_per_stage, ...)``, and the ``shared`` leaves (the embedding, the
final norm and the head), replicated (:func:`stack_pipeline_params`,
:func:`shard_pp_params`).  With a ``data`` axis the batch is split over it
and the gradients are averaged over it.

The JAX package differentiates a ``lax.scan`` of ``num_micro + pp - 1``
ticks with a ``ppermute`` between them, and every rank runs every tick and
every transpose.  Eager PyTorch cannot do the same: a rank whose received
activation goes unused (rank 0 takes the embedding instead) would never
call that send's backward, and the ranks would wait on each other.  The
port writes the GPipe schedule out over the pp group's point-to-point
operations instead:

* the forward runs the microbatches in order, each rank receiving its
  stage's input from rank - 1 (rank 0 looks up the embedding), running its
  blocks and sending the output to rank + 1 (the last rank takes the loss),
  and keeping each microbatch's graph;
* the backward runs the microbatches in reverse order: each rank receives
  the gradient of its output from rank + 1 (the last rank starts from its
  loss), back-propagates through its stage and sends the gradient of its
  input to rank - 1.

The JAX scan's warm-up and drain ticks compute on garbage whose loss and
MoE aux are masked out, so skipping them changes no number.  The local
loss is the last rank's summed microbatch cross-entropy plus
``router_aux_weight`` times this rank's stages' aux, over ``num_micro``;
each microbatch routes as a dispatch group of its own (its capacity, its
aux).  The update is JAX's: the loss summed over ``pp``, the ``shared``
gradients summed over ``pp`` (each saw real gradients on one rank), the
mean over ``data`` at ``grads_dtype``, the global norm from the stages'
squares summed over ``pp`` plus the shared squares, then the clip and
AdamW in place.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import Params, policy_block
from bpe_transformer_tpu_torch.ops.core import embedding, rmsnorm
from bpe_transformer_tpu_torch.ops.losses import lm_loss
from bpe_transformer_tpu_torch.ops.rope import rope_tables
from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from bpe_transformer_tpu_torch.parallel.sharding import (
    gather_leaf,
    local_shape,
    place_blocks,
    spec_leaves,
)
from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    _pmean_scalars,
    _schedule,
    accumulate_grads,
    scanned_step_fn,
)

# ------------------------------------------------------------ param layout


def stack_pipeline_params(params: Params, pp: int) -> dict:
    """``{"stages": ..., "shared": ...}`` of a parameter tree (tensors of
    any device, ``meta`` ones included) for ``pp`` stages:
    every ``stages`` leaf stacked ``(pp, layers_per_stage, ...)``, the
    embedding, final norm and head (absent when tied) in ``shared``."""
    layers = params["layers"]
    if len(layers) % pp:
        raise ValueError(f"num_layers={len(layers)} not divisible by pipeline size {pp}")
    per_stage = len(layers) // pp
    groups = [layers[s * per_stage:(s + 1) * per_stage] for s in range(pp)]
    stages = tree_map(lambda *leaves: torch.stack(leaves),
                      *[tree_map(lambda *ls: torch.stack(ls), *group) for group in groups])
    shared = {"token_embeddings": params["token_embeddings"], "ln_final": params["ln_final"]}
    if "lm_head" in params:
        shared["lm_head"] = params["lm_head"]
    return {"stages": stages, "shared": shared}


def unstack_pipeline_params(pp_params: dict) -> Params:
    """The inverse of :func:`stack_pipeline_params` (whole stages)."""
    stages = pp_params["stages"]
    first = tree_leaves(stages)[0]
    pp, per_stage = first.shape[0], first.shape[1]
    layers = [tree_map(lambda leaf: leaf[s, i], stages)
              for s in range(pp) for i in range(per_stage)]
    out = {"token_embeddings": pp_params["shared"]["token_embeddings"], "layers": layers,
           "ln_final": pp_params["shared"]["ln_final"]}
    if "lm_head" in pp_params["shared"]:
        out["lm_head"] = pp_params["shared"]["lm_head"]
    return out


def pipeline_specs(pp_params: dict, pp_axis: str = "pp") -> dict:
    """The specs of a stacked tree: stage leaves split on their leading
    (stage) dim over ``pp_axis``, shared leaves whole."""
    return {"stages": tree_map(lambda t: (pp_axis,) + (None,) * (len(t.shape) - 1),
                               pp_params["stages"]),
            "shared": tree_map(lambda t: (None,) * len(t.shape), pp_params["shared"])}


class PipelineLayout:
    """The stacked tree of one config on one mesh with a ``pp`` axis: the
    whole shapes (``full``, on the ``meta`` device), the specs of
    :func:`pipeline_specs` for the parameters and the moments, and the
    blocks this rank holds.  It is what the sharded checkpoint directory's
    writer and reader and ``restore_opt_state`` need of a layout."""

    def __init__(self, config: ModelConfig, mesh, pp_axis: str = "pp"):
        from bpe_transformer_tpu_torch.models.transformer import abstract_params

        if pp_axis not in mesh.shape:
            raise ValueError(f"mesh {dict(mesh.shape)} lacks axis {pp_axis!r}")
        self.config, self.mesh, self.pp_axis = config, mesh, pp_axis
        self.stages = mesh.shape[pp_axis]
        self.full = stack_pipeline_params(abstract_params(config), self.stages)
        self.specs = self.moment_specs = pipeline_specs(self.full, pp_axis)
        self.leaf_specs = self.leaf_moment_specs = spec_leaves(self.full, self.specs)
        self.axis = mesh.axis(pp_axis)

    def select(self, path: tuple, shape: tuple):
        """The box of a checkpoint leaf that this rank reads (its stage of
        a stage leaf, the rest whole); a stacked checkpoint with another
        stage count is refused with the JAX loop's message."""
        if path[:2] == ("params", "stages") or (path[:1] == ("opt_state",)
                                                 and path[2:3] == ("stages",)):
            if shape[0] != self.stages:
                raise ValueError(
                    f"checkpoint has {shape[0]} pipeline stages but the mesh "
                    f"pp axis is {self.stages}; resume with --mesh ...,pp={shape[0]}"
                )
            me = self.axis.index
            return ((me, me + 1),) + tuple((0, int(d)) for d in shape[1:])
        return None

    def place(self, tree, specs=None):
        """This rank's float32 blocks on the mesh's device of a stacked tree
        whose leaves are whole or already this rank's blocks."""
        return place_blocks(tree, self.full, specs if specs is not None else self.specs,
                            self.mesh)

    def shard(self, pp_params: dict) -> dict:
        """This rank's blocks of a whole stacked tree (copies)."""
        return shard_pp_params(pp_params, self.mesh, self.pp_axis)

    def init_opt_state(self) -> AdamWState:
        """Zero AdamW moments in this rank's blocks."""
        def zeros(leaf, spec):
            return torch.zeros(local_shape(tuple(leaf.shape), spec, self.mesh.shape),
                               dtype=torch.float32, device=self.mesh.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, self.full, self.specs),
                          v=tree_map(zeros, self.full, self.specs))

    def gather(self, pp_params: dict) -> dict:
        """The whole stacked tree on every rank, in storage of its own (one
        all-gather over ``pp`` a stage leaf; no graph)."""
        return tree_map(lambda t, spec: gather_leaf(t, spec, self.mesh), pp_params, self.specs)

    def dense(self, pp_params: dict) -> Params:
        """The dense parameter tree of every stage, on every rank."""
        return unstack_pipeline_params(self.gather(pp_params))


def shard_pp_params(pp_params: dict, mesh, pp_axis: str = "pp") -> dict:
    """This rank's blocks of whole stacked parameters: its stage,
    ``(1, layers_per_stage, ...)``, and the shared leaves, float32 copies
    on the mesh's device."""
    return place_blocks(pp_params, pp_params, pipeline_specs(pp_params, pp_axis), mesh)


def init_pp_opt_state(pp_params: dict, mesh=None, pp_axis: str = "pp") -> AdamWState:
    """AdamW moments over this rank's stacked blocks (zeros of their
    shapes)."""
    return adamw_init(pp_params)


# ------------------------------------------------------------ the schedule


def _pp_grad_fn(config: ModelConfig, num_micro: int, axis) -> Callable:
    """``(pp_params, x, y) -> (local_loss, grads)`` on this rank's stage:
    the explicit GPipe schedule of the module docstring."""
    size, rank = axis.size, axis.index
    group = axis.group
    prev = dist.get_global_rank(group, rank - 1) if rank > 0 else None
    nxt = dist.get_global_rank(group, rank + 1) if rank < size - 1 else None
    act_dtype = getattr(torch, config.activation_dtype)
    is_moe = config.ffn_type == "moe"
    block = policy_block(config)

    def head_loss(act, targets, shared):
        if not config.remove_rmsnorm:
            act = rmsnorm(act, shared["ln_final"].to(act_dtype))
        head_w = shared.get("lm_head", shared["token_embeddings"])
        return lm_loss(act, head_w, targets, config.loss_chunk)

    def grad_fn(pp_params, x, y):
        batch, seq = x.shape
        if batch % num_micro:
            raise ValueError(
                f"per-rank batch {batch} not divisible by num_microbatches {num_micro}"
            )
        mb = batch // num_micro
        x_mb, y_mb = x.reshape(num_micro, mb, seq), y.reshape(num_micro, mb, seq)
        dev = x.device
        stages, shared = pp_params["stages"], pp_params["shared"]
        per_stage = tree_leaves(stages)[0].shape[1]
        positions = torch.arange(seq, device=dev)
        rope = None if config.remove_rope else rope_tables(
            config.d_head, config.context_length, config.rope_theta, act_dtype, dev)
        leaves = tree_leaves(pp_params)
        ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        kept = []
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            for m in range(num_micro):
                if rank == 0:
                    act_in = None
                    act = embedding(shared["token_embeddings"].to(act_dtype), x_mb[m]).to(
                        act_dtype)
                else:
                    act_in = torch.empty((mb, seq, config.d_model), dtype=act_dtype, device=dev)
                    dist.recv(act_in, prev, group=group)
                    act = act_in.requires_grad_(True)
                stage_aux = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(per_stage):
                    block_params = tree_map(lambda leaf: leaf[0, i].to(act_dtype), stages)
                    act, aux = block(act, block_params, config, rope, positions)
                    stage_aux = stage_aux + aux
                objective = None
                if is_moe:
                    aux_sum = aux_sum + stage_aux.detach()
                    objective = config.router_aux_weight * stage_aux / num_micro
                out = None
                if nxt is None:
                    ce = head_loss(act, y_mb[m], shared)
                    ce_sum = ce_sum + ce.detach()
                    objective = ce / num_micro if objective is None else objective + ce / num_micro
                else:
                    dist.send(act.detach().contiguous(), nxt, group=group)
                    out = act
                kept.append((act_in, out, objective))
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for m in reversed(range(num_micro)):
                act_in, out, objective = kept.pop()
                outputs, grad_outputs = [], []
                if out is not None:
                    g = torch.empty_like(out)
                    dist.recv(g, nxt, group=group)
                    outputs.append(out)
                    grad_outputs.append(g)
                if objective is not None:
                    outputs.append(objective)
                    grad_outputs.append(torch.ones_like(objective))
                inputs = leaves + ([act_in] if act_in is not None else [])
                got = torch.autograd.grad(outputs, inputs, grad_outputs, allow_unused=True)
                for acc, g in zip(grads, got):
                    if g is not None:
                        acc.add_(g.float())
                if act_in is not None:
                    d_in = got[-1] if got[-1] is not None else torch.zeros_like(act_in)
                    dist.send(d_in.contiguous(), prev, group=group)
                del outputs, grad_outputs, got
        local = ce_sum
        if is_moe:
            local = local + config.router_aux_weight * aux_sum
        return local / num_micro, tree_unflatten(pp_params, grads)

    return grad_fn


def _pp_reduce(pp, data, grads_dtype: str) -> Callable:
    """``(local_loss, grads) -> (loss, grads)``: JAX's reductions of a pp
    step.  The loss and the ``shared`` gradients are summed over ``pp`` in
    one float32 buffer (each shared leaf saw real gradients on one rank; the
    stages' losses are disjoint partials); then, with a data axis, every
    gradient's mean over ``data`` crosses at ``grads_dtype`` and the loss's
    in float32."""
    narrow = getattr(torch, grads_dtype)

    @torch.no_grad()
    def reduce(local_loss, grads):
        shared = tree_leaves(grads["shared"])
        stage = tree_leaves(grads["stages"])
        flat = torch.cat([local_loss.reshape(1).float()] + [g.reshape(-1) for g in shared])
        if pp.size > 1:
            pp.psum_(flat)
        loss, offset = flat[0], 1
        for i, g in enumerate(shared):
            shared[i] = flat[offset:offset + g.numel()].view(g.shape)
            offset += g.numel()
        if data is not None:
            leaves = stage + shared
            buf = torch.cat([g.reshape(-1).to(narrow) for g in leaves])
            data.pmean_(buf)
            offset = 0
            for i, g in enumerate(leaves):
                leaves[i] = buf[offset:offset + g.numel()].view(g.shape).float()
                offset += g.numel()
            stage, shared = leaves[:len(stage)], leaves[len(stage):]
            (loss,) = _pmean_scalars(data, loss)
        return loss, {"stages": tree_unflatten(grads["stages"], stage),
                      "shared": tree_unflatten(grads["shared"], shared)}

    return reduce


def _pp_axes(mesh, pp_axis: str, dp_axis: str):
    if pp_axis not in mesh.shape:
        raise ValueError(f"mesh {dict(mesh.shape)} lacks axis {pp_axis!r}")
    data = mesh.axis(dp_axis) if mesh.shape.get(dp_axis, 1) > 1 else None
    return mesh.axis(pp_axis), data


def make_pp_grad_fn(config: ModelConfig, mesh, *, num_microbatches: int = 4,
                    pp_axis: str = "pp", dp_axis: str = "data",
                    grads_dtype: str = "float32") -> Callable:
    """``(pp_params, x, y) -> (loss, grads)`` of the pipeline step before
    its update, every rank's the same loss: this rank's stage gradients
    and the shared ones, reduced as the step reduces them (a step's
    gradients can be held against the dense step's)."""
    pp, data = _pp_axes(mesh, pp_axis, dp_axis)
    local = _pp_grad_fn(config, num_microbatches, pp)
    reduce = _pp_reduce(pp, data, grads_dtype)
    return lambda pp_params, x, y: reduce(*local(pp_params, x, y))


def make_pp_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    mesh,
    *,
    num_microbatches: int = 4,
    pp_axis: str = "pp",
    dp_axis: str = "data",
    accum_steps: int = 1,
    inner_steps: int = 1,
) -> Callable:
    """The pipeline (x data) parallel step on a process-group mesh:
    ``(pp_params, opt_state, x, y) -> (pp_params, opt_state, metrics)`` on
    this rank's blocks (:func:`shard_pp_params` of
    :func:`stack_pipeline_params`, or ``PipelineLayout.shard``) and moments
    (:func:`init_pp_opt_state`), on this rank's rows of the batch
    (``shard_batch``; every rank takes the whole batch without a data
    axis), updated in place.  Every rank ends the step with the same
    metrics.

    ``accum_steps > 1``: each accumulation slice runs the whole GPipe
    schedule and the update comes once, from the float32 sum
    (``accumulate_grads``); batches ``(accum_steps, batch, seq)``.
    ``inner_steps > 1``: that many updates a call (``scanned_step_fn``);
    batches ``(inner_steps, batch, seq)``.  The JAX function's argument
    errors."""
    pp, data = _pp_axes(mesh, pp_axis, dp_axis)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if accum_steps > 1 and inner_steps > 1:
        raise ValueError("accum_steps and inner_steps cannot both exceed 1")
    grad_fn = _pp_grad_fn(config, num_microbatches, pp)
    reduce = _pp_reduce(pp, data, hparams.grads_dtype)

    @torch.no_grad()
    def update(pp_params, opt_state: AdamWState, loss, grads):
        stage, shared = tree_leaves(grads["stages"]), tree_leaves(grads["shared"])
        # The stages' squares live on distinct pp ranks; the shared ones are
        # the same on every rank.
        stage_sq = torch.sum(torch.stack([torch.sum(torch.square(g)) for g in stage]))
        if pp.size > 1:
            pp.psum_(stage_sq)
        shared_sq = torch.sum(torch.stack([torch.sum(torch.square(g)) for g in shared]))
        grad_norm = torch.sqrt(stage_sq + shared_sq)
        scale = torch.clamp(hparams.grad_clip_norm / (grad_norm + 1e-6), max=1.0)
        clipped = tree_map(lambda g: g * scale, grads)
        lr = _schedule(opt_state, hparams)
        pp_params, opt_state = adamw_update(
            pp_params, clipped, opt_state, lr, betas=hparams.betas, eps=hparams.eps,
            weight_decay=hparams.weight_decay,
        )
        return pp_params, opt_state, {"loss": loss, "lr": lr, "grad_norm": grad_norm}

    def step(pp_params, opt_state: AdamWState, x, y):
        if accum_steps > 1:
            local_loss, grads = accumulate_grads(grad_fn, pp_params, x, y, accum_steps,
                                                 context="pp grad-accum step")
        else:
            local_loss, grads = grad_fn(pp_params, x, y)
        return update(pp_params, opt_state, *reduce(local_loss, grads))

    if inner_steps > 1:
        return scanned_step_fn(config, hparams, inner_steps, body=step)
    return step
