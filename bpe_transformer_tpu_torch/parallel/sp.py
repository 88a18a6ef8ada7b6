"""Sequence-parallel (context-parallel) training: ring attention in the train
step (port of ``bpe_transformer_tpu/parallel/sp.py``).

Every sequence is cut into ``ring.size`` shards, one per ring rank; every
layer but attention is token-local, so only attention (the ring schedules
of :mod:`parallel.ring_attention`) and the loss see more than one shard.
Tensors carry the ring's ranks as a leading dim (:mod:`parallel.mesh`):
token batches are ``(local, batch, S_local)``, made by
:func:`shard_sp_batch`.  The model runs on the rank-stacked batch ``(local *
batch, S_local)`` with per-example global positions, and its attention
regroups the ranks for the ring.

The ring is either a :class:`~parallel.mesh.StackedRing` (every rank on
this device, ``local = n``) or a process-group mesh
(:func:`parallel.mesh.make_mesh`) with a ``seq`` axis, the JAX package's
data x seq grid: each process is one rank on its own card, the batch is
split on ``data`` and every sequence on ``seq`` (``local = 1``), the ring
is a :class:`~parallel.mesh.ProcessGroupRing` over the rank's ``seq``
group, and the loss and the gradients are all-reduced over (data, seq)
once per update, after any accumulation.

The loss is the mean of the shards' mean losses, as the JAX step's
``pmean`` over (data, seq) takes it; on one device the data axis is the
batch, whose shards are equal, so the mean over them is the batch mean.
An MoE FFN routes each rank's tokens as a dispatch group of its own (its
capacity from the rank's token count, its own load-balance loss), as every
shard routes only its local tokens under the JAX package's ``shard_map``;
the ranks' aux losses are averaged, as the ``pmean`` averages the shards'.
The stacked batch is rank-major, so a rank's tokens are one contiguous
slice of it.  (The data axis is not split: a rank's group holds the whole
batch's tokens of its shard, which equals a JAX mesh whose data axis is 1.)
Parameters and optimizer state are one copy.  ``attention_impl="flash"``
runs the ring-flash schedules (the flash kernels inside each shard);
anything else, ``"flash_fused"`` included, the plain online-softmax rings,
as in the JAX package.  ``ulysses=True`` swaps the ring for the all-to-all
head scatter (:mod:`parallel.ulysses`) on either transport: the contiguous
layout only, whose rank order along ``seq`` is the global token order.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import forward, forward_hidden, lm_head_weight
from bpe_transformer_tpu_torch.ops.losses import lm_loss
from bpe_transformer_tpu_torch.optim.adamw import AdamWState
from bpe_transformer_tpu_torch.parallel.mesh import Mesh, ProcessGroupRing
from bpe_transformer_tpu_torch.parallel.ring_attention import (
    ring_flash_attention,
    ring_self_attention,
    zigzag_indices,
    zigzag_positions,
    zigzag_ring_flash_attention,
    zigzag_ring_self_attention,
)
from bpe_transformer_tpu_torch.parallel.ulysses import ulysses_attention
from bpe_transformer_tpu_torch.telemetry.spans import phase
from bpe_transformer_tpu_torch.training.train_step import (
    TrainHParams,
    _pmean_scalars,
    _reduce_grads,
    _update,
    accumulate_grads,
    scanned_step_fn,
    value_and_grad,
)

_FLASH_RING_KV_CHUNK_ERROR = (
    'attention_impl="flash" does not honor ring_kv_chunk inside the ring '
    "(the flash kernel tiles each visiting shard itself); unset ring_kv_chunk or use "
    'the plain ring (attention_impl="xla")'
)


def _ring_of(ring):
    """``(ring, reduce_axis)``: a mesh becomes the ring of this rank's
    ``seq`` group and the (data, seq) reduction; a ring stays itself."""
    if isinstance(ring, Mesh):
        if "seq" not in ring.shape:
            raise ValueError(f"sequence parallelism needs a 'seq' mesh axis, got {ring.shape}")
        return ProcessGroupRing(ring.axis("seq").group), ring.axis(ring.axis_names)
    return ring, None


def _sp_attention_fn(config: ModelConfig, ring, zigzag: bool = False, ulysses: bool = False):
    """Per-shard attention for the sp schedules, on rank-stacked ``(local,
    ..., S_local, D)`` q/k/v: ``ulysses=True`` is the all-to-all head
    scatter (:func:`parallel.ulysses.ulysses_attention`); otherwise
    ``attention_impl="flash"`` runs the flash kernels inside every ring
    shard (ring-flash or zig-zag ring-flash), anything else the plain
    online-softmax ring (kv-chunked when ``ring_kv_chunk`` is set; the
    zig-zag ring has no chunk knob)."""
    if ulysses:
        return partial(ulysses_attention, ring=ring, config=config)
    if config.attention_impl == "flash":
        if config.ring_kv_chunk:
            raise ValueError(_FLASH_RING_KV_CHUNK_ERROR)
        block = config.flash_block_size
        fn = zigzag_ring_flash_attention if zigzag else ring_flash_attention
        return partial(fn, ring=ring, block_q=block, block_k=block)
    if zigzag:
        return partial(zigzag_ring_self_attention, ring=ring)
    return partial(ring_self_attention, ring=ring, causal=True, kv_chunk=config.ring_kv_chunk)


def _on_stacked_batch(attention, local: int):
    """The model-facing attention ``(local * batch, H, S_local, D)`` ->
    same, regrouping the rank-stacked batch for the ring."""

    def attention_fn(q, k, v):
        shape = q.shape

        def by_rank(t):
            return t.reshape(local, shape[0] // local, *shape[1:])

        return attention(by_rank(q), by_rank(k), by_rank(v)).reshape(shape)

    return attention_fn


def _stacked_inputs(token_ids: torch.Tensor, config: ModelConfig, ring, zigzag: bool,
                    ulysses: bool = False):
    """``(ids (local * batch, S_local), positions (local * batch, S_local),
    attention_fn)`` of rank-stacked token ids ``(local, batch, S_local)``:
    the global positions of each rank's tokens (shard offset + local index,
    or :func:`zigzag_positions`)."""
    local, batch, s_local = token_ids.shape
    ranks = ring.index(token_ids.device)
    if zigzag:
        positions = zigzag_positions(ranks, s_local, ring.size)
    else:
        positions = ranks[:, None] * s_local + torch.arange(s_local, device=token_ids.device)
    positions = positions[:, None, :].expand(local, batch, s_local).reshape(-1, s_local)
    attention_fn = _on_stacked_batch(_sp_attention_fn(config, ring, zigzag, ulysses), local)
    return token_ids.reshape(-1, s_local), positions, attention_fn


def sp_forward(params, local_token_ids: torch.Tensor, config: ModelConfig, ring,
               ulysses: bool = False) -> torch.Tensor:
    """Float32 logits ``(local, batch, S_local, vocab)`` of contiguous
    sequence shards ``(local, batch, S_local)``: global positions, so RoPE
    sees the true token positions, and the exact ring attention."""
    ring, _ = _ring_of(ring)
    ids, positions, attention_fn = _stacked_inputs(local_token_ids, config, ring, False,
                                                   ulysses)
    logits = forward(params, ids, config, positions=positions, attention_fn=attention_fn,
                     moe_groups=local_token_ids.shape[0])
    return logits.reshape(*local_token_ids.shape, -1)


def make_sp_loss_fn(config: ModelConfig, ring, zigzag: bool = False,
                    ulysses: bool = False) -> Callable:
    """``loss_fn(params, x, y)`` on rank-stacked shards ``(local, batch,
    S_local)``: the mean over shards of each shard's mean LM loss (the
    JAX step's ``pmean``), through the chunked loss when ``loss_chunk`` is
    set, plus ``router_aux_weight`` times the ranks' mean MoE aux loss."""

    ring, _ = _ring_of(ring)

    def loss_fn(params, x, y):
        ids, positions, attention_fn = _stacked_inputs(x, config, ring, zigzag, ulysses)
        hidden, aux = forward_hidden(params, ids, config, positions=positions,
                                     attention_fn=attention_fn, moe_groups=x.shape[0])
        hidden = hidden.reshape(*x.shape, -1)
        head = lm_head_weight(params, config)
        shard_losses = [lm_loss(hidden[i], head, y[i], config.loss_chunk)
                        for i in range(x.shape[0])]
        loss = torch.stack(shard_losses).mean()
        if config.ffn_type == "moe":
            loss = loss + config.router_aux_weight * aux
        return loss

    return loss_fn


def make_sp_grad_fn(config: ModelConfig, ring, zigzag: bool = False,
                    grads_dtype: str = "float32", ulysses: bool = False) -> Callable:
    """``(params, x, y) -> (loss, grads)`` of :func:`make_sp_loss_fn`: the
    sp step before its update (a step's gradients can be held against the
    dense step's).  Over a mesh, the loss and gradients are the global
    ones: this rank's, all-reduced over (data, seq) at ``grads_dtype``."""
    ring, reduce_axis = _ring_of(ring)
    local = value_and_grad(make_sp_loss_fn(config, ring, zigzag, ulysses))
    if reduce_axis is None:
        return local

    def reduced(params, x, y):
        loss, grads = local(params, x, y)
        (loss,) = _pmean_scalars(reduce_axis, loss)
        return loss, _reduce_grads(grads, reduce_axis, grads_dtype)

    return reduced


def make_sp_train_step(
    config: ModelConfig,
    hparams: TrainHParams,
    ring,
    zigzag: bool = False,
    ulysses: bool = False,
    accum_steps: int = 1,
    inner_steps: int = 1,
) -> Callable:
    """Train step over a ring of ``ring.size`` sequence shards:
    ``(params, opt_state, x, y) -> (params, opt_state, metrics)`` with
    ``x, y`` from :func:`shard_sp_batch` and one copy of the parameters
    and moments, updated in place (the JAX step's replicated, donated
    state).  ``ring`` is a :class:`~parallel.mesh.StackedRing` or a mesh
    with a ``seq`` axis (module docstring); over a mesh each rank runs
    this step on its shard, and the gradients' mean over (data, seq) is
    all-reduced once per update.

    ``zigzag=True`` runs the balanced striped schedule; feed batches made
    with ``shard_sp_batch(..., zigzag=True)`` (targets ride the same
    permutation as inputs).  ``accum_steps > 1`` accumulates gradients over
    microbatches ``(accum_steps, local, micro_batch, S_local)``
    (``shard_sp_batch(..., stacked=True)``) before one update;
    ``inner_steps > 1`` runs that many updates a call on ``(inner_steps,
    local, batch, S_local)`` (also ``stacked=True``), each with its own
    reduction, and returns the last one's metrics.  ``ulysses=True`` runs
    the all-to-all head scatter instead of the ring (contiguous layout; the
    head count a multiple of the ring size).  The JAX function's argument
    errors are kept."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if accum_steps > 1 and inner_steps > 1:
        raise ValueError("accum_steps and inner_steps cannot both exceed 1")
    if zigzag and ulysses:
        raise ValueError(
            "zigzag and ulysses are mutually exclusive (the all-to-all schedule has no "
            "causal load imbalance to stripe away)"
        )
    ring, reduce_axis = _ring_of(ring)
    if ulysses and config.num_heads % ring.size:
        raise ValueError(
            f"ulysses scatters heads over the seq axis: num_heads={config.num_heads} must be a "
            f"multiple of the 'seq' axis size {ring.size} (use the ring schedule otherwise)"
        )
    if zigzag and config.ring_kv_chunk:
        raise ValueError(
            "the zig-zag schedule does not honor ring_kv_chunk (its sub-blocks are already "
            'half-size); use the contiguous ring, or unset ring_kv_chunk and set '
            'attention_impl="flash" for the flash zig-zag ring'
        )
    if config.attention_impl == "flash" and config.ring_kv_chunk and not ulysses:
        # Ulysses never reads ring_kv_chunk (its inner attention runs over
        # the full sequence).
        raise ValueError(_FLASH_RING_KV_CHUNK_ERROR)
    local_grad_fn = value_and_grad(make_sp_loss_fn(config, ring, zigzag, ulysses))

    def step(params, opt_state: AdamWState, x, y):
        with phase("train_step"):
            if accum_steps > 1:
                loss, grads = accumulate_grads(local_grad_fn, params, x, y, accum_steps,
                                               context="sp grad-accum step",
                                               layout="ring_rank, micro_batch, S_local")
            else:
                loss, grads = local_grad_fn(params, x, y)
            return _update(params, opt_state, loss, grads, hparams, reduce_axis=reduce_axis)

    if inner_steps > 1:
        return scanned_step_fn(config, hparams, inner_steps, body=step)
    return step


def shard_sp_batch(batch, ring, zigzag: bool = False, stacked: bool = False,
                   device: str | torch.device | None = None):
    """Token arrays ``(batch, S)`` (numpy or tensors; one array or a tuple)
    cut into ``ring.size`` sequence shards on a leading rank dim, ``(n,
    batch, S/n)``, on ``device`` (default ``"cuda"``, or the mesh's card).
    ``zigzag=True`` first permutes the sequence into the striped layout
    (shard ``i`` gets global chunks ``(i, 2n-1-i)``); ``stacked=True`` takes
    ``(accum_steps, micro_batch, S)`` and gives ``(accum_steps, n,
    micro_batch, S/n)``.  Given a mesh, only this rank's shard: its rows of
    the batch on the ``data`` axis and its shard of every sequence on the
    ``seq`` axis, ``(1, batch/D, S/n)``, copied to the card alone."""
    mesh = ring if isinstance(ring, Mesh) else None
    if mesh is not None:
        dev = torch.device(device) if device is not None else mesh.device
        data = mesh.axis("data") if "data" in mesh.shape else None
        n, me = mesh.shape["seq"], mesh.coords["seq"]
    else:
        dev = resolve_device(device if device is not None else "cuda")
        n = ring.size
    want = 3 if stacked else 2

    def place(a):
        if a.ndim != want:
            raise ValueError(f"shard_sp_batch wants {want}-D token arrays, got {tuple(a.shape)}")
        s = a.shape[-1]
        if s % n:
            raise ValueError(f"sequence length {s} must divide by the ring size {n}")
        if mesh is None:
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            t = t.to(dev)
            if zigzag:
                t = t[..., zigzag_indices(s, n).to(dev)]
            return t.reshape(*t.shape[:-1], n, s // n).movedim(-2, -3).contiguous()
        if data is not None:
            rows = a.shape[-2]
            if rows % data.size:
                raise ValueError(f"batch dim {rows} must divide by the 'data' mesh axis "
                                 f"({data.size})")
            per = rows // data.size
            a = a[..., data.index * per:(data.index + 1) * per, :]
        cols = zigzag_indices(s, n).numpy() if zigzag else np.arange(s)
        cols = cols[me * (s // n):(me + 1) * (s // n)]
        part = a[..., torch.as_tensor(cols)] if isinstance(a, torch.Tensor) else a[..., cols]
        t = part if isinstance(part, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(part))
        return t.unsqueeze(-3).contiguous().to(dev, non_blocking=True)

    if isinstance(batch, (tuple, list)):
        return tuple(place(a) for a in batch)
    return place(batch)
