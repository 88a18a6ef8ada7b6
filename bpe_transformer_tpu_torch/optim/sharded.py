"""ZeRO-1 sharded AdamW (port of ``bpe_transformer_tpu/optim/sharded.py``):
each data-parallel rank owns 1/N of the optimizer state.

The update works on the flat layout: every parameter and gradient leaf is
raveled and concatenated into one vector, zero-padded to a multiple of the
data-parallel width N and viewed as ``(N, shard_len)``.  Each rank holds
its ``(1, shard_len)`` row of ``m``, ``v`` and the float32 master weights,
on its card.  Per step:

* the gradients are reduce-scattered over the data axis (each rank
  receives the summed row it owns), at the ``grads_dtype`` width, and
  divided by N;
* the global clip norm comes from an all-reduce of the rows' sums of
  squares (the rows tile the vector; the padding adds zero);
* each rank applies AdamW to its row only, in place;
* the new master rows are all-gathered and written into the parameters,
  in place.

The math is :func:`optim.adamw.adamw_update` after a gradient mean, with
the JAX function's clip (``max_norm / (norm + 1e-6)``, capped at 1).  A
state without a mesh (``sharded_adamw_init(params, n)``, a checkpoint's
payload) holds all N rows; with a mesh, a rank's own row.
:func:`restore_opt_state` adapts a checkpointed state to the run's mode:
dense to sharded and back, and across data-parallel widths.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_init
from bpe_transformer_tpu_torch.telemetry.spans import phase
from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


class ShardedAdamWState(NamedTuple):
    """ZeRO-1 optimizer state in the flat ``(rows, shard_len)`` layout:
    ``rows`` is N for a whole state, 1 for a rank's own row.  ``step`` is a
    0-d int32 tensor on the host, as in :class:`AdamWState`."""

    step: torch.Tensor
    m: torch.Tensor  # float32 first moment
    v: torch.Tensor  # float32 second moment
    master: Any  # float32 master weights (None only in old payloads)


def is_sharded_opt_state(opt_state) -> bool:
    """True for a :class:`ShardedAdamWState` or an equivalent 4-tuple from
    a checkpoint payload."""
    if isinstance(opt_state, ShardedAdamWState):
        return True
    return isinstance(opt_state, (tuple, list)) and len(opt_state) == 4


def flat_total(params) -> int:
    """Total element count across every leaf of ``params``."""
    return int(sum(np.prod(np.shape(p)) for p in tree_leaves(params)))


def shard_len(total: int, n_shards: int) -> int:
    """Per-shard flat length: ``total`` rounded up to a multiple of
    ``n_shards`` (the tail shard is zero-padded), divided by it."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return -(-total // n_shards)


@torch.no_grad()
def flatten_cast(tree, dtype, pad_to: int | None = None) -> torch.Tensor:
    """Ravel every leaf to ``dtype`` and concatenate; zero-pad to
    ``pad_to``.  The bf16 gradient boundary flattens at the narrow width,
    so the reduce-scatter moves half the bytes."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    total = sum(leaf.numel() for leaf in leaves)
    size = max(total, pad_to or 0)
    flat = torch.empty(size, dtype=dtype, device=leaves[0].device)
    offset = 0
    for leaf in leaves:
        n = leaf.numel()
        flat[offset:offset + n].copy_(leaf.reshape(-1))
        offset += n
    flat[total:].zero_()
    return flat


def flatten_f32(tree, pad_to: int | None = None) -> torch.Tensor:
    """Ravel every leaf to float32 and concatenate; zero-pad to ``pad_to``."""
    return flatten_cast(tree, torch.float32, pad_to)


@torch.no_grad()
def unflatten_like(flat: torch.Tensor, template) -> Any:
    """Inverse of :func:`flatten_f32`: split ``flat`` at the template's leaf
    boundaries, reshape, and cast each piece to the template leaf's dtype.
    Padding beyond the template's total is ignored."""
    out, offset = [], 0
    for leaf in tree_leaves(template):
        n = leaf.numel()
        out.append(flat[offset:offset + n].reshape(leaf.shape).to(leaf.dtype))
        offset += n
    return tree_unflatten(template, out)


def _rows(flat: torch.Tensor, n_shards: int, row: int | None) -> torch.Tensor:
    """``flat`` (length ``n_shards * L``) as ``(n_shards, L)``, or only row
    ``row`` as a ``(1, L)`` copy."""
    table = flat.reshape(n_shards, -1)
    return table if row is None else table[row:row + 1].clone()


def _row_of(mesh, axis: str) -> int | None:
    return None if mesh is None else mesh.coords[axis]


def _params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


def sharded_adamw_init(params, n_shards: int, mesh=None, axis: str = "data") -> ShardedAdamWState:
    """Zero-initialized ZeRO-1 state for ``params`` split ``n_shards`` ways,
    the master from the parameters; with ``mesh``, this rank's row only."""
    L = shard_len(flat_total(params), n_shards)
    rows = 1 if mesh is not None else n_shards
    dev = _params_device(params)
    master = _rows(flatten_f32(params, pad_to=n_shards * L), n_shards, _row_of(mesh, axis))
    return ShardedAdamWState(
        step=torch.zeros((), dtype=torch.int32),
        m=torch.zeros(rows, L, dtype=torch.float32, device=dev),
        v=torch.zeros(rows, L, dtype=torch.float32, device=dev),
        master=master,
    )


def _reduce_scatter(out, flat, group):
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, flat, group=group)


def _all_gather(out, row, group):
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, row, group=group)


@torch.no_grad()
def sharded_adamw_update(
    params,
    grads,
    state: ShardedAdamWState,
    lr: float,
    *,
    axis,
    n_shards: int,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip_norm: float | None = None,
    clip_eps: float = 1e-6,
    grads_dtype: str = "float32",
):
    """One ZeRO-1 AdamW step on this rank's row.  ``axis`` is the data
    axis (:meth:`parallel.mesh.Mesh.axis`); ``grads`` are this rank's LOCAL
    gradients (the reduce-scatter replaces the dp mean).  Returns
    ``(params, new_state, grad_norm)``: the parameters and the row state
    updated in place, ``grad_norm`` the global pre-clip norm of the mean
    gradients (a 0-d tensor on the card).  Under a profiler its phases are
    ``bpt.grad_reduce`` (the reduce-scatter), ``bpt.clip`` (the row norm and
    its all-reduce), ``bpt.adamw`` (the row update) and
    ``bpt.param_gather`` (the all-gather into the parameters)."""
    b1, b2 = betas
    m, v, master = state.m.view(-1), state.v.view(-1), state.master.view(-1)
    L = m.numel()
    with phase("grad_reduce"):
        flat_g = flatten_cast(grads, getattr(torch, grads_dtype), pad_to=n_shards * L)
        g = torch.empty(L, dtype=flat_g.dtype, device=flat_g.device)
        _reduce_scatter(g, flat_g, axis.group)
        del flat_g
        g = g.float().div_(n_shards)
    with phase("clip"):
        sumsq = torch.sum(torch.square(g))
        grad_norm = torch.sqrt(axis.psum_(sumsq))
        if grad_clip_norm is not None:
            g.mul_(torch.clamp(grad_clip_norm / (grad_norm + clip_eps), max=1.0))
    step = int(state.step) + 1
    bias1 = 1.0 - b1**step
    bias2 = 1.0 - b2**step
    with phase("adamw"):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        update = (m / bias1) / (torch.sqrt(v / bias2) + eps)
        master.copy_(master * (1.0 - lr * weight_decay) - lr * update)
    with phase("param_gather"):
        flat = torch.empty(n_shards * L, dtype=torch.float32, device=master.device)
        _all_gather(flat, master, axis.group)
        offset = 0
        for p in tree_leaves(params):
            n = p.numel()
            p.copy_(flat[offset:offset + n].view(p.shape))
            offset += n
    new_state = ShardedAdamWState(step=torch.tensor(step, dtype=torch.int32), m=state.m,
                                  v=state.v, master=state.master)
    return params, new_state, grad_norm


def gather_opt_state(state: ShardedAdamWState, mesh, axis: str = "data") -> ShardedAdamWState:
    """Every rank's row of a sharded state, all-gathered into the whole
    ``(N, L)`` layout (the one the JAX package checkpoints)."""
    ax = mesh.axis(axis)

    def gather(row):
        out = torch.empty(ax.size * row.numel(), dtype=row.dtype, device=row.device)
        _all_gather(out, row.reshape(-1), ax.group)
        return out.reshape(ax.size, -1)

    return ShardedAdamWState(step=state.step, m=gather(state.m), v=gather(state.v),
                             master=gather(state.master))


# ------------------------------------------------- checkpoint conversions


def _host(a) -> torch.Tensor:
    """A payload leaf (numpy or tensor) as a CPU tensor."""
    # np.array copies: a JAX array's host view is read-only.
    return a.detach().cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _step(step) -> torch.Tensor:
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32)


def shard_opt_state(opt: AdamWState, params, n_shards: int, mesh=None,
                    axis: str = "data") -> ShardedAdamWState:
    """A dense :class:`AdamWState` in the ZeRO-1 flat layout (a dense
    checkpoint resumed into a sharded run); the master is the float32 view
    of the parameters.  With ``mesh``, this rank's row."""
    L = shard_len(flat_total(params), n_shards)
    row = _row_of(mesh, axis)
    dev = _params_device(params)
    host = lambda tree: tree_map(_host, tree)  # noqa: E731
    return ShardedAdamWState(
        step=_step(opt.step),
        m=_rows(flatten_f32(host(opt.m), pad_to=n_shards * L), n_shards, row).to(dev),
        v=_rows(flatten_f32(host(opt.v), pad_to=n_shards * L), n_shards, row).to(dev),
        master=_rows(flatten_f32(params, pad_to=n_shards * L), n_shards, row),
    )


def unshard_opt_state(opt: ShardedAdamWState, params) -> AdamWState:
    """Back to the dense per-leaf layout on the parameters' device (a
    sharded checkpoint resumed into an unsharded run); float32 moments."""
    total = flat_total(params)
    dev = _params_device(params)
    template = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32), params)

    def dense(a):
        return tree_map(lambda t: t.to(dev), unflatten_like(_host(a).reshape(-1)[:total],
                                                            template))

    return AdamWState(step=_step(opt.step), m=dense(opt.m), v=dense(opt.v))


def _whole_moments(sharded: ShardedAdamWState, full) -> AdamWState:
    """A flat ZeRO-1 state as whole float32 host moments in the tree of
    ``full`` (any leaves with a ``shape``: ``meta`` tensors do)."""
    sizes = [int(np.prod(tuple(leaf.shape))) for leaf in tree_leaves(full)]

    def split(a):
        flat = _host(a).reshape(-1).float()
        out, offset = [], 0
        for leaf, n in zip(tree_leaves(full), sizes):
            out.append(flat[offset:offset + n].reshape(tuple(leaf.shape)))
            offset += n
        return tree_unflatten(full, out)

    return AdamWState(step=_step(sharded.step), m=split(sharded.m), v=split(sharded.v))


def restore_opt_state(opt_payload, params, zero1_shards: int | None = None, mesh=None,
                      axis: str = "data", layout=None):
    """Adapt a checkpointed optimizer payload (or ``None``) to the run's
    optimizer-sharding mode: ``zero1_shards`` is the data-parallel width
    of a ZeRO-1 run, ``None`` for the dense optimizer.  Every crossing:
    dense to sharded, sharded to dense, and sharded to sharded at another
    width (through the flat vector, the float32 master kept bit for bit).
    With ``mesh``, a sharded result is this rank's row.

    ``layout`` (a ``parallel.gspmd.GspmdLayout``) makes the result this
    rank's blocks of an ``AdamWState`` under the layout's moment specs
    (``params`` unused): from nothing (zeros), a dp ZeRO-1 state of any
    width, or an ``AdamWState`` whose leaves are whole (a dense state, a
    directory read whole) or already this rank's blocks."""
    if layout is not None:
        if opt_payload is None:
            return layout.init_opt_state()
        if is_sharded_opt_state(opt_payload):
            opt_payload = _whole_moments(ShardedAdamWState(*opt_payload), layout.full)
        dense = AdamWState(*opt_payload)
        return AdamWState(step=_step(dense.step),
                          m=layout.place(dense.m, layout.moment_specs),
                          v=layout.place(dense.v, layout.moment_specs))
    if opt_payload is None:
        if zero1_shards:
            return sharded_adamw_init(params, zero1_shards, mesh=mesh, axis=axis)
        return adamw_init(params)
    if is_sharded_opt_state(opt_payload):
        sharded = ShardedAdamWState(*opt_payload)
        if not zero1_shards:
            return unshard_opt_state(sharded, params)
        total = flat_total(params)
        L = shard_len(total, zero1_shards)
        row = _row_of(mesh, axis)
        dev = _params_device(params)

        def rewidth(a):
            flat = torch.zeros(zero1_shards * L, dtype=torch.float32)
            flat[:total] = _host(a).reshape(-1)[:total]
            return _rows(flat, zero1_shards, row).to(dev)

        master = (rewidth(sharded.master) if sharded.master is not None else
                  _rows(flatten_f32(params, pad_to=zero1_shards * L), zero1_shards, row))
        return ShardedAdamWState(step=_step(sharded.step), m=rewidth(sharded.m),
                                 v=rewidth(sharded.v), master=master)
    dense = AdamWState(*opt_payload)
    if zero1_shards:
        return shard_opt_state(dense, params, zero1_shards, mesh=mesh, axis=axis)
    dev = _params_device(params)

    def on_dev(tree):
        return tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else
                        torch.from_numpy(np.array(a)).to(dev), tree)

    return AdamWState(step=_step(dense.step), m=on_dev(dense.m), v=on_dev(dense.v))


def opt_state_from_jax(state, device: str | torch.device = "cuda", mesh=None,
                       axis: str = "data"):
    """A JAX optimizer state (``jax.device_get`` / numpy leaves) as the
    port's: an ``AdamWState`` with the parameter tree's nesting, or a
    ``ShardedAdamWState`` in the ``(N, L)`` layout (with ``mesh``, this
    rank's row), tensors on ``device``; the sibling of
    ``models.transformer.params_from_jax``."""
    from bpe_transformer_tpu_torch.models.transformer import params_from_jax

    dev = torch.device(device)
    if is_sharded_opt_state(state):
        step, m, v, master = state
        row = _row_of(mesh, axis)

        def leaf(a):
            t = _host(a).float()
            return (t if row is None else t[row:row + 1].clone()).to(dev)

        return ShardedAdamWState(step=_step(step), m=leaf(m), v=leaf(v),
                                 master=None if master is None else leaf(master))
    step, m, v = state
    return AdamWState(step=_step(step), m=params_from_jax(m, dev), v=params_from_jax(v, dev))
