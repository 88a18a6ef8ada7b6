"""Ring transports for sequence parallelism (the port's counterpart of the
``seq`` axis of ``bpe_transformer_tpu/parallel/mesh.py``'s meshes, as the
ring schedules use it).

A transport is what the ring code in :mod:`parallel.ring_attention` needs
of the ring's ranks, and nothing more:

* ``size``: the number of ranks n on the ring;
* ``index(device)``: the ids of the ranks this process holds, a long tensor
  of shape ``(local,)`` (JAX's ``axis_index``);
* ``shift(x)``: ``x`` as each rank receives it from rank - 1, that is every
  rank sends its block to rank + 1 (JAX's ``ppermute(i -> i + 1)``);
* ``all_to_all(x, split_dim, concat_dim)``: each rank's block cut into n
  chunks on ``split_dim`` (dims of one rank's block, the leading rank dim
  not counted), chunk j sent to rank j, and the chunks a rank receives
  concatenated on ``concat_dim`` in rank order (JAX's ``all_to_all(...,
  tiled=True)``); differentiable, the gradient is the inverse all-to-all.

Every tensor the ring code handles carries these ranks as a leading dim of
size ``local``, so rank masks built from ``index()`` broadcast against it and
the schedules are written once.  :class:`StackedRing` holds all n ranks on
one device (``local = n``), the counterpart of ``shard_map`` over a size-n
axis of one host's devices: its ``shift`` is a roll of the leading dim, and
a kernel call of the ring runs all n ranks' blocks in one launch.
:class:`ProcessGroupRing` is the same three members over a
``torch.distributed`` process group (``local = 1``): each process is one
rank on its own card, and ``shift`` is a send to rank + 1 and a receive
from rank - 1, posted together.  On the stacked ring an all-to-all is an
exact permutation of the rank dim against chunks of the split dim; over a
process group it is one ``all_to_all_single`` on contiguous chunks.

The process groups come from :func:`make_mesh`, a named grid over the
world of processes (the counterpart of the JAX package's ``make_mesh`` over
devices): ranks fill the grid in row-major order, the last axis fastest, as
a ``jax.sharding.Mesh`` lays out devices in order, and each axis is one
process group per line of the grid.  :func:`make_hybrid_mesh` lays the
grid over hosts instead: the ``ici`` part of each axis varies inside a host
and the ``dcn`` part across hosts.  An axis moves tensors with
:meth:`MeshAxis.all_gather` and :meth:`MeshAxis.reduce_scatter`, each
differentiable (the gradient of one is the other), and
:meth:`MeshAxis.all_to_all`, beside the in-place reductions.
:func:`initialize_distributed` joins the world that ``torchrun``
describes: NCCL with one rank per card on CUDA, gloo for ``device="cpu"``,
and nothing else (no backend is chosen for the caller).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Protocol

import numpy as np
import torch
import torch.distributed as dist

from bpe_transformer_tpu_torch.device import resolve_device


class RingTransport(Protocol):
    size: int

    def index(self, device: torch.device | str | None = None) -> torch.Tensor: ...

    def shift(self, x: torch.Tensor) -> torch.Tensor: ...

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor: ...


def stacked_all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The all-to-all of ``n`` ranks stacked on the leading dim of ``x``
    (``split_dim``/``concat_dim`` count the dims of one rank's block):
    ``out[j]`` is the concatenation on ``concat_dim``, in rank order, of
    every rank's j-th chunk of ``split_dim``.  A permutation of the
    elements, so autograd's backward is the inverse all-to-all."""
    n = x.shape[0]
    size = x.shape[1 + split_dim]
    if size % n:
        raise ValueError(f"dim {split_dim} of size {size} does not split {n} ways")
    # (i, ..., j, chunk, ...) -> (j, i, ...): every per-rank dim k then sits at 2 + k.
    y = x.unflatten(1 + split_dim, (n, size // n)).movedim(1 + split_dim, 0)
    # i just before the concat dim, then merged into it (rank-major).
    y = y.movedim(1, 1 + concat_dim)
    return y.flatten(1 + concat_dim, 2 + concat_dim)


class StackedRing:
    """All ``n`` ranks of the ring stacked on the leading dim of tensors on
    one device."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.size = n

    def index(self, device: torch.device | str | None = None) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.size:
            raise ValueError(
                f"leading dim {x.shape[0]} of a stacked ring tensor must be the ring "
                f"size {self.size}"
            )
        return torch.roll(x, 1, dims=0)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        if x.shape[0] != self.size:
            raise ValueError(
                f"leading dim {x.shape[0]} of a stacked ring tensor must be the ring "
                f"size {self.size}"
            )
        return stacked_all_to_all(x, split_dim, concat_dim)


# ---------------------------------------------------------- process groups


def initialize_distributed(
    device: str | torch.device = "cuda",
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> torch.device:
    """Join the process group of this run and return this rank's device.

    The rank, the world size and the address come from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) unless given: ``coordinator_address`` is ``host:port``
    of rank 0.  On CUDA the backend is NCCL and the rank's card is
    ``cuda:<LOCAL_RANK>`` (set as the current device); ``device="cpu"``
    takes gloo.  A group that is already initialized is kept; its backend
    must be the one ``device`` takes."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, but device {dev.type!r} "
                f"takes {backend}"
            )
        return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    env = os.environ
    if process_id is None and "RANK" not in env:
        raise RuntimeError(
            "no process group to join: launch with torchrun --nproc-per-node N (one process "
            "per card), or pass coordinator_address, num_processes and process_id"
        )
    rank = process_id if process_id is not None else int(env["RANK"])
    world = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank)) if process_id is None else rank
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card: this host shows "
                f"{torch.cuda.device_count()} (one rank per card)"
            )
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dev


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One or more mesh axes as a reduction domain: the process group that
    joins this rank to the others of its line (or plane) of the grid, its
    size and this rank's index in it."""

    names: tuple
    group: object
    size: int
    index: int

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum of ``t`` over the axis (JAX's ``psum``)."""
        dist.all_reduce(t, group=self.group)
        return t

    def pmean_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place mean of ``t`` over the axis (JAX's ``pmean``): a sum,
        then a division at ``t``'s own width."""
        return self.psum_(t).div_(self.size)

    def pmax_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks of ``x`` concatenated on ``dim`` in axis order
        (JAX's ``all_gather(..., tiled=True)``); the gradient is the
        reduce-scatter of the output's gradient."""
        return _AllGather.apply(x, dim, self)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of the sum of ``x`` over the axis, ``dim``
        split in axis order (JAX's ``psum_scatter(..., tiled=True)``); the
        gradient is the all-gather of the output's gradient."""
        return _ReduceScatter.apply(x, dim, self)

    def gather_replicated(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks of ``x`` concatenated on ``dim``, for a
        computation that every rank of the axis then runs alike: the
        gradient, the same on every rank, is narrowed to this rank's block
        (no sum, which would scale it by the axis size)."""
        return _GatherReplicated.apply(x, dim, self)

    def split(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x``, which every rank of the axis holds
        alike, on ``dim``; the gradient is the all-gather of the blocks'
        gradients (each rank's block of the whole)."""
        return _Split.apply(x, dim, self)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """``x`` cut into ``size`` chunks on ``split_dim``, chunk j sent to
        rank j of the axis, the received chunks concatenated on
        ``concat_dim`` in axis order (JAX's ``all_to_all(..., tiled=True)``);
        the gradient is the inverse all-to-all."""
        return _AllToAll.apply(x, split_dim, concat_dim, self.group, self.size)


def _collective(name: str, old: str):
    # torch 2.9 renamed the tensor collectives; older builds have only the old names.
    return getattr(dist, name, None) or getattr(dist, old)


def all_gather_dim(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """:meth:`MeshAxis.all_gather` without a graph: one
    ``all_gather_into_tensor`` on ``x`` with ``dim`` moved first; the
    result is contiguous."""
    if axis.size == 1:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((axis.size * x0.shape[0], *x0.shape[1:]))
    _collective("all_gather_single", "all_gather_into_tensor")(out, x0, group=axis.group)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter_dim(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """:meth:`MeshAxis.reduce_scatter` without a graph: the sum over the
    axis, this rank's block of ``dim``."""
    if axis.size == 1:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    if x0.shape[0] % axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {axis.size} ways")
    out = x0.new_empty((x0.shape[0] // axis.size, *x0.shape[1:]))
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, x0, group=axis.group)
    return out.movedim(0, dim).contiguous() if dim else out


def all_to_all_dim(x: torch.Tensor, split_dim: int, concat_dim: int, group,
                   n: int) -> torch.Tensor:
    """:meth:`MeshAxis.all_to_all` without a graph: one
    ``all_to_all_single`` over ``group`` (``n`` ranks) on the chunks of
    ``split_dim`` laid out contiguously, the received chunks moved into
    ``concat_dim``."""
    if n == 1:
        return x
    size = x.shape[split_dim]
    if size % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split {n} ways")
    chunks = x.unflatten(split_dim, (n, size // n)).movedim(split_dim, 0).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n):
        ctx.args = (split_dim, concat_dim, group, n)
        return all_to_all_dim(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group, n = ctx.args
        return all_to_all_dim(g, concat_dim, split_dim, group, n), None, None, None, None


def _block(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.axis).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return reduce_scatter_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.axis), None, None


class Mesh:
    """A named grid of process groups over the world (``{axis: size}``,
    the product the world size).  ``shape`` is the axes and their sizes,
    ``coords`` this rank's index on each, ``device`` its card.

    Every rank creates every group, in the same order (``new_group`` is
    collective); a rank keeps the groups it belongs to.  A set of axes that
    spans the grid reduces over the world group.  ``grid`` places the
    ranks on the grid (default: in row-major order, the last axis
    fastest)."""

    def __init__(self, axes: dict, device: torch.device, grid: np.ndarray | None = None):
        self.shape = {name: int(size) for name, size in axes.items()}
        self.axis_names = tuple(self.shape)
        self.device = device
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        sizes = tuple(self.shape.values())
        grid = np.arange(self.world_size).reshape(sizes) if grid is None else grid
        self.grid = grid
        where = np.argwhere(grid == self.rank)[0]
        self.coords = dict(zip(self.axis_names, (int(c) for c in where)))
        self._groups = {}
        for i, name in enumerate(self.axis_names):
            if self.shape[name] == self.world_size:
                self._groups[name] = dist.group.WORLD
                continue
            lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = group

    def axis(self, names: str | tuple = "data") -> MeshAxis:
        """The reduction domain of one axis or a tuple of axes."""
        names = (names,) if isinstance(names, str) else tuple(names)
        unknown = [n for n in names if n not in self.shape]
        if unknown:
            raise ValueError(f"mesh {self.shape} has no axis {unknown[0]!r}")
        size = int(np.prod([self.shape[n] for n in names]))
        if len(names) == 1:
            return MeshAxis(names, self._groups[names[0]], size, self.coords[names[0]])
        if size != self.world_size:
            raise ValueError(
                f"axes {names} of mesh {self.shape} span {size} of {self.world_size} ranks: "
                "only one axis, or axes that span the grid, reduce"
            )
        return MeshAxis(names, dist.group.WORLD, size, self.rank)


def make_mesh(axes: dict | None = None, device: str | torch.device = "cuda") -> Mesh:
    """A :class:`Mesh` of ``{axis_name: size}`` over the world of processes
    (default: a 1-D ``data`` axis over every rank), joining the world first
    if needed (:func:`initialize_distributed`); the JAX function's error
    when the sizes do not fill the world."""
    dev = initialize_distributed(device)
    world = dist.get_world_size()
    if axes is None:
        axes = {"data": world}
    need = int(np.prod(list(axes.values())))
    if need != world:
        raise ValueError(f"mesh {dict(axes)} needs {need} devices, have {world}")
    return Mesh(axes, dev)


def hybrid_rank_grid(ici_axes: dict, dcn_axes: dict, local_world: int) -> np.ndarray:
    """The ranks of a hybrid mesh on its grid: each axis's coordinate is
    ``dcn_index * ici_size + ici_index``; the dcn indices pick the host
    (hosts in row-major order, ``local_world`` ranks each, as ``torchrun``
    numbers them) and the ici indices the rank inside it (row-major), as
    ``mesh_utils.create_hybrid_device_mesh`` lays out devices."""
    names = tuple(ici_axes)
    ici = tuple(int(ici_axes[n]) for n in names)
    dcn = tuple(int(dcn_axes.get(n, 1)) for n in names)
    if int(np.prod(ici)) != local_world:
        raise ValueError(
            f"hybrid mesh ici={dict(ici_axes)} needs {int(np.prod(ici))} ranks a host, the "
            f"hosts run {local_world} (LOCAL_WORLD_SIZE)"
        )
    shape = tuple(i * d for i, d in zip(ici, dcn))
    grid = np.empty(shape, dtype=np.int64)
    for coord in np.ndindex(*shape):
        host = np.ravel_multi_index(tuple(c // i for c, i in zip(coord, ici)), dcn)
        local = np.ravel_multi_index(tuple(c % i for c, i in zip(coord, ici)), ici)
        grid[coord] = host * local_world + local
    return grid


def make_hybrid_mesh(ici_axes: dict, dcn_axes: dict | None = None,
                     device: str | torch.device = "cuda") -> Mesh:
    """A mesh over several hosts (the JAX function's, over processes):
    ``ici_axes`` partition the ranks of one host (``LOCAL_WORLD_SIZE``),
    ``dcn_axes`` repeat that layout across hosts, each axis's size the
    product of its two parts (:func:`hybrid_rank_grid`).  With every dcn
    size 1 it is :func:`make_mesh`.  The JAX function's errors."""
    dcn_axes = dcn_axes or {}
    unknown = set(dcn_axes) - set(ici_axes)
    if unknown:
        raise ValueError(
            f"dcn axes {sorted(unknown)} not present in ici_axes {sorted(ici_axes)}"
        )
    dev = initialize_distributed(device)
    world = dist.get_world_size()
    names = tuple(ici_axes)
    total = int(np.prod([ici_axes[n] for n in names])) * int(
        np.prod([dcn_axes.get(n, 1) for n in names]))
    if total != world:
        raise ValueError(
            f"hybrid mesh ici={dict(ici_axes)} x dcn={dict(dcn_axes)} needs {total} devices, "
            f"have {world}"
        )
    if all(dcn_axes.get(n, 1) == 1 for n in names):
        return make_mesh(ici_axes, device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    axes = {n: ici_axes[n] * dcn_axes.get(n, 1) for n in names}
    return Mesh(axes, dev, grid=hybrid_rank_grid(ici_axes, dcn_axes, local))


class _Shift(torch.autograd.Function):
    """The ring shift of a process-group ring, differentiable: the gradient
    travels the other way (each rank sends it to rank - 1), as JAX's
    ``ppermute`` transposes."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.exchange(x, to=ring.next, frm=ring.prev)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        return ring.exchange(g, to=ring.prev, frm=ring.next), None


class ProcessGroupRing:
    """A ring over a process group, one rank per process: tensors carry a
    leading rank dim of 1.  ``shift`` posts its send to rank + 1 and its
    receive from rank - 1 in one ``batch_isend_irecv``, so no rank waits
    on a send that its neighbour has not matched; the gradient of a shift
    is the reverse shift.  ``all_to_all`` is one ``all_to_all_single`` over
    the group (:meth:`MeshAxis.all_to_all`).  A ring of one rank shifts
    and exchanges nothing."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.next = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(self.group, (self.rank - 1) % self.size)

    def index(self, device: torch.device | str | None = None) -> torch.Tensor:
        # arange, not tensor([rank]): no copy from the host to the card.
        return torch.arange(self.rank, self.rank + 1, device=device)

    def exchange(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, to, self.group),
               dist.P2POp(dist.irecv, out, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError(
                f"leading dim {x.shape[0]} of a process-group ring tensor must be 1 (this "
                "process is one rank)"
            )
        if self.size == 1:
            return x
        return _Shift.apply(x, self)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError(
                f"leading dim {x.shape[0]} of a process-group ring tensor must be 1 (this "
                "process is one rank)"
            )
        # The block's dims sit one to the right of the leading rank dim.
        return _AllToAll.apply(x, 1 + split_dim, 1 + concat_dim, self.group, self.size)
