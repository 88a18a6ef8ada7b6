"""Global-norm gradient clipping and AdamW over a whole parameter tree: the
multi-tensor kernels of ``csrc/adamw.cu``, and the plain per-leaf loop.

The JAX package has no Pallas kernel here: its clip
(``bpe_transformer_tpu/ops/grad.py``) and its AdamW
(``bpe_transformer_tpu/optim/adamw.py``) are left to XLA, which fuses each
leaf's update.  Eager PyTorch launches every operation of the loop on its
own, about 16 launches a leaf; the kernels take every leaf in two launches
a step, whatever the leaf count (module docstring of the source for the
arithmetic, the bound and the design).

* :func:`clip_adamw` — clip the gradients to ``max_norm`` by their global
  norm, then one AdamW step, parameters and moments in place; returns the
  pre-clip norm.  CUDA tensors launch ``adamw_sumsq`` (in a ``bpt.clip``
  phase) and ``adamw_update`` (in ``bpt.adamw``); CPU tensors run
  :func:`clip_plain` then :func:`adamw_plain` in the same two phases.
* :func:`adamw` — the AdamW step alone (``adamw_update``, or
  :func:`adamw_plain`).
* :func:`global_norm` — the norm alone (``adamw_sumsq`` and ``adamw_norm``,
  or :func:`global_norm_plain`).

Asked for ``delta_norms``, the update also folds each leaf's
``||new - old||`` (``adamw_fold``, one launch).  The kernels take float32
and bfloat16 parameters and gradients with float32 moments and raise on
anything else.  A gradient that is its parameter transposed in the last two
dims (the MoE experts' and router's, as autograd hands them back) is read
in place; any other non-contiguous leaf goes through a contiguous copy,
written back after the launch.  Each launch adds one to its name's entry in
``kernels/_build.py`` ``launches``.  Nothing is read back from the card: the
step's scalars are computed on the host in double and handed over rounded
to float32, as PyTorch rounds a Python scalar.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.telemetry.spans import phase

#: Elements a block of the kernels takes (csrc/adamw.cu CHUNK).
CHUNK = 1 << 16
#: Leaves a launch takes (csrc/adamw.cu MAX_LEAVES); a tree with more takes
#: one launch of each kernel per group of this many.
MAX_LEAVES = 320
#: A transposed gradient's leaf is updated in chunks of TILE x TILE squares
#: of its matrices (csrc/adamw.cu TILE).
TILE = 256
#: int64 entries of one leaf in the table: p, g, m, v, numel, first chunk,
#: flags, and a transposed leaf's rows and cols (csrc/adamw.cu FIELDS).
FIELDS = 9
#: Flags of a leaf: bfloat16 parameter, bfloat16 gradient, every pointer
#: aligned for four-element vectors, the gradient's alone aligned, the
#: gradient the transpose of the parameter's last two dims.
P_BF16, G_BF16, VEC, G_VEC, TRANS = 1, 2, 4, 8, 16
#: The clip's eps in ``max_norm / (norm + eps)`` (ops/grad.py's default).
CLIP_EPS = 1e-6
_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------- plain


def global_norm_plain(leaves) -> torch.Tensor:
    """L2 norm over every tensor of ``leaves``, accumulated in float32."""
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def clip_scale(norm: torch.Tensor, max_norm: float, eps: float = CLIP_EPS) -> torch.Tensor:
    """``min(1, max_norm / (norm + eps))`` (a NaN norm gives a NaN scale)."""
    return torch.clamp(max_norm / (norm + eps), max=1.0)


def clip_plain(grads, max_norm: float, eps: float = CLIP_EPS):
    """``(clipped_grads, pre_clip_norm)``: every gradient times
    :func:`clip_scale`, rounded back to its dtype."""
    norm = global_norm_plain(grads)
    scale = clip_scale(norm, max_norm, eps)
    return [(g * scale).to(g.dtype) for g in grads], norm


@torch.no_grad()
def adamw_plain(params, grads, ms, vs, *, step: int, lr: float, betas, eps: float,
                weight_decay: float, delta_norms: list | None = None) -> None:
    """One AdamW step leaf by leaf, in place (``step`` counts this one)."""
    b1, b2 = betas
    bias1 = 1.0 - b1**step
    bias2 = 1.0 - b2**step
    for p, g, m, v in zip(params, grads, ms, vs):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        update = (m / bias1) / (torch.sqrt(v / bias2) + eps)
        new = (p.float() * (1.0 - lr * weight_decay) - lr * update).to(p.dtype)
        if delta_norms is not None:
            delta_norms.append(torch.dist(new.float(), p.float()))
        p.copy_(new)


# ----------------------------------------------------------- chunk table


class Group(NamedTuple):
    """The leaves ``first .. first + count`` of one launch: ``starts`` the
    first chunk of each in the launch's numbering, ``chunks`` the launch's
    chunks (its grid), ``chunk0`` its first chunk in the step's."""

    first: int
    count: int
    starts: tuple
    chunks: int
    chunk0: int


def transposed(g: torch.Tensor) -> bool:
    """Whether ``g`` is a row-major array seen transposed in its last two
    dims: autograd's layout for the gradient of a weight the forward reads
    as ``w^T`` (the MoE experts and router)."""
    return g.dim() >= 2 and not g.is_contiguous() and g.transpose(-1, -2).is_contiguous()


def leaf_chunks(shape, tiled: bool = False) -> int:
    """The chunks of a leaf of ``shape``: ``CHUNK`` elements each, the last
    ragged; ``tiled``, ``TILE`` x ``TILE`` squares of each of its matrices
    (the last two dims), those on the edges ragged.  None when empty."""
    numel = math.prod(shape)
    if not tiled or not numel:
        return -(-numel // CHUNK)
    rows, cols = shape[-2:]
    return numel // (rows * cols) * -(-rows // TILE) * -(-cols // TILE)


def chunk_groups(counts, max_leaves: int = MAX_LEAVES) -> list[Group]:
    """Leaves of ``counts`` chunks each into launches of at most
    ``max_leaves`` leaves."""
    groups, chunk0 = [], 0
    for first in range(0, len(counts), max_leaves):
        starts, total = [], 0
        for n in counts[first:first + max_leaves]:
            starts.append(total)
            total += n
        groups.append(Group(first, len(starts), tuple(starts), total, chunk0))
        chunk0 += total
    return groups


def _vec_aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % (4 * t.element_size()) == 0


def leaf_flags(g: torch.Tensor, p=None, m=None, v=None, trans: bool = False) -> int:
    """The table's flags of a leaf (``p``, ``m``, ``v`` None: the gradient
    alone, read in its storage's order, as the norm reads it; ``trans``:
    ``g`` is :func:`transposed`)."""
    flags = (G_BF16 if g.dtype == torch.bfloat16 else 0) | (G_VEC if _vec_aligned(g) else 0)
    if p is None:
        return flags
    flags |= P_BF16 if p.dtype == torch.bfloat16 else 0
    if trans:
        return flags | TRANS
    return flags | (VEC if all(_vec_aligned(t) for t in (p, g, m, v)) else 0)


def leaf_table(group: Group, grads, params=None, ms=None, vs=None, trans=None) -> list[int]:
    """The flat table of ``group``'s leaves the C entry points take:
    ``FIELDS`` int64 entries a leaf (pointers 0 where the norm reads the
    gradients alone; rows and cols 0 but for a gradient ``trans`` marks
    :func:`transposed`)."""
    values = []
    for k in range(group.count):
        i = group.first + k
        g = grads[i]
        if params is None:
            values += (0, g.data_ptr(), 0, 0, g.numel(), group.starts[k], leaf_flags(g), 0, 0)
        else:
            p, m, v = params[i], ms[i], vs[i]
            t = bool(trans and trans[i])
            rows, cols = p.shape[-2:] if t else (0, 0)
            values += (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), g.numel(),
                       group.starts[k], leaf_flags(g, p, m, v, t), rows, cols)
    return values


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    fn = getattr(_build.library("adamw"), symbol)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        "adamw_sumsq_launch": [ptr, i32, i32, ptr, ptr],
        "adamw_update_launch": [ptr, i32, i32, ptr, ptr, i32, ptr, ptr, ptr],
        "adamw_fold_launch": [ptr, i32, i32, ptr, ptr, ptr],
        "adamw_norm_launch": [ptr, i32, ptr, ptr],
    }[symbol]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, name: str, *args) -> None:
    _build.check(_entry(symbol)(*args), name)
    _build.count(name)


def _check(what: str, device, t: torch.Tensor, dtypes=_DTYPES) -> None:
    if t.device != device:
        raise ValueError(f"{what}: every tensor must be on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} unsupported ({', '.join(map(str, dtypes))})")


class _Leaves:
    """The launches' view of the leaves: the tensors as the kernels take
    them (a gradient transposed in its last two dims as it is, any other
    non-contiguous leaf copied, its parameter and moments written back after
    the update), and the chunk groups and tables of the two passes: the
    norm's over each gradient's storage in order, the update's over the
    parameters (a transposed gradient's leaf in squares)."""

    def __init__(self, what: str, grads, params=None, ms=None, vs=None):
        device = grads[0].device
        if device.type != "cuda":
            raise ValueError(f"{what}: the kernels take CUDA tensors, got {device}")
        self.writeback = []
        self.p = self.m = self.v = self.trans = None
        if params is None:
            self.g = [self._contiguous(what, device, g, False, keep_transposed=True)
                      for g in grads]
        else:
            if not len(params) == len(grads) == len(ms) == len(vs):
                raise ValueError(f"{what}: {len(params)} parameters, {len(grads)} gradients, "
                                 f"{len(ms)} and {len(vs)} moments")
            self.p = [self._contiguous(what, device, p, True) for p in params]
            self.m = [self._contiguous(what, device, m, True, (torch.float32,)) for m in ms]
            self.v = [self._contiguous(what, device, v, True, (torch.float32,)) for v in vs]
            self.g = [self._contiguous(what, device, g, False, keep_transposed=g.shape == p.shape)
                      for g, p in zip(grads, self.p)]
            # A gradient kept as it is but not contiguous is a transposed one.
            self.trans = [not g.is_contiguous() for g in self.g]
            for p, g, m, v in zip(self.p, self.g, self.m, self.v):
                if not p.numel() == g.numel() == m.numel() == v.numel():
                    raise ValueError(f"{what}: a leaf of {p.numel()} parameters has "
                                     f"{g.numel()} gradients, {m.numel()} and {v.numel()} moments")
        self.device = device
        self.stream = torch.cuda.current_stream(device).cuda_stream
        flat = [leaf_chunks(g.shape) for g in self.g]
        self.norm_groups = chunk_groups(flat)
        self.chunks = sum(gr.chunks for gr in self.norm_groups)
        if params is None:
            self.norm_tables = [self._table(gr, False) for gr in self.norm_groups]
            return
        counts = [leaf_chunks(g.shape, True) if t else n
                  for g, t, n in zip(self.g, self.trans, flat)]
        self.groups = chunk_groups(counts) if counts != flat else self.norm_groups
        self.update_chunks = sum(gr.chunks for gr in self.groups)
        self.tables = [self._table(gr, True) for gr in self.groups]
        # The norm reads only the gradients' entries: the update's table
        # serves it where the two passes cut the leaves alike.
        self.norm_tables = (self.tables if self.groups is self.norm_groups
                            else [self._table(gr, False) for gr in self.norm_groups])

    def _contiguous(self, what, device, t, written, dtypes=_DTYPES, keep_transposed=False):
        """``t``, or a contiguous copy where the kernels cannot read it (a
        gradient transposed in its last two dims they read as it is)."""
        _check(what, device, t, dtypes)
        if t.is_contiguous() or (keep_transposed and transposed(t)):
            return t
        buf = t.contiguous()
        if written:
            self.writeback.append((t, buf))
        return buf

    def _table(self, group: Group, update: bool):
        values = (leaf_table(group, self.g, self.p, self.m, self.v, self.trans) if update
                  else leaf_table(group, self.g))
        return (ctypes.c_longlong * len(values))(*values)

    def sumsq(self) -> torch.Tensor:
        """float32 sums of squares of the gradients, one a chunk (one
        ``adamw_sumsq`` launch a group)."""
        partials = torch.empty(self.chunks, dtype=torch.float32, device=self.device)
        for group, table in zip(self.norm_groups, self.norm_tables):
            if group.chunks:
                _launch("adamw_sumsq_launch", "adamw_sumsq", table, group.count, group.chunks,
                        partials.data_ptr() + 4 * group.chunk0, self.stream)
        return partials

    def norm(self, partials: torch.Tensor) -> torch.Tensor:
        out = torch.empty((), dtype=torch.float32, device=self.device)
        _launch("adamw_norm_launch", "adamw_norm", partials.data_ptr(), self.chunks,
                out.data_ptr(), self.stream)
        return out

    def update(self, hyper, partials: torch.Tensor | None, delta_norms: list | None):
        """``adamw_update`` over every group (the clip's scale from
        ``partials`` when given); returns the norm when clipping.
        ``delta_norms`` gets each leaf's update norm (``adamw_fold``)."""
        grad_norm = None
        if partials is not None:
            grad_norm = (torch.empty((), dtype=torch.float32, device=self.device) if self.chunks
                         else torch.zeros((), dtype=torch.float32, device=self.device))
        delta = (torch.empty(self.update_chunks, dtype=torch.float32, device=self.device)
                 if delta_norms is not None else None)
        h = (ctypes.c_float * len(hyper))(*hyper)
        norm_out = None if grad_norm is None or not self.chunks else grad_norm.data_ptr()
        for group, table in zip(self.groups, self.tables):
            if group.chunks:
                _launch("adamw_update_launch", "adamw_update", table, group.count, group.chunks,
                        h, None if partials is None else partials.data_ptr(), self.chunks,
                        norm_out, None if delta is None else delta.data_ptr() + 4 * group.chunk0,
                        self.stream)
                norm_out = None  # the first launch writes the norm
        for t, buf in self.writeback:
            t.copy_(buf)
        if delta_norms is not None:
            norms = torch.empty(len(self.g), dtype=torch.float32, device=self.device)
            for group, table in zip(self.groups, self.tables):
                _launch("adamw_fold_launch", "adamw_fold", table, group.count, group.chunks,
                        delta.data_ptr() + 4 * group.chunk0,
                        norms.data_ptr() + 4 * group.first, self.stream)
            delta_norms.extend(norms.unbind())
        return grad_norm


def _hyper(step: int, lr: float, betas, eps: float, weight_decay: float,
           max_norm: float = 0.0) -> tuple:
    """The update's scalars in double, as the plain loop computes them."""
    b1, b2 = betas
    return (b1, 1.0 - b1, b2, 1.0 - b2, 1.0 - b1**step, 1.0 - b2**step, eps, lr,
            1.0 - lr * weight_decay, max_norm)


def _on_cpu(tensors) -> bool:
    return tensors[0].device.type == "cpu"


def clip_adamw(params, grads, ms, vs, *, step: int, lr: float, max_norm: float,
               betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01,
               delta_norms: list | None = None) -> torch.Tensor:
    """Clip ``grads`` (lists of leaves) to ``max_norm`` by their global
    norm, then one AdamW step on ``params``, ``ms`` and ``vs`` in place
    (``step`` counts this one); returns the pre-clip norm, a 0-d float32
    tensor.  The gradients are read, never written."""
    if not params:
        return torch.zeros((), dtype=torch.float32)
    if _on_cpu(params):
        with phase("clip"):
            clipped, norm = clip_plain(grads, max_norm)
        with phase("adamw"):
            adamw_plain(params, clipped, ms, vs, step=step, lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay, delta_norms=delta_norms)
        return norm
    with phase("clip"):
        leaves = _Leaves("clip_adamw", grads, params, ms, vs)
        partials = leaves.sumsq()
    with phase("adamw"):
        return leaves.update(_hyper(step, lr, betas, eps, weight_decay, max_norm), partials,
                             delta_norms)


def adamw(params, grads, ms, vs, *, step: int, lr: float, betas=(0.9, 0.999),
          eps: float = 1e-8, weight_decay: float = 0.01, delta_norms: list | None = None) -> None:
    """One AdamW step on lists of leaves, in place, with no clip."""
    if not params:
        return
    if _on_cpu(params):
        adamw_plain(params, grads, ms, vs, step=step, lr=lr, betas=betas, eps=eps,
                    weight_decay=weight_decay, delta_norms=delta_norms)
        return
    _Leaves("adamw", grads, params, ms, vs).update(
        _hyper(step, lr, betas, eps, weight_decay), None, delta_norms)


def global_norm(leaves) -> torch.Tensor:
    """L2 norm over every tensor of ``leaves``, accumulated in float32 (the
    kernels' in double across chunks)."""
    if not leaves or _on_cpu(leaves):
        return global_norm_plain(leaves)
    run = _Leaves("global_norm", leaves)
    return run.norm(run.sumsq())
