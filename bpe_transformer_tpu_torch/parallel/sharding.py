"""Parameter partition specs: dp (replicated), FSDP, tensor and expert
parallelism (port of ``bpe_transformer_tpu/parallel/sharding.py``).

A spec is a tuple with one entry a dim: the mesh axis the dim is split
over, or ``None``.  The rules are the JAX package's, leaf for leaf:

* **dp**: every parameter replicated; only the batch is split.
* **fsdp**: each parameter of at least :data:`FSDP_MIN_SIZE` elements has
  its largest dim that divides the ``data`` axis split over it.
* **tp**: Megatron's pairing over the ``model`` axis: ``q_proj``,
  ``k_proj``, ``v_proj``, ``w1``, ``w3``, ``token_embeddings`` and
  ``lm_head`` split on their first dim (d_out, or the vocab),
  ``output_proj`` and ``w2`` on their second (d_in); a split that does not
  divide is dropped, and MoE leaves take none.
* **ep**: an MoE leaf (the router ``(e, d)`` or a stacked expert weight)
  splits its leading expert dim over the ``expert`` axis when ``e``
  divides it.

Specs compose: ``fsdp_tp`` applies tp first, then FSDP on a free dim;
``fsdp_ep`` splits the experts, then FSDP on a free dim.

Where JAX places arrays with ``NamedSharding``, each rank of the port's
process-group mesh (``parallel/mesh.py``) holds its own block of every
leaf: :func:`shard_params` cuts it, :func:`gather_params` puts the whole
leaves back together on every rank, and :func:`local_box` says which block
a rank holds.  Leaf paths are spelled as JAX's ``_path_str`` spells them
(``layers/0/attn/q_proj``).
"""

from __future__ import annotations

import numpy as np
import torch

from bpe_transformer_tpu_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

#: Minimum leaf size worth sharding under FSDP (tiny norms stay replicated).
FSDP_MIN_SIZE = 4096

def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a mesh (anything with a ``shape`` dict, or the
    dict itself)."""
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def path_str(path: tuple) -> str:
    """A key path as JAX's ``_path_str`` spells it (``layers/0/attn/q_proj``)."""
    return "/".join(str(part) for part in path)


def _tp_spec(name: str, ndim: int) -> list:
    """Tensor-parallel assignment for one parameter (list of axis names/None)."""
    spec: list = [None] * ndim
    if ndim != 2:
        return spec
    # Row-parallel (split d_out): QKV head blocks, FFN up-projections,
    # vocab-parallel embedding and LM head.
    if any(
        key in name
        for key in ("q_proj", "k_proj", "v_proj", "w1", "w3", "token_embeddings", "lm_head")
    ):
        spec[0] = "model"
    # Column-parallel (split d_in, contracted away -> psum): attention output
    # projection and FFN down-projection.
    elif any(key in name for key in ("output_proj", "w2")):
        spec[1] = "model"
    return spec


def _fsdp_extend(spec: list, shape: tuple, axis_size: int, fsdp_axis: str) -> list:
    """Shard the largest still-unsharded, divisible dim along the FSDP axis."""
    candidates = [
        (dim_size, i)
        for i, dim_size in enumerate(shape)
        if spec[i] is None and dim_size % axis_size == 0
    ]
    if candidates:
        _, best = max(candidates)
        spec[best] = fsdp_axis
    return spec


def is_moe_leaf(name: str, ndim: int) -> bool:
    """A router or a stacked expert weight of an MoE FFN (JAX's rule)."""
    return "ffn" in name and ("router" in name or ndim == 3)


def _tokens(strategy: str | None) -> set:
    tokens = set(strategy.split("_")) if strategy else set()
    unknown = tokens - {"dp", "fsdp", "tp", "ep"}
    if not tokens or unknown:
        raise ValueError(f"unknown parallel strategy: {strategy!r}")
    return tokens


def param_specs(params, mesh, strategy: str = "dp", *, fsdp_axis: str = "data",
                tp_axis: str = "model", ep_axis: str = "expert"):
    """The tree of specs (tuples) for ``params`` under a strategy, an
    underscore-joined set of ``{dp, fsdp, tp, ep}`` (``"fsdp_tp"``,
    ``"dp_ep"``).  Leaves need only ``shape`` (tensors on any device,
    ``meta`` ones included, or numpy arrays)."""
    tokens = _tokens(strategy)
    shape = _mesh_shape(mesh)
    use_tp = "tp" in tokens and tp_axis in shape
    use_fsdp = "fsdp" in tokens and fsdp_axis in shape
    use_ep = "ep" in tokens and ep_axis in shape
    fsdp_size = shape.get(fsdp_axis, 1)
    tp_size = shape.get(tp_axis, 1)
    ep_size = shape.get(ep_axis, 1)
    pairs = tree_flatten_with_path(params)
    specs = []
    for path, leaf in pairs:
        name = path_str(path)
        dims = tuple(leaf.shape)
        spec: list = [None] * len(dims)
        is_moe = is_moe_leaf(name, len(dims))
        if use_ep and is_moe and dims[0] % ep_size == 0:
            spec[0] = ep_axis
        if use_tp and not is_moe:
            spec = _tp_spec(name, len(dims))
            # Drop TP assignments that don't divide evenly.
            spec = [a if (a != tp_axis or dims[i] % tp_size == 0) else None
                    for i, a in enumerate(spec)]
        if use_fsdp and int(np.prod(dims)) >= FSDP_MIN_SIZE:
            spec = _fsdp_extend(spec, dims, fsdp_size, fsdp_axis)
        specs.append(tuple(spec))
    return tree_unflatten(params, specs)


def zero1_opt_specs(params, mesh, strategy: str = "dp", *, fsdp_axis: str = "data"):
    """ZeRO-1 specs of the AdamW moments: the strategy's param spec, plus
    each leaf's largest still-unsharded divisible dim split over the data
    axis (leaves of at least :data:`FSDP_MIN_SIZE` elements), so the
    moments live 1/N a rank even where the params are replicated (dp) or
    only model-sharded (tp).  Under ``fsdp`` nothing changes."""
    base = param_specs(params, mesh, strategy, fsdp_axis=fsdp_axis)
    size = _mesh_shape(mesh).get(fsdp_axis, 1)

    def extend(leaf, spec):
        s = list(spec) + [None] * (len(leaf.shape) - len(spec))
        if size <= 1 or fsdp_axis in s or int(np.prod(tuple(leaf.shape))) < FSDP_MIN_SIZE:
            return tuple(s)
        return tuple(_fsdp_extend(s, tuple(leaf.shape), size, fsdp_axis))

    return tree_map(extend, params, base)


def spec_leaves(params, specs) -> list:
    """The specs of ``params``'s leaves in :func:`tree.tree_leaves` order
    (a spec is a tuple, so a spec tree cannot be flattened on its own)."""
    if isinstance(params, dict):
        return [s for key in sorted(params) for s in spec_leaves(params[key], specs[key])]
    if isinstance(params, (list, tuple)):
        return [s for item, spec in zip(params, specs) for s in spec_leaves(item, spec)]
    return [tuple(specs)]


# ------------------------------------------------------- blocks on a mesh


def local_box(shape, spec, mesh_shape: dict, coords: dict) -> tuple:
    """The ``(start, stop)`` of each dim of the block a rank at ``coords``
    holds of a leaf of ``shape`` under ``spec``."""
    box = []
    for dim, axis in zip(shape, spec):
        if axis is None or mesh_shape.get(axis, 1) == 1:
            box.append((0, int(dim)))
            continue
        n = mesh_shape[axis]
        part = int(dim) // n
        box.append((coords[axis] * part, (coords[axis] + 1) * part))
    return tuple(box)


def local_shape(shape, spec, mesh_shape: dict) -> tuple:
    """The shape of one rank's block."""
    return tuple(int(d) // (mesh_shape.get(a, 1) if a else 1) for d, a in zip(shape, spec))


def distinct_boxes(shape, spec, mesh) -> list[tuple[tuple, int]]:
    """``(box, rank)`` for each distinct block of a leaf, in the order of
    the ranks that first hold it (the order of JAX's
    ``addressable_shards`` on the same mesh): ``rank`` is the lowest rank
    that holds the block."""
    seen: dict = {}
    grid = getattr(mesh, "grid", None)
    names = tuple(mesh.shape)
    if grid is None:
        grid = np.arange(int(np.prod(list(mesh.shape.values())))).reshape(
            tuple(mesh.shape.values()))
    for coord in sorted(np.ndindex(*grid.shape), key=lambda c: int(grid[c])):
        box = local_box(shape, spec, mesh.shape, dict(zip(names, coord)))
        seen.setdefault(box, int(grid[coord]))
    return list(seen.items())


def _slices(box) -> tuple:
    return tuple(slice(a, b) for a, b in box)


def shard_leaf(leaf, spec, mesh):
    """This rank's block of one whole leaf (a tensor, or a numpy array,
    memory-mapped ones included: only the block is read), as a contiguous
    tensor on the leaf's device (the mesh's for numpy)."""
    box = local_box(tuple(leaf.shape), spec, mesh.shape, mesh.coords)
    block = leaf[_slices(box)]
    if isinstance(block, torch.Tensor):
        # A copy: the step updates the blocks in place.
        return block.clone(memory_format=torch.contiguous_format)
    return torch.from_numpy(np.ascontiguousarray(block)).to(mesh.device)


def place_blocks(tree, full, specs, mesh):
    """This rank's blocks, as float32 tensors on the mesh's device, of a
    tree whose leaves are whole (shapes of ``full``) or already this rank's
    blocks under ``specs`` (a sharded directory read block by block)."""

    def block(leaf, whole, spec):
        shape = tuple(leaf.shape)
        if shape == tuple(whole.shape):
            box = local_box(shape, spec, mesh.shape, mesh.coords)
            leaf = leaf[_slices(box)]
        elif shape != local_shape(tuple(whole.shape), spec, mesh.shape):
            raise ValueError(f"a leaf of shape {shape} is neither whole {tuple(whole.shape)} "
                             f"nor this rank's block under {spec}")
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to(mesh.device, torch.float32).clone(
                memory_format=torch.contiguous_format)
        return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(mesh.device)

    return tree_map(block, tree, full, specs)


def shard_params(params, mesh, strategy: str = "dp", specs=None):
    """This rank's block of every leaf of whole ``params`` under the
    strategy's specs (or the given ``specs`` tree)."""
    specs = specs if specs is not None else param_specs(params, mesh, strategy)
    return tree_map(lambda leaf, spec: shard_leaf(leaf, spec, mesh), params, specs)


def gather_leaf(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A whole leaf from every rank's block (one all-gather per split dim;
    no graph), in storage of its own."""
    from bpe_transformer_tpu_torch.parallel.mesh import all_gather_dim

    out = block.detach()
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape.get(axis, 1) > 1:
            out = all_gather_dim(out, dim, mesh.axis(axis))
    return out.clone() if out.data_ptr() == block.data_ptr() else out


@torch.no_grad()
def gather_params(local, mesh, strategy: str = "dp", specs=None, full=None):
    """The whole leaves on every rank from each rank's blocks (the inverse
    of :func:`shard_params`).  ``specs`` defaults to the strategy's specs
    of ``full`` (a tree with the whole shapes; ``meta`` tensors do)."""
    if specs is None:
        if full is None:
            raise ValueError("gather_params needs specs or the whole shapes (full=)")
        specs = param_specs(full, mesh, strategy)
    return tree_map(lambda block, spec: gather_leaf(block, spec, mesh), local, specs)
