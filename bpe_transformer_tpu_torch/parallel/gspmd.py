"""The sharded forward and backward of the GSPMD strategies (``fsdp``,
``tp``, ``fsdp_tp``, ``dp_tp``, ``ep``, ``dp_ep``, ``fsdp_ep``; the port's
counterpart of what XLA's SPMD partitioner derives from the JAX package's
``NamedSharding`` annotations).

Each rank holds its block of every leaf (``parallel/sharding.py``) and
runs the model's own block code (``models/transformer.py``,
``ops/losses.py``) with a :class:`GspmdLayout` handed down as ``shard``.
The layout writes every collective itself:

* **FSDP** (``data`` in a leaf's spec): the leaf is cast to the activation
  dtype and all-gathered over ``data`` just before its layer uses it.  Its
  gradient is cast to ``grads_dtype``, reduce-scattered and divided by the
  data size (the mean over the global batch).  A gathered weight that an
  operation saves for the backward is not kept: a saved-tensor hook
  records the shard and gathers it again when the backward reads it, so a
  rank holds about one layer's whole weights beyond its shards.
* **tp** (``model`` in a leaf's spec), Megatron's pairing: ``q_proj``,
  ``k_proj``, ``v_proj``, ``w1`` and ``w3`` split on d_out compute this
  rank's heads and hidden columns; ``output_proj`` and ``w2``, split on
  d_in, are followed by one all-reduce over ``model``; the region's entry
  is an identity with an all-reduce backward.  ``token_embeddings`` and
  ``lm_head`` split on the vocab run a vocab-parallel lookup (masked rows,
  then an all-reduce) and a vocab-parallel cross-entropy (the max, the sum
  of exponentials and the target logit, each all-reduced over ``model``).
  Attention is Megatron's only when the head and kv-head counts divide the
  model axis and the four leaves carry their splits; the FFN when its
  three leaves do.  A leaf whose split the block cannot use is gathered
  over ``model`` and the block computes on every model rank (its gradient
  is then whole on every rank, and each keeps its own block of it).
* **MoE** leaves take no ``tp``.  With a data axis, an MoE layer gathers
  the tokens of every data rank and routes them as one group, as XLA does
  with the global batch, and keeps this rank's rows.
* **ep** (``expert`` in an MoE leaf's spec): the tokens are not split over
  ``expert`` (JAX's batch spec names ``data`` only), so every expert rank
  holds the same tokens.  The router's rows are gathered over ``expert``,
  the global group is routed alike everywhere, each rank runs its
  ``e / ep`` experts on their slots, and one gather of the expert outputs
  over ``expert`` feeds the combine (``models/moe.py`` ``expert_axis``).
  Every expert rank then computes the same downstream, so each of these
  gathers keeps this rank's block of the gradient, as a gathered ``tp``
  leaf does; no all-to-all is needed.

The update over the local blocks (the loss and gradient means over
``data``, the clip norm over shards, AdamW in place, ZeRO-1's moments by
``zero1_opt_specs``, the taps' norms over shards) is
``training/train_step.py``'s, through the layout's reductions.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.parallel.mesh import all_gather_dim, reduce_scatter_dim
from bpe_transformer_tpu_torch.parallel.sharding import (
    _tokens,
    gather_leaf,
    gather_params,
    local_box,
    local_shape,
    param_specs,
    path_str,
    place_blocks,
    shard_params,
    spec_leaves,
    zero1_opt_specs,
)
from bpe_transformer_tpu_torch.tree import (
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_ATTN = ("q_proj", "k_proj", "v_proj", "output_proj")


class _Gathered:
    """A leaf of the compute tree that is gathered when a block reads it:
    the rank's float32 block and its gather plan."""

    __slots__ = ("block", "plan")

    def __init__(self, block, plan):
        self.block, self.plan = block, plan


class _GatherLeaf(torch.autograd.Function):
    """Cast to the activation dtype, then all-gather over the plan's axes;
    the backward reduce-scatters (``mean``) or keeps this rank's block
    (``slice``) of the gradient, axis by axis in reverse."""

    @staticmethod
    def forward(ctx, block, layout, plan):
        ctx.layout, ctx.plan, ctx.dtype = layout, plan, block.dtype
        out = layout._gather(block, plan)
        layout._remember(out, block, plan)
        return out

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        for dim, axis, kind in reversed(ctx.plan):
            if kind == "mean":
                g = reduce_scatter_dim(g.to(layout.grads_dtype), dim, axis).div_(axis.size)
            else:
                n = g.shape[dim] // axis.size
                g = g.narrow(dim, axis.index * n, n)
        return g.to(ctx.dtype), None, None


class _Enter(torch.autograd.Function):
    """A tensor-parallel region's entry: identity, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return ctx.axis.psum_(g.clone()), None


class _Exit(torch.autograd.Function):
    """A tensor-parallel region's exit: all-reduce, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.psum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL from this rank's vocab columns of float32 logits: the
    max, the sum of exponentials and the target logit, each all-reduced
    over the model axis; the gradient is this rank's columns of
    ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, targets, offset, axis):
        vocab = logits.shape[-1]
        m = logits.detach().amax(dim=-1)
        axis.pmax_(m)
        shifted = logits - m[..., None]
        e = torch.exp(shifted)
        s = e.sum(dim=-1)
        axis.psum_(s)
        t = targets.long() - offset
        mask = (t >= 0) & (t < vocab)
        t = torch.where(mask, t, torch.zeros_like(t))
        target = torch.gather(shifted, -1, t[..., None])[..., 0] * mask
        axis.psum_(target)
        ctx.save_for_backward(e.div_(s[..., None]), t, mask)
        return torch.log(s) - target

    @staticmethod
    def backward(ctx, g):
        softmax, t, mask = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, t[..., None], -mask.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


class GspmdLayout:
    """One strategy on one process-group mesh for one config: the specs of
    every leaf (whole shapes from ``full``, default the config's abstract
    tree), the moments' specs (``zero1_opt_specs`` under
    ``opt_sharding="zero1"``), which blocks run Megatron's regions, and each
    leaf's gather plan.  Passed as ``shard`` to the forward and as
    ``layout`` to the train step."""

    def __init__(self, config: ModelConfig, mesh, strategy: str, opt_sharding: str | None = None,
                 grads_dtype: str = "float32", full=None):
        from bpe_transformer_tpu_torch.models.transformer import abstract_params

        tokens = _tokens(strategy)
        self.config, self.mesh, self.strategy = config, mesh, strategy
        self.full = full if full is not None else abstract_params(config)
        self.specs = param_specs(self.full, mesh, strategy)
        self.moment_specs = (zero1_opt_specs(self.full, mesh, strategy)
                             if opt_sharding == "zero1" else self.specs)
        self.act_dtype = getattr(torch, config.activation_dtype)
        self.grads_dtype = getattr(torch, grads_dtype)
        self.data = mesh.axis("data") if mesh.shape.get("data", 1) > 1 else None
        self.model = (mesh.axis("model") if "tp" in tokens and mesh.shape.get("model", 1) > 1
                      else None)
        moe_layer = (self.specs["layers"][0]["ffn"] if self.specs["layers"]
                     and config.ffn_type == "moe" else {})
        self.expert = (mesh.axis("expert") if moe_layer and moe_layer["router"][0] == "expert"
                       and mesh.shape["expert"] > 1 else None)
        tp = self.model.size if self.model else 1
        layer = self.specs["layers"][0] if self.specs["layers"] else {}
        heads, kv = config.num_heads, config.num_kv_heads or config.num_heads
        self.attn_local = bool(
            self.model and layer and heads % tp == 0 and kv % tp == 0
            and all(layer["attn"][n][0] == "model" for n in ("q_proj", "k_proj", "v_proj"))
            and layer["attn"]["output_proj"][1] == "model")
        self.ffn_local = bool(
            self.model and layer and config.ffn_type != "moe"
            and layer["ffn"]["w1"][0] == "model" and layer["ffn"]["w3"][0] == "model"
            and layer["ffn"]["w2"][1] == "model")
        self.vocab_local = bool(self.model and self.specs["token_embeddings"][0] == "model")
        self.names = [path_str(path) for path, _ in tree_flatten_with_path(self.full)]
        self.leaf_specs = spec_leaves(self.full, self.specs)
        self.leaf_moment_specs = spec_leaves(self.full, self.moment_specs)
        self.leaf_plans = [self._plan(n, s) for n, s in zip(self.names, self.leaf_specs)]
        self.plan_of = dict(zip(self.names, self.leaf_plans))
        self.spec_of = dict(zip(self.names, self.leaf_specs))
        self.moment_spec_of = dict(zip(self.names, self.leaf_moment_specs))
        self._saved: dict = {}
        self._reducers: dict = {}

    # ------------------------------------------------------------ layout

    def _uses_model_split(self, name: str) -> bool:
        leaf = name.split("/")[-1]
        if leaf in _ATTN:
            return self.attn_local
        if "ffn" in name:
            return self.ffn_local
        return name in ("token_embeddings", "lm_head") and self.vocab_local

    def _plan(self, name: str, spec: tuple) -> tuple:
        """``((dim, axis, kind), ...)``: the gathers a leaf needs before a
        block reads it (``mean``: FSDP over data; ``slice``: a model split
        the block cannot use)."""
        plan = []
        for dim, axis in enumerate(spec):
            if axis is None or self.mesh.shape.get(axis, 1) == 1:
                continue
            if axis == "data":
                plan.append((dim, self.mesh.axis("data"), "mean"))
            elif axis == "model" and not self._uses_model_split(name):
                plan.append((dim, self.mesh.axis("model"), "slice"))
        return tuple(plan)

    def data_reduced(self, spec) -> bool:
        """True where a leaf's gradient is already the data mean after the
        backward (its FSDP gather's reduce-scatter)."""
        return self.data is not None and "data" in spec

    def zero1_dim(self, i: int):
        """The dim that ZeRO-1 adds the data split on for leaf ``i``, or
        None."""
        if self.data is None:
            return None
        for dim, (p, m) in enumerate(zip(self.leaf_specs[i], self.leaf_moment_specs[i])):
            if m == "data" and p != "data":
                return dim
        return None

    def select(self, path: tuple, shape: tuple):
        """The box of a checkpoint leaf that this rank holds
        (``checkpointing.load_checkpoint_sharded``'s ``select``): the
        params' blocks, the moments' blocks, the step whole."""
        if path[0] == "params":
            spec = self.spec_of.get(path_str(path[1:]))
        elif path[0] == "opt_state" and len(path) > 1 and path[1] in (1, 2):
            spec = self.moment_spec_of.get(path_str(path[2:]))
        else:
            return None
        if spec is None:
            raise ValueError(f"checkpoint leaf {path_str(path)} is not a leaf of this model")
        return local_box(shape, spec, self.mesh.shape, self.mesh.coords)

    def place(self, tree, specs=None):
        """This rank's blocks, as float32 tensors on the mesh's device, of a
        tree whose leaves are whole (a single-file checkpoint, a dense
        state) or already this rank's blocks (a sharded directory read with
        :meth:`select`), under ``specs`` (default the params')."""
        return place_blocks(tree, self.full, specs if specs is not None else self.specs,
                            self.mesh)

    def shard(self, full):
        """This rank's blocks of whole parameters (tensors or numpy)."""
        return shard_params(full, self.mesh, specs=self.specs)

    def gather_leaf(self, block, spec):
        """One whole leaf on every rank from its blocks under ``spec``."""
        return gather_leaf(block, spec, self.mesh)

    def gather(self, params):
        """The whole parameters on every rank from the blocks."""
        return gather_params(params, self.mesh, specs=self.specs)

    def init_opt_state(self):
        """Zero AdamW moments in this rank's blocks (the moments' specs),
        float32 on the mesh's device."""
        from bpe_transformer_tpu_torch.optim.adamw import AdamWState

        def zeros(leaf, spec):
            return torch.zeros(local_shape(tuple(leaf.shape), spec, self.mesh.shape),
                               dtype=torch.float32, device=self.mesh.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, self.full, self.moment_specs),
                          v=tree_map(zeros, self.full, self.moment_specs))

    # ----------------------------------------------------------- forward

    def compute_params(self, params):
        """The forward's tree: leaves cast to the activation dtype, and
        :class:`_Gathered` handles for the leaves a block gathers."""
        leaves = tree_leaves(params)
        out = []
        for leaf, plan in zip(leaves, self.leaf_plans, strict=True):
            if plan:
                out.append(_Gathered(leaf, plan))
            else:
                out.append(leaf if leaf.dtype == self.act_dtype else leaf.to(self.act_dtype))
        return tree_unflatten(params, out)

    def materialize(self, tree):
        """``tree`` with every :class:`_Gathered` handle gathered."""
        if isinstance(tree, _Gathered):
            return _GatherLeaf.apply(tree.block, self, tree.plan)
        if isinstance(tree, dict):
            return {k: self.materialize(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.materialize(v) for v in tree)
        return tree

    def _gather(self, block, plan):
        out = block.detach().to(self.act_dtype)
        for dim, axis, _ in plan:  # every axis of a plan has more than one rank
            out = all_gather_dim(out, dim, axis)
        return out

    def _remember(self, out, block, plan):
        """Record a gathered weight, so that a save of it for the backward
        keeps the shard instead (:meth:`saved_tensors_hooks`)."""
        key = out.untyped_storage().data_ptr()
        self._saved[key] = (block.detach(), plan)
        weakref.finalize(out, self._saved.pop, key, None)

    def saved_tensors_hooks(self):
        """The hooks that keep a gathered weight's shard, not the weight,
        for the backward, and gather it again when the backward reads it."""
        layout = self

        def pack(t):
            entry = layout._saved.get(t.untyped_storage().data_ptr())
            if entry is None:
                return t
            return (_Gathered(*entry), tuple(t.size()), tuple(t.stride()), t.storage_offset())

        def unpack(obj):
            if not isinstance(obj, tuple):
                return obj
            handle, size, stride, offset = obj
            return layout._gather(handle.block, handle.plan).as_strided(size, stride, offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    def enter(self, x):
        return _Enter.apply(x, self.model)

    def exit(self, x):
        return _Exit.apply(x, self.model)

    def vocab_offset(self, vocab_local: int) -> int:
        return self.model.index * vocab_local

    def embed(self, table, token_ids):
        """The embedding lookup: vocab-parallel (masked rows, then an
        all-reduce over ``model``) when the table is split on the vocab,
        else a lookup in the (gathered) table."""
        if not self.vocab_local:
            return self.materialize(table)[token_ids]
        table = self.materialize(table)
        offset = self.vocab_offset(table.shape[0])
        t = token_ids.long() - offset
        mask = (t >= 0) & (t < table.shape[0])
        rows = table[torch.where(mask, t, torch.zeros_like(t))] * mask[..., None].to(table.dtype)
        return self.exit(rows)

    def lm_loss(self, params, hidden, targets, chunk_size):
        """The mean LM cross-entropy of ``ops/losses.lm_loss`` under the
        float32 head of ``params`` (the embedding when tied): gathered, or
        vocab-parallel when it is split on the vocab."""
        from bpe_transformer_tpu_torch.ops.losses import lm_loss

        name = "token_embeddings" if self.config.tie_embeddings else "lm_head"
        plan = self.plan_of[name]
        head_w = params[name]
        if plan:
            head_w = _GatherLeaf.apply(head_w, self, plan)
        if not self.vocab_local:
            return lm_loss(hidden, head_w, targets, chunk_size)
        return lm_loss(self.enter(hidden), head_w, targets, chunk_size, nll=self.nll)

    def nll(self, logits, targets):
        """Per-token NLL of this rank's vocab columns (the vocab-parallel
        cross-entropy)."""
        return _VocabParallelNLL.apply(logits, targets, self.vocab_offset(logits.shape[-1]),
                                       self.model)

    def heads(self) -> tuple[int, int | None]:
        """``(num_heads, num_kv_heads)`` of this rank's attention."""
        c = self.config
        if not self.attn_local:
            return c.num_heads, c.num_kv_heads
        tp = self.model.size
        return c.num_heads // tp, (c.num_kv_heads // tp if c.num_kv_heads else None)

    def moe(self, x, ffn_params, config):
        """An MoE FFN over the tokens of every data rank, routed as one
        group (the global batch, as under XLA), this rank's rows kept; its
        experts split over ``expert`` under ep."""
        from bpe_transformer_tpu_torch.models.moe import switch_ffn

        if self.data is None:
            return switch_ffn(x, ffn_params, config, expert_axis=self.expert)
        rows = x.shape[0]
        out, aux = switch_ffn(self.data.all_gather(x, 0), ffn_params, config,
                              expert_axis=self.expert)
        return out[self.data.index * rows:(self.data.index + 1) * rows], aux

    # ----------------------------------------------------------- reductions

    def leaf_reducer(self, specs: list):
        """``reduce(vec)``: a per-leaf vector of sums (squares, counts) over
        the leaves' blocks, summed over the axes each leaf is split on (a
        replicated leaf counted once): one masked all-reduce per axis.  The
        masks are made on the card once per spec list, so a step copies
        nothing from the host."""
        key = tuple(specs)
        if key not in self._reducers:
            masks = []
            for name in ("data", "model", "expert"):
                if self.mesh.shape.get(name, 1) > 1:
                    mask = [name in spec for spec in specs]
                    if any(mask):
                        masks.append((self.mesh.axis(name),
                                      torch.tensor(mask, device=self.mesh.device)))
            self._reducers[key] = masks
        masks = self._reducers[key]

        def reduce(vec):
            for axis, mask in masks:
                red = axis.psum_(torch.where(mask, vec, torch.zeros_like(vec)))
                vec = torch.where(mask, red, vec)
            return vec

        return reduce

    def act_stats(self, stats: dict) -> dict:
        """Per-layer activation statistics of the global batch: the RMS of
        every data rank's rows, the max, the non-finite sum, and the
        attention entropy of the global batch element 0 (data rank 0's),
        averaged over the heads of every model rank."""
        entropy = stats["attn_entropy"].float().clone()
        if self.attn_local:
            self.model.pmean_(entropy)
        if self.data is None:
            return {**stats, "attn_entropy": entropy}
        rms = stats["rms"].float()
        first = entropy if self.data.index == 0 else torch.zeros_like(entropy)
        return {
            "rms": torch.sqrt(self.data.pmean_(rms * rms)),
            "absmax": self.data.pmax_(stats["absmax"].float().clone()),
            "nonfinite": self.data.psum_(stats["nonfinite"].clone()),
            "attn_entropy": self.data.psum_(first.clone()),
        }


def block_bytes(config: ModelConfig, mesh_shape: dict, strategy: str, zero1: bool,
                coords: dict | None = None) -> dict:
    """Bytes of a rank's float32 params and moments under the specs (the
    arithmetic the card's readings are held to)."""
    from bpe_transformer_tpu_torch.models.transformer import abstract_params

    full = abstract_params(config)
    specs = param_specs(full, mesh_shape, strategy)
    moments = zero1_opt_specs(full, mesh_shape, strategy) if zero1 else specs
    coords = coords or {name: 0 for name in mesh_shape}

    def nbytes(spec_tree):
        total = 0
        for leaf, spec in zip(tree_leaves(full), spec_leaves(full, spec_tree), strict=True):
            box = local_box(tuple(leaf.shape), spec, mesh_shape, coords)
            total += 4 * int(np.prod([b - a for a, b in box]))
        return total

    return {"params": nbytes(specs), "moments": 2 * nbytes(moments),
            "dense_params": 4 * sum(int(np.prod(tuple(t.shape))) for t in tree_leaves(full))}

