"""Transformer parameters and the training forward (port of the dense
path of ``bpe_transformer_tpu/models/transformer.py``).

Parameters are the JAX package's tree as a plain nested dict of tensors::

    {"token_embeddings": (V, d),
     "layers": [{"attn": {"q_proj", "k_proj", "v_proj", "output_proj"},
                 "ln1": (d,), "ln2": (d,), "ffn": {"w1", "w2", "w3"}}, ...],
     "ln_final": (d,), "lm_head": (V, d)}     # no lm_head when tied

with every matrix in the ``(d_out, d_in)`` layout, so the torch-style flat
state dict and the JAX tree (as numpy arrays) both map onto it 1:1.

The forward (:func:`forward`, :func:`forward_hidden`) is the JAX package's:
pre-norm blocks (post-norm under the ablation flag), mixed precision by a
differentiable cast of float32 masters to ``activation_dtype``, and the
graduated ``remat_policy`` through ``torch.utils.checkpoint``.
``attention_impl`` selects the materialized attention (``"xla"``), the flash
kernels (``"flash"``) or RoPE inside the flash kernel (``"flash_fused"``,
from ``flash_fused_min_seq`` up); ``ffn_impl="pallas"`` the fused SwiGLU
kernel.  Every FFN kind is ported: SwiGLU, the two-matrix ``silu`` and
``gelu`` FFNs (the GeLU kernel runs in every ``gelu`` FFN) and the routed
experts of ``ffn_type="moe"`` (``models/moe.py``), whose layers hold
``{"router": (e, d), "w1": (e, ff, d), "w2": (e, d, ff), "w3": (e, ff, d)}``
and whose load-balance losses the blocks sum into the aux loss.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.moe import init_moe_params, switch_ffn
from bpe_transformer_tpu_torch.ops.core import (
    attention_entropy,
    causal_mask,
    embedding,
    head_logits,
    linear,
    multihead_self_attention,
    rmsnorm,
    scaled_dot_product_attention,
    silu,
    swiglu,
)
from bpe_transformer_tpu_torch.ops.rope import rope_tables
from bpe_transformer_tpu_torch.tree import tree_map

Params = dict


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters with the JAX package's tree and init law:
    truncated normal (std 0.02, cut at 3 std) projections, unit norms.
    Every dense FFN kind gets ``w1``, ``w2`` and ``w3``: the JAX package
    builds ``w3`` for the two-matrix ``silu``/``gelu`` FFNs too, which never
    read it.  An MoE layer gets the router and the stacked experts of
    :func:`models.moe.init_moe_params`.

    Draws come from ``generator`` on the generator's own device and are then
    moved to ``device`` (a seed gives the same weights whatever the target).
    The values differ from ``jax.random``'s for the same seed; carry JAX
    weights across with :func:`params_from_jax` instead.
    """
    dev = resolve_device(device)
    gen_dev = generator.device

    def dense(d_out, d_in, std=0.02):
        w = torch.empty((d_out, d_in), dtype=torch.float32, device=gen_dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        return (w * std).to(device=dev, dtype=dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    d, ff, v = config.d_model, config.d_ff, config.vocab_size
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head
    embed = dense(v, d)
    head = dense(v, d)
    layers = []
    for _ in range(config.num_layers):
        attn = {
            "q_proj": dense(d, d),
            "k_proj": dense(d_kv, d),
            "v_proj": dense(d_kv, d),
            "output_proj": dense(d, d),
        }
        if config.ffn_type == "moe":
            ffn = init_moe_params(config, generator, dev, dtype)
        else:
            ffn = {"w1": dense(ff, d), "w2": dense(d, ff), "w3": dense(ff, d)}
        layers.append({"attn": attn, "ln1": ones(d), "ln2": ones(d), "ffn": ffn})
    params = {"token_embeddings": embed, "layers": layers, "ln_final": ones(d)}
    if not config.tie_embeddings:
        params["lm_head"] = head
    return params


def abstract_params(config: ModelConfig) -> Params:
    """The parameter tree of :func:`init_params` as ``meta`` tensors: the
    shapes, no storage and no draws (the counterpart of JAX's
    ``eval_shape`` of the init)."""
    d, ff, v = config.d_model, config.d_ff, config.vocab_size
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head

    def t(*shape):
        return torch.empty(shape, device="meta")

    def ffn():
        if config.ffn_type == "moe":
            e = config.n_experts
            return {"router": t(e, d), "w1": t(e, ff, d), "w2": t(e, d, ff), "w3": t(e, ff, d)}
        return {"w1": t(ff, d), "w2": t(d, ff), "w3": t(ff, d)}

    layers = [{"attn": {"q_proj": t(d, d), "k_proj": t(d_kv, d), "v_proj": t(d_kv, d),
                        "output_proj": t(d, d)},
               "ln1": t(d), "ln2": t(d), "ffn": ffn()} for _ in range(config.num_layers)]
    params = {"token_embeddings": t(v, d), "layers": layers, "ln_final": t(d)}
    if not config.tie_embeddings:
        params["lm_head"] = t(v, d)
    return params


def lm_head_weight(params: Params, config: ModelConfig) -> torch.Tensor:
    """The vocab-projection matrix: the embedding itself when tied."""
    if config.tie_embeddings:
        return params["token_embeddings"]
    return params["lm_head"]


def _ffn(x: torch.Tensor, ffn_params: dict, config: ModelConfig,
         moe_capacity: int | None = None, moe_groups: int = 1, shard=None):
    """FFN dispatch, the JAX package's ``_ffn``; returns ``(output,
    aux_loss)``.  The aux is MoE's load-balance loss and ``None`` for the
    dense kinds, where the JAX package returns 0: the training blocks make
    that 0 themselves, so the decode path, which drops the aux, launches no
    fill for it:

    * SwiGLU (``ffn_type`` None or ``"swiglu"``): ``ffn_impl="pallas"`` runs
      the fused kernel (``kernels/swiglu.py``), anything else the plain
      composition.  int8 quantized serving weights (dict leaves) always take
      the plain composition, whose three linears each run the int8 matmul
      kernel: the fused kernel reads plain weight tensors.
    * ``"silu"``: ``linear(silu(linear(x, w1)), w2)``, plain.
    * ``"gelu"``: ``linear(gelu(linear(x, w1)), w2)`` with the GeLU kernel
      (``kernels/gelu.py``) whatever ``ffn_impl`` says, as the JAX branch
      always calls its Pallas kernel.

    * ``"moe"``: :func:`models.moe.switch_ffn`, plain (its expert products
      are batched matmuls, as the JAX package's are einsums outside any
      kernel; ``ffn_impl`` does not apply).  ``moe_capacity`` overrides the
      per-call expert capacity (the decode path's), ``moe_groups`` routes
      that many equal slices of the tokens as separate dispatch groups (the
      stacked sequence-parallel ring's ranks).

    The two-matrix kinds leave ``w3`` unread; it stays in the tree, as in
    the JAX package's.

    ``shard`` (a :class:`parallel.gspmd.GspmdLayout`) runs the FFN as a
    tensor-parallel region on this rank's hidden columns, or the MoE FFN
    over every data rank's tokens."""
    if shard is not None:
        if config.ffn_type == "moe":
            return shard.moe(x, ffn_params, config)
        if shard.ffn_local:
            out, aux = _ffn(shard.enter(x), ffn_params, config)
            return shard.exit(out), aux
    if config.ffn_type == "moe":
        return switch_ffn(x, ffn_params, config, capacity=moe_capacity, groups=moe_groups)
    w1, w2 = ffn_params["w1"], ffn_params["w2"]
    if config.ffn_type in (None, "swiglu"):
        w3 = ffn_params["w3"]
        if config.ffn_impl == "pallas" and not isinstance(w1, dict):
            from bpe_transformer_tpu_torch.kernels.swiglu import swiglu_fused

            return swiglu_fused(x, w1, w2, w3), None
        return swiglu(x, w1, w2, w3), None
    if config.ffn_type == "silu":
        return linear(silu(linear(x, w1)), w2), None
    if config.ffn_type == "gelu":
        from bpe_transformer_tpu_torch.kernels.gelu import gelu

        return linear(gelu(linear(x, w1)), w2), None
    raise ValueError(f"unknown ffn_type: {config.ffn_type!r}")


def _tensor(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.tensor(np.asarray(value), device=device)  # a copy: JAX arrays are read-only


def params_from_jax(tree, device: str | torch.device = "cuda") -> Params:
    """The JAX param tree (``jax.device_get``/numpy leaves) as tensors on
    ``device``, with the same nesting and keys."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    return _tensor(tree, dev)


def params_from_state_dict(
    state_dict: dict,
    num_layers: int,
    tied: bool = False,
    device: str | torch.device = "cuda",
) -> Params:
    """Build the param tree from flat torch-style keys (numpy or tensor
    values): ``token_embeddings.weight``,
    ``layers.{i}.attn.{q,k,v,output}_proj.weight``,
    ``layers.{i}.ln{1,2}.weight``, ``layers.{i}.ffn.w{1,2,3}.weight``,
    ``ln_final.weight`` and, unless ``tied``, ``lm_head.weight``."""
    dev = resolve_device(device)

    def get(key):
        return _tensor(state_dict[key], dev)

    head = {} if tied else {"lm_head": get("lm_head.weight")}
    layers = []
    for i in range(num_layers):
        p = f"layers.{i}."
        layers.append(
            {
                "attn": {
                    name: get(p + f"attn.{name}.weight")
                    for name in ("q_proj", "k_proj", "v_proj", "output_proj")
                },
                "ln1": get(p + "ln1.weight"),
                "ln2": get(p + "ln2.weight"),
                "ffn": {w: get(p + f"ffn.{w}.weight") for w in ("w1", "w2", "w3")},
            }
        )
    return {
        "token_embeddings": get("token_embeddings.weight"),
        "layers": layers,
        "ln_final": get("ln_final.weight"),
        **head,
    }


# ------------------------------------------------------------------ forward


def _maybe_norm(x, weight, config: ModelConfig):
    return x if config.remove_rmsnorm else rmsnorm(x, weight)


def _attention(x, attn_params: dict, config: ModelConfig, rope_cos_sin, positions,
               attention_fn=None, entropy_tap: dict | None = None, shard=None):
    """Self-attention of one block with the config's ``attention_impl``.
    ``entropy_tap`` (a dict, dynamics introspection) receives this layer's
    mean attention entropy under ``"attn_entropy"``.  ``shard``: a
    tensor-parallel region over this rank's heads, when the layout runs
    one (:class:`parallel.gspmd.GspmdLayout`)."""
    if attention_fn is None and config.attention_impl == "flash":
        from bpe_transformer_tpu_torch.kernels.flash_attention import flash_attention

        attention_fn = flash_attention
    elif attention_fn is None and config.attention_impl == "flash_fused":
        from bpe_transformer_tpu_torch.kernels.flash_attention import (
            flash_attention,
            flash_attention_rope,
        )

        if rope_cos_sin is None:
            raise ValueError("attention_impl='flash_fused' requires RoPE enabled")
        if positions.ndim != 1:
            # Checked before the crossover so the contract does not depend on
            # the sequence length.
            raise ValueError(
                "attention_impl='flash_fused' shares one cos/sin tile across "
                f"the batch, so positions must be 1-D, got {tuple(positions.shape)}; "
                "use attention_impl='flash' for per-example positions"
            )
        if x.shape[-2] < config.flash_fused_min_seq:
            # Below the crossover: the plain flash kernel, RoPE outside.
            attention_fn = flash_attention
        else:
            # RoPE moves inside the kernel: the tables are gathered at the
            # token positions here and attention gets a rope-free path.
            cos, sin = rope_cos_sin
            cos_p, sin_p = cos[positions], sin[positions]
            rope_cos_sin = None
            attention_fn = lambda q, k, v: flash_attention_rope(q, k, v, cos_p, sin_p)  # noqa: E731
    elif attention_fn is None and config.attention_impl != "xla":
        raise ValueError(f"unknown attention_impl: {config.attention_impl!r}")
    if entropy_tap is not None:
        # The entropy of the q/k handed to the attention callable: post-RoPE
        # for xla and flash, un-rotated under flash_fused above the
        # crossover (RoPE lives in the kernel there), as in the JAX package.
        # Batch element 0 only: the tap materializes an (S, S) score matrix.
        inner = attention_fn

        def tapped(q, k, v):
            entropy_tap["attn_entropy"] = attention_entropy(
                q[:1] if q.ndim > 3 else q, k[:1] if k.ndim > 3 else k
            )
            if inner is not None:
                return inner(q, k, v)
            return scaled_dot_product_attention(q, k, v, causal_mask(q.shape[-2], q.device))

        attention_fn = tapped
    region = shard is not None and shard.attn_local
    heads, kv_heads = shard.heads() if region else (config.num_heads, config.num_kv_heads)
    out = multihead_self_attention(
        shard.enter(x) if region else x,
        attn_params["q_proj"],
        attn_params["k_proj"],
        attn_params["v_proj"],
        attn_params["output_proj"],
        heads,
        num_kv_heads=kv_heads,
        positions=positions,
        rope_cos_sin=rope_cos_sin,
        causal=True,
        attention_fn=attention_fn,
    )
    return shard.exit(out) if region else out


def _materialize(shard, block_params: dict, *keys) -> dict:
    """The leaves ``keys`` of a block, gathered under a sharded layout
    (inside the half that reads them, so a checkpointed half gathers them
    again on its recompute)."""
    if shard is None:
        return block_params
    return {**block_params, **{k: shard.materialize(block_params[k]) for k in keys}}


def _attn_half(x, block_params: dict, config: ModelConfig, rope_cos_sin, positions,
               attention_fn=None, entropy_tap: dict | None = None, shard=None):
    """The residual attention half of one block: ``x + attn(norm(x))``
    pre-norm, ``norm(x + attn(x))`` post-norm."""
    block_params = _materialize(shard, block_params, "attn", "ln1")
    h = x if config.use_post_norm else _maybe_norm(x, block_params["ln1"], config)
    attn_out = _attention(
        h, block_params["attn"], config, rope_cos_sin, positions, attention_fn, entropy_tap,
        shard,
    )
    if config.use_post_norm:
        return _maybe_norm(x + attn_out, block_params["ln1"], config)
    return x + attn_out


def _ffn_half(x, block_params: dict, config: ModelConfig, moe_groups: int = 1, shard=None):
    """The residual FFN half of one block; returns ``(x, aux_loss)``."""
    block_params = _materialize(shard, block_params, "ffn", "ln2")
    if config.use_post_norm:
        f, aux = _ffn(x, block_params["ffn"], config, moe_groups=moe_groups, shard=shard)
        x = _maybe_norm(x + f, block_params["ln2"], config)
    else:
        f, aux = _ffn(_maybe_norm(x, block_params["ln2"], config), block_params["ffn"], config,
                      moe_groups=moe_groups, shard=shard)
        x = x + f
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def transformer_block_aux(x, block_params: dict, config: ModelConfig, rope_cos_sin,
                          positions, attention_fn=None, entropy_tap: dict | None = None,
                          moe_groups: int = 1, shard=None):
    """One block; returns ``(x, aux_loss)`` (aux nonzero only for MoE FFNs).
    ``entropy_tap``: see :func:`_attention`; ``moe_groups`` and ``shard``:
    see :func:`_ffn`."""
    x = _attn_half(x, block_params, config, rope_cos_sin, positions, attention_fn,
                   entropy_tap, shard)
    return _ffn_half(x, block_params, config, moe_groups, shard)


def _block_save_attn(x, block_params: dict, config: ModelConfig, rope_cos_sin,
                     positions, attention_fn=None, entropy_tap: dict | None = None,
                     moe_groups: int = 1, shard=None):
    """One block under ``remat_policy="save_attn"``: the attention half runs
    outside any checkpoint, so the flash autograd Function keeps its
    residuals (q/k/v, output, lse) and the attention forward runs once; the
    FFN half (ln2, FFN, residual) is checkpointed, its ``d_ff`` wide
    intermediates dropped and recomputed on the backward."""
    x = _attn_half(x, block_params, config, rope_cos_sin, positions, attention_fn,
                   entropy_tap, shard)
    return checkpoint(_ffn_half, x, block_params, config, moe_groups, shard,
                      use_reentrant=False)


#: Operators whose outputs ``remat_policy="dots_saveable"`` keeps (the
#: matrix products, as ``jax.checkpoint_policies.dots_saveable`` keeps dots).
_DOT_OPS = frozenset((
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
))


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def policy_block(config: ModelConfig):
    """The block callable for ``config.resolved_remat_policy``:

    * ``none`` -- the plain block;
    * ``full`` -- the whole block under ``torch.utils.checkpoint``, nothing
      saved (the flash forward re-runs on the backward);
    * ``dots_saveable`` -- the block checkpointed with a selective policy
      that keeps the outputs of matrix products; the kernels' autograd
      Functions are opaque to it, so their forwards re-run, as the opaque
      custom-VJP call does in the JAX package;
    * ``save_attn`` -- :func:`_block_save_attn`.
    """
    policy = config.resolved_remat_policy
    if policy == "none":
        return transformer_block_aux
    if policy == "save_attn":
        return _block_save_attn
    if policy == "full":
        return functools.partial(checkpoint, transformer_block_aux, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(
        checkpoint, transformer_block_aux, use_reentrant=False, context_fn=context_fn
    )


def _forward_prologue(params: Params, token_ids: torch.Tensor, config: ModelConfig,
                      positions: torch.Tensor | None, shard=None):
    """Seq validation, default positions, the mixed-precision cast of the
    master weights to ``activation_dtype`` (a differentiable ``.to``, so
    gradients reach the float32 masters), the embedding lookup and the RoPE
    tables.  Returns ``(x, compute_params, rope_cos_sin, positions)``.
    Under ``shard`` the leaves a block gathers stay handles until the block
    reads them, and the lookup is the layout's."""
    seq_len = token_ids.shape[-1]
    if seq_len > config.context_length:
        raise ValueError(
            f"sequence length {seq_len} exceeds context_length "
            f"{config.context_length} (RoPE tables are sized to the context)"
        )
    device = token_ids.device
    if positions is None:
        positions = torch.arange(seq_len, device=device)
    act_dtype = getattr(torch, config.activation_dtype)
    if shard is not None:
        compute_params = shard.compute_params(params)
        x = shard.embed(compute_params["token_embeddings"], token_ids).to(act_dtype)
    else:
        compute_params = params
        if act_dtype != torch.float32:
            compute_params = tree_map(lambda p: p.to(act_dtype), params)
        x = embedding(compute_params["token_embeddings"], token_ids).to(act_dtype)
    rope_cos_sin = None
    if not config.remove_rope:
        # Built per call, not taken from the decode path's cache: tables that
        # serving created under inference_mode cannot enter an autograd graph.
        rope_cos_sin = rope_tables(
            config.d_head, config.context_length, config.rope_theta, act_dtype, device
        )
    return x, compute_params, rope_cos_sin, positions


def _run_blocks(x, compute_params: dict, config: ModelConfig, rope_cos_sin, positions,
                attention_fn, per_layer: list | None = None, moe_groups: int = 1, shard=None):
    """The blocks under the remat policy, then the final norm; returns
    ``(hidden, aux_total)``.  ``per_layer``, a list, receives each block's
    activation statistics (:func:`_block_stats`)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = policy_block(config)
    for block_params in compute_params["layers"]:
        tap = None if per_layer is None else {}
        x, aux = block(x, block_params, config, rope_cos_sin, positions, attention_fn, tap,
                       moe_groups, shard)
        aux_total = aux_total + aux
        if per_layer is not None:
            per_layer.append(_block_stats(x, tap))
    ln_final = compute_params["ln_final"] if shard is None else shard.materialize(
        compute_params["ln_final"])
    return _maybe_norm(x, ln_final, config), aux_total


def forward_hidden(params: Params, token_ids: torch.Tensor, config: ModelConfig,
                   positions: torch.Tensor | None = None, attention_fn=None,
                   moe_groups: int = 1, shard=None):
    """Final-norm hidden states ``(batch, seq, d_model)`` and the summed MoE
    aux loss (0 for dense FFNs): everything of :func:`forward` but the LM
    head.  ``moe_groups`` routes that many equal slices of the batch's
    tokens as separate MoE dispatch groups (the stacked sp ring's ranks;
    each layer's aux is then the groups' mean).  ``scan_layers`` (one
    ``lax.scan`` over the blocks in the JAX package, for XLA compile time)
    is accepted and runs the same per-layer loop: eager PyTorch compiles
    nothing.  ``shard`` (a :class:`parallel.gspmd.GspmdLayout`) runs the
    blocks on this rank's blocks of the parameters."""
    x, compute_params, rope_cos_sin, positions = _forward_prologue(
        params, token_ids, config, positions, shard
    )
    return _run_blocks(x, compute_params, config, rope_cos_sin, positions, attention_fn,
                       moe_groups=moe_groups, shard=shard)


def _block_stats(x: torch.Tensor, tap: dict) -> dict:
    """A block output's activation statistics (no graph)."""
    with torch.no_grad():
        x32 = x.detach().float()
        return {
            "rms": torch.sqrt(torch.mean(x32 * x32)),
            "absmax": torch.max(torch.abs(x32)),
            "nonfinite": torch.sum(~torch.isfinite(x.detach())).to(torch.int32),
            "attn_entropy": tap.get(
                "attn_entropy", torch.zeros((), dtype=torch.float32, device=x.device)
            ),
        }


def forward_hidden_stats(params: Params, token_ids: torch.Tensor, config: ModelConfig,
                         positions: torch.Tensor | None = None, attention_fn=None,
                         moe_groups: int = 1, shard=None):
    """:func:`forward_hidden` plus per-block activation statistics.

    Returns ``(hidden, aux_total, act_stats)``; ``act_stats`` stacks one
    value per layer: ``{"rms": (L,), "absmax": (L,), "nonfinite": (L,)
    int32, "attn_entropy": (L,)}``, the block output's RMS, absmax and
    non-finite count and the mean attention entropy of batch element 0.
    They come from the same forward the step differentiates, under the
    same ``remat_policy`` (a recomputed block rewrites its tap with the
    same value), and stay on the device."""
    x, compute_params, rope_cos_sin, positions = _forward_prologue(
        params, token_ids, config, positions, shard
    )
    per_layer: list = []
    hidden, aux_total = _run_blocks(x, compute_params, config, rope_cos_sin, positions,
                                    attention_fn, per_layer, moe_groups, shard)
    act_stats = {key: torch.stack([stats[key] for stats in per_layer]) for key in per_layer[0]}
    return hidden, aux_total, act_stats


def forward(params: Params, token_ids: torch.Tensor, config: ModelConfig,
            positions: torch.Tensor | None = None, attention_fn=None,
            return_aux: bool = False, moe_groups: int = 1):
    """Float32 logits ``(batch, seq, vocab)`` for ``token_ids (batch, seq)``
    (``seq`` up to ``context_length``); with ``return_aux`` also the summed
    MoE aux loss."""
    x, aux_total = forward_hidden(params, token_ids, config, positions, attention_fn,
                                  moe_groups)
    logits = head_logits(x, lm_head_weight(params, config))
    if return_aux:
        return logits, aux_total
    return logits
