"""Typed model/training configuration: the port's own copy of
``bpe_transformer_tpu/models/config.py``.

Every field, its validation and the presets are kept as they are in the JAX
package, so a JSON config or a checkpoint-stored config dict loads to the
same values in both packages (:meth:`ModelConfig.from_dict`).  Knobs named
after TPU mechanics keep their names: ``attention_impl="flash"``,
``ffn_impl="pallas"`` and ``decode_attention_impl="pallas"`` select the
port's CUDA kernels; ``flash_block_size`` and the other TPU tile settings
are read by the JAX package only.  The comments below describe the JAX
package's training knobs, which the port's serving slice does not run.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    context_length: int
    d_model: int
    num_layers: int
    num_heads: int
    d_ff: int
    rope_theta: float = 10000.0
    #: Grouped-query attention: K/V heads (None -> num_heads, i.e. MHA).
    #: Must divide num_heads; shrinks KV projections and the decode cache
    #: by num_heads // num_kv_heads.
    num_kv_heads: int | None = None
    #: Tie the LM head to the token embedding matrix (no separate lm_head
    #: parameter; the reference contract's untied schema stays the default).
    tie_embeddings: bool = False
    # Ablation flags (reference schema; defaults = the tested architecture).
    remove_rmsnorm: bool = False
    use_post_norm: bool = False
    remove_rope: bool = False
    # None -> SwiGLU; "silu"/"gelu" -> 2-matrix FFN; "moe" -> routed experts
    ffn_type: str | None = None
    # MoE knobs (used when ffn_type == "moe").
    n_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    #: Experts per token: 1 = Switch routing, 2 = GShard-style top-2 (gates
    #: renormalized over the chosen experts).
    router_top_k: int = 1
    #: Expert dispatch formulation.  "einsum" builds dense one-hot
    #: dispatch/combine tensors (GShard-style; under an expert-sharded mesh
    #: GSPMD turns them into all-to-alls).  "gather" routes tokens to expert
    #: slots by index (identical assignments/gates) — the dense einsums cost
    #: 2·n·e·cap·d flops EACH, which at bench shapes exceeds the expert FFN
    #: compute itself, while gathers move only e·cap·d values.
    moe_dispatch: str = "einsum"
    # TPU execution knobs (not part of the reference schema).
    activation_dtype: str = "float32"  # "bfloat16" for the perf path
    #: DEPRECATED (PR 13): the all-or-nothing remat switch.  ``remat=True``
    #: is accepted as an alias for ``remat_policy="full"`` so old configs,
    #: checkpoints, and bench captures keep loading; new code should set
    #: ``remat_policy``.  Setting BOTH (``remat=True`` with a non-full
    #: ``remat_policy``) is a contradiction and fails validation.
    remat: bool = False
    #: Graduated activation-rematerialization policy for the backward pass
    #: (the training-MFU memory/flops dial; `models/transformer.py`):
    #:
    #: * ``"none"``  — save every intermediate (max memory, zero recompute);
    #: * ``"full"``  — ``jax.checkpoint`` each block saving only its input
    #:   (min memory; the whole block, flash-attention kernel included,
    #:   recomputes on the backward — the old ``remat=True``);
    #: * ``"dots_saveable"`` — block remat that SAVES matmul outputs
    #:   (``jax.checkpoint_policies.dots_saveable``): only cheap
    #:   elementwise/norm work recomputes, but the Pallas flash-attention
    #:   kernel is an opaque custom-vjp call the policy cannot see inside,
    #:   so its forward still re-runs;
    #: * ``"save_attn"`` — selective recompute (Korthikanti et al.): the
    #:   flash-attention call runs OUTSIDE the remat region, so the
    #:   backward reuses the FA-2 residuals the kernel already emits
    #:   (q/k/v, output, logsumexp — tagged ``checkpoint_name``) and the
    #:   O(S^2 d) attention never recomputes, while the memory-heavy,
    #:   cheap-flops FFN tail (ln2 + FFN + residual) rematerializes.
    #:   Peak HBM sits strictly below ``none``; recompute flops strictly
    #:   below ``full``/``dots_saveable``.
    remat_policy: str = "none"
    #: Stack the per-block parameters and run the layer stack as ONE
    #: policy-rematerialized ``lax.scan`` over blocks (training forward
    #: only; decode keeps its per-layer programs).  Compile time becomes
    #: O(1) in depth — the pjit-era trainer formulation (arXiv:2204.06514).
    #: The at-rest param pytree is unchanged (checkpoints, state-dict
    #: interop, ZeRO-1 flat layout all untouched); the stack happens inside
    #: the traced step and rides the mixed-precision cast's existing copy
    #: on bf16 configs.  Requires num_layers >= 1 and homogeneous blocks
    #: (always true for this architecture).
    scan_layers: bool = False
    # "xla" (materialized) | "flash" (Pallas) | "flash_fused" (RoPE in-kernel)
    attention_impl: str = "xla"
    # "xla" | "pallas" (fused SwiGLU kernel; swiglu FFNs only)
    ffn_impl: str = "xla"
    #: Decode-step attention against the KV cache: "xla" (grouped einsum,
    #: materialized scores) | "pallas" (flash-decoding streamed reduction,
    #: kernels/pallas/decode_attention.py) | "paged" (paged-NATIVE flash
    #: decode: the block table is consumed inside the kernel's index maps,
    #: so the serving tick reads K/V straight out of the block pool with no
    #: contiguous gather transient; only meaningful with the paged serving
    #: engine — the dense cache has no block table, so dense decode treats
    #: it as "pallas").  Inference-only knob — the training attention path
    #: is attention_impl.
    decode_attention_impl: str = "xla"
    flash_block_size: int = 256  # q/k tile size for the flash kernel
    #: attention_impl="flash_fused" auto-falls-back to the plain flash
    #: kernel (RoPE outside) below this sequence length: the in-kernel RoPE
    #: rematerialization only pays off once the sequence is long enough.
    #: The default is the JAX package's value, chosen on a TPU; it is kept as
    #: part of the config's definition and is not a crossover measured on
    #: the card.  Set to 0 to force the fused kernel at every length.
    flash_fused_min_seq: int = 2048
    # Sequence-chunked LM loss: cap peak logits memory at
    # O(batch * chunk * vocab) instead of O(batch * seq * vocab).
    # None -> AUTO: bfloat16 training configs default to chunking (the f32
    # (B, T, V) logits buffer is exactly the peak-memory spike the remat
    # policy fights; see ``loss_chunk``), float32 configs materialize full
    # logits.  0 -> force full logits.  N -> chunk N (must divide the
    # sequence; `ops.losses.lm_loss` falls back when it doesn't).
    loss_chunk_size: int | None = None
    # Sequence-parallel ring attention: sub-chunk each visiting K/V shard
    # so per-device score memory is O(S_local * chunk) instead of
    # O(S_local^2).  Must divide the local shard length.  None -> one full
    # block per ring step.
    ring_kv_chunk: int | None = None

    #: Default sequence chunk of the AUTO loss-chunking policy (bf16
    #: configs; clamped to the context length).
    AUTO_LOSS_CHUNK = 256

    @property
    def d_head(self) -> int:
        return self.d_model // self.num_heads

    @property
    def resolved_remat_policy(self) -> str:
        """The effective remat policy: ``remat_policy``, with the
        deprecated ``remat: bool`` accepted as ``"full"``."""
        if self.remat and self.remat_policy == "none":
            return "full"
        return self.remat_policy

    @property
    def loss_chunk(self) -> int | None:
        """The effective loss chunk size: explicit N, ``0`` -> None (full
        logits), ``None`` -> auto — bfloat16 training configs whose
        context exceeds :data:`AUTO_LOSS_CHUNK` chunk at that size, so the
        compiled step never materializes the f32 ``(B, T, V)`` logits
        tensor.  Shorter contexts (the chunk would BE the sequence — no
        buffer shrinks) and float32 configs keep full logits."""
        if self.loss_chunk_size is not None:
            return self.loss_chunk_size or None
        if (
            self.activation_dtype == "bfloat16"
            and self.context_length > self.AUTO_LOSS_CHUNK
        ):
            return self.AUTO_LOSS_CHUNK
        return None

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError(
                f"d_model={self.d_model} not divisible by num_heads={self.num_heads}"
            )
        if self.num_kv_heads is not None and (
            self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads
        ):
            raise ValueError(
                f"num_kv_heads={self.num_kv_heads} must divide "
                f"num_heads={self.num_heads}"
            )
        if self.ffn_type == "moe" and self.n_experts < 1:
            raise ValueError(
                'ffn_type="moe" requires n_experts >= 1 (got '
                f"{self.n_experts}); set n_experts in the model config"
            )
        if self.moe_dispatch not in ("einsum", "gather"):
            raise ValueError(
                f'moe_dispatch={self.moe_dispatch!r} must be "einsum" or "gather"'
            )
        if self.decode_attention_impl not in ("xla", "pallas", "paged"):
            raise ValueError(
                f"decode_attention_impl={self.decode_attention_impl!r} "
                'must be "xla", "pallas" or "paged"'
            )
        if self.ffn_type == "moe" and not (
            1 <= self.router_top_k <= self.n_experts
        ):
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]"
            )
        if self.remat_policy not in (
            "none", "full", "dots_saveable", "save_attn"
        ):
            raise ValueError(
                f"remat_policy={self.remat_policy!r} must be one of "
                '"none", "full", "dots_saveable", "save_attn"'
            )
        if self.remat and self.remat_policy not in ("none", "full"):
            raise ValueError(
                f"remat=True (deprecated alias for remat_policy=\"full\") "
                f"contradicts remat_policy={self.remat_policy!r}; drop the "
                "bool and set only remat_policy"
            )
        if self.loss_chunk_size is not None and self.loss_chunk_size < 0:
            raise ValueError(
                f"loss_chunk_size={self.loss_chunk_size} must be None "
                "(auto), 0 (full logits), or a positive chunk"
            )

    @classmethod
    def from_dict(cls, raw: dict) -> "ModelConfig":
        """Build from a plain dict, ignoring unknown keys (reference JSON
        schema compatibility; also the checkpoint-stored config)."""
        known = {f.name for f in dataclasses.fields(cls)}
        coerced = {k: v for k, v in raw.items() if k in known}
        # json round-trips tuples as lists; frozen dataclasses need hashables.
        for k, v in coerced.items():
            if isinstance(v, list):
                coerced[k] = tuple(v)
        return cls(**coerced)

    @classmethod
    def from_json(cls, path: str | Path) -> "ModelConfig":
        with open(path) as f:
            raw: dict[str, Any] = json.load(f)
        return cls.from_dict(raw)

    def to_json(self, path: str | Path) -> None:
        payload = dataclasses.asdict(self)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)


#: The reference test fixture architecture (model_config.json).
TS_TEST_CONFIG = ModelConfig(
    vocab_size=10_000,
    context_length=16,
    d_model=64,
    num_layers=3,
    num_heads=4,
    d_ff=128,
    rope_theta=10000.0,
)

#: BASELINE.json config 1: TinyStories 4L/256d single-chip model.
TINYSTORIES_4L = ModelConfig(
    vocab_size=10_000,
    context_length=256,
    d_model=256,
    num_layers=4,
    num_heads=8,
    d_ff=683,
    rope_theta=10000.0,
)

#: BASELINE.json config 2: TinyStories 12L/512d data-parallel model.
TINYSTORIES_12L = ModelConfig(
    vocab_size=10_000,
    context_length=512,
    d_model=512,
    num_layers=12,
    num_heads=8,
    d_ff=1365,
    rope_theta=10000.0,
)

#: BASELINE.json config 3: GPT-2-small-class model with 32k vocab.
GPT2_SMALL_32K = ModelConfig(
    vocab_size=32_000,
    context_length=1024,
    d_model=768,
    num_layers=12,
    num_heads=12,
    d_ff=2048,
    rope_theta=10000.0,
    activation_dtype="bfloat16",
    loss_chunk_size=256,
)

#: Sparse counterpart of TINYSTORIES_12L: 8-expert top-2 MoE FFNs with the
#: same d_model/attention.  Both packages train it on one device or with the
#: expert stacks sharded over an ``expert`` mesh axis (the ``ep``
#: strategies; in the port one rank a card).
TINYSTORIES_MOE = ModelConfig(
    vocab_size=10_000,
    context_length=512,
    d_model=512,
    num_layers=12,
    num_heads=8,
    d_ff=1365,
    rope_theta=10000.0,
    ffn_type="moe",
    n_experts=8,
    router_top_k=2,
    capacity_factor=1.25,
    # The JAX package chose "gather" on a TPU, where the dense dispatch and
    # combine einsums cost more than the expert FFN itself at this shape.  It
    # stays as the model's definition; chip_smoke.py phase 16 times both
    # dispatches on the card (PERF.md).  Identical routing; einsum stays
    # selectable.
    moe_dispatch="gather",
)

#: BASELINE.json config 5: GPT-2-medium-class model (FSDP target).
GPT2_MEDIUM = ModelConfig(
    vocab_size=32_000,
    context_length=1024,
    d_model=1024,
    num_layers=24,
    num_heads=16,
    d_ff=2731,
    rope_theta=10000.0,
    activation_dtype="bfloat16",
    # Selective recompute (PR 13): strictly less recompute than the old
    # remat=True at a peak-HBM point that still fits the FSDP target.
    remat_policy="save_attn",
    loss_chunk_size=256,
)
