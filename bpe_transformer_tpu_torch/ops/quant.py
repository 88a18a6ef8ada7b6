"""Per-channel int8 weight quantization for the serving path (port of
``bpe_transformer_tpu/ops/quant.py``).

A quantized weight is a plain dict ``{"q": int8 (d_out, d_in), "scale":
float32 (d_out,)}`` with ``W[o, i] ~= q[o, i] * scale[o]``, ``scale =
amax_i |W[o, :]| / 127``.  :func:`ops.core.linear` and
:func:`ops.core.head_logits` dispatch on it to the int8 matmul kernel
(``kernels/quant_matmul.py``), which converts the int8 values in registers
and applies the scale once per output: the serving programs (decode tick,
chunk prefill) run quantized without a second code path, and training never
builds such a dict.

Quantized: the attention projections, the dense FFN matrices (all of
``w1``/``w2``/``w3``, also the ``w3`` that a two-matrix FFN never reads, as
the JAX package does) and the LM head.  Not quantized: token embeddings (a
row gather, not a matmul), norm gains, and MoE expert stacks (refused).
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.tree import tree_leaves

__all__ = [
    "dequantize",
    "is_quantized",
    "quant_linear",
    "quantize_params",
    "quantize_weight",
    "tree_bytes",
]

_QKEYS = frozenset({"q", "scale"})


def is_quantized(w) -> bool:
    """True for a quantized-weight dict (a structural check)."""
    return isinstance(w, dict) and _QKEYS.issubset(w.keys())


def quantize_weight(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 quantization of a ``(d_out, d_in)``
    weight: ``scale[o] = max_i |w[o, i]| / 127`` (float32), ``q =
    round(w / scale)`` (half to even) clipped to ``[-127, 127]``.  An
    all-zero row keeps scale 0 and dequantizes to exact zeros."""
    if w.ndim != 2:
        raise ValueError(
            f"quantize_weight expects a 2D (d_out, d_in) matrix, got {tuple(w.shape)}"
        )
    w32 = w.float()
    scale = w32.abs().amax(dim=1) / 127.0
    safe = scale.clamp(min=1e-30)
    q = torch.round(w32 / safe[:, None]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize(w: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The approximate weight (tests and references only; the serving path
    never builds it)."""
    return (w["q"].float() * w["scale"][:, None]).to(dtype)


def quant_linear(x: torch.Tensor, w: dict, *, preserve_f32: bool = False) -> torch.Tensor:
    """``y = x @ (q * scale).T`` through the int8 matmul kernel (its plain
    version for CPU tensors), cast back to ``x``'s dtype unless
    ``preserve_f32`` (the ``head_logits`` contract: float32 logits)."""
    from bpe_transformer_tpu_torch.kernels.quant_matmul import quant_matmul

    out = quant_matmul(x, w["q"], w["scale"])
    return out if preserve_f32 else out.to(x.dtype)


def quantize_params(params: dict, config: ModelConfig) -> dict:
    """The serving tree with its matmul weights quantized: attention
    projections, dense FFN matrices and the ``lm_head`` leaf when present;
    embeddings and norm gains pass through.  Raises for MoE configs."""
    if config.ffn_type == "moe":
        raise ValueError(
            'weight_dtype="int8" does not cover MoE expert stacks; '
            "serve MoE configs at the activation width"
        )
    out = {
        "token_embeddings": params["token_embeddings"],
        "ln_final": params["ln_final"],
        "layers": [
            {
                "attn": {name: quantize_weight(w) for name, w in layer["attn"].items()},
                "ln1": layer["ln1"],
                "ln2": layer["ln2"],
                "ffn": {name: quantize_weight(w) for name, w in layer["ffn"].items()},
            }
            for layer in params["layers"]
        ],
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def tree_bytes(tree) -> int:
    """Resident bytes of every tensor leaf (quantized dicts count their int8
    values and float32 scales)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
