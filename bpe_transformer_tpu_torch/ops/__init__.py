"""Tensor ops of the port (counterparts of ``bpe_transformer_tpu/ops``)."""

from bpe_transformer_tpu_torch.ops.core import (
    causal_mask,
    embedding,
    linear,
    merge_heads,
    multihead_self_attention,
    rmsnorm,
    scaled_dot_product_attention,
    silu,
    softmax,
    split_heads,
    swiglu,
)
from bpe_transformer_tpu_torch.ops.grad import clip_by_global_norm, global_norm
from bpe_transformer_tpu_torch.ops.losses import cross_entropy
from bpe_transformer_tpu_torch.ops.quant import is_quantized, quantize_params, quantize_weight
# Binds ``rope`` to the function, as in the JAX package; the module stays
# ``sys.modules["bpe_transformer_tpu_torch.ops.rope"]``.
from bpe_transformer_tpu_torch.ops.rope import apply_rope, rope, rope_tables

__all__ = [
    "apply_rope",
    "causal_mask",
    "clip_by_global_norm",
    "cross_entropy",
    "embedding",
    "global_norm",
    "is_quantized",
    "linear",
    "quantize_params",
    "quantize_weight",
    "merge_heads",
    "multihead_self_attention",
    "rmsnorm",
    "rope",
    "rope_tables",
    "scaled_dot_product_attention",
    "silu",
    "softmax",
    "split_heads",
    "swiglu",
]
