"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (see ``_build.py`` for the build).

The package exports the JAX package's ``kernels/pallas`` names.  Where a
function shares its module's name (``decode_attention``,
``flash_attention``, ``gelu``, ``quant_matmul``) the package attribute is
the function, as in the JAX package; the module is
``importlib.import_module("bpe_transformer_tpu_torch.kernels.<name>")``.
``flash_attention_with_rope`` is :func:`flash_attention.flash_attention_rope`
and ``gelu_reference`` :func:`gelu.gelu_plain`."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs
from bpe_transformer_tpu_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
)
from bpe_transformer_tpu_torch.kernels.flash_attention import flash_attention
from bpe_transformer_tpu_torch.kernels.flash_attention import (
    flash_attention_rope as flash_attention_with_rope,
)
from bpe_transformer_tpu_torch.kernels.gelu import gelu
from bpe_transformer_tpu_torch.kernels.gelu import gelu_plain as gelu_reference
from bpe_transformer_tpu_torch.kernels.quant_matmul import quant_matmul

__all__ = [
    "decode_attention",
    "paged_decode_attention",
    "flash_attention",
    "flash_attention_with_rope",
    "fused_head_sample",
    "fused_verify_head",
    "gelu",
    "gelu_reference",
    "quant_matmul",
]

# Lazy: ``sample`` imports the serving engine's sampling chain, which
# imports the model.
__getattr__ = lazy_attrs(__name__, {
    "fused_head_sample": "sample",
    "fused_verify_head": "sample",
})
