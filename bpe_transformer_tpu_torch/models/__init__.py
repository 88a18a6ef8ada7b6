"""Model configuration, parameters, the forward and KV-cached decoding
(counterparts of ``bpe_transformer_tpu/models``)."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs
from bpe_transformer_tpu_torch.models.config import (
    GPT2_MEDIUM,
    GPT2_SMALL_32K,
    TINYSTORIES_4L,
    TINYSTORIES_12L,
    TINYSTORIES_MOE,
    TS_TEST_CONFIG,
    ModelConfig,
)

__all__ = [
    "GPT2_MEDIUM",
    "GPT2_SMALL_32K",
    "ModelConfig",
    "TINYSTORIES_4L",
    "TINYSTORIES_12L",
    "TINYSTORIES_MOE",
    "TS_TEST_CONFIG",
    "forward",
    "init_params",
    "params_from_state_dict",
    "state_dict_from_params",
    "transformer_block",
]

# Lazy: the configs import without torch (the CLI reads them on hosts
# without it); the model imports torch.
__getattr__ = lazy_attrs(__name__, {
    name: "transformer"
    for name in ("forward", "init_params", "params_from_state_dict",
                 "state_dict_from_params", "transformer_block")
})
