"""Model configuration, parameters and KV-cached decoding (counterparts of
``bpe_transformer_tpu/models``)."""

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
]
