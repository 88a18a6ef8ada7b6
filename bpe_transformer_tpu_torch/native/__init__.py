"""The native (C++) host tokenization engine of the port: the GPT-2
pre-tokenization scanner, the pre-token counter, the BPE merge loop and the
fused encoder behind a ctypes C ABI, with the pure-Python path as the
fallback on a host without a compiler."""

from bpe_transformer_tpu_torch.native.engine import (
    NativeBPEEncoder,
    NativePretokenCounter,
    is_available,
    pretokenize_offsets,
    train_bpe_merges,
    unavailable_reason,
)

__all__ = [
    "NativeBPEEncoder",
    "NativePretokenCounter",
    "is_available",
    "pretokenize_offsets",
    "train_bpe_merges",
    "unavailable_reason",
]
