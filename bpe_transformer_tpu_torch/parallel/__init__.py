"""Sequence parallelism (counterpart of ``bpe_transformer_tpu/parallel``'s
ring schedules and sp train step), over a ring transport
(:mod:`parallel.mesh`): :class:`StackedRing` on one device today."""

from bpe_transformer_tpu_torch.parallel.mesh import RingTransport, StackedRing
from bpe_transformer_tpu_torch.parallel.ring_attention import (
    ring_flash_attention,
    ring_self_attention,
    zigzag_indices,
    zigzag_inverse_indices,
    zigzag_positions,
    zigzag_ring_flash_attention,
    zigzag_ring_self_attention,
)
from bpe_transformer_tpu_torch.parallel.sp import (
    make_sp_grad_fn,
    make_sp_train_step,
    shard_sp_batch,
    sp_forward,
)

__all__ = [
    "RingTransport",
    "StackedRing",
    "make_sp_grad_fn",
    "make_sp_train_step",
    "ring_flash_attention",
    "ring_self_attention",
    "shard_sp_batch",
    "sp_forward",
    "zigzag_indices",
    "zigzag_inverse_indices",
    "zigzag_positions",
    "zigzag_ring_flash_attention",
    "zigzag_ring_self_attention",
]
