"""Parallel training (counterpart of ``bpe_transformer_tpu/parallel``): the
ring schedules and the sp train step over a ring transport (a
:class:`StackedRing` on one device, or a :class:`ProcessGroupRing`, one rank
a card), the process-group mesh (:func:`make_mesh`,
:func:`initialize_distributed`), the data-parallel step with ZeRO-1
(:func:`make_dp_train_step`), and :func:`launch`, which starts a world of
rank processes.  FSDP/tp, Ulysses and the GPipe pipeline come with slice
10c."""

from bpe_transformer_tpu_torch.parallel.launch import launch
from bpe_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    MeshAxis,
    ProcessGroupRing,
    RingTransport,
    StackedRing,
    initialize_distributed,
    make_mesh,
)
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
from bpe_transformer_tpu_torch.parallel.train_step import (
    make_dp_train_step,
    make_gspmd_train_step,
    shard_batch,
)

__all__ = [
    "Mesh",
    "MeshAxis",
    "ProcessGroupRing",
    "RingTransport",
    "StackedRing",
    "initialize_distributed",
    "launch",
    "make_dp_train_step",
    "make_gspmd_train_step",
    "make_mesh",
    "make_sp_grad_fn",
    "make_sp_train_step",
    "ring_flash_attention",
    "ring_self_attention",
    "shard_batch",
    "shard_sp_batch",
    "sp_forward",
    "zigzag_indices",
    "zigzag_inverse_indices",
    "zigzag_positions",
    "zigzag_ring_flash_attention",
    "zigzag_ring_self_attention",
]
