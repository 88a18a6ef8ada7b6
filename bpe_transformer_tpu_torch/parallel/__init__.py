"""Parallel training (counterpart of ``bpe_transformer_tpu/parallel``): the
ring schedules and the sp train step over a ring transport (a
:class:`StackedRing` on one device, or a :class:`ProcessGroupRing`, one rank
a card), the process-group mesh (:func:`make_mesh`,
:func:`initialize_distributed`), the data-parallel step with ZeRO-1
(:func:`make_dp_train_step`), the GSPMD strategies' specs and step
(:func:`param_specs`, :func:`zero1_opt_specs`, :func:`shard_params`,
:func:`make_gspmd_train_step`), the hybrid mesh over hosts
(:func:`make_hybrid_mesh`), and :func:`launch`, which starts a world of
rank processes; Ulysses sequence parallelism (:func:`ulysses_attention`,
``make_sp_train_step(ulysses=True)``), the GPipe pipeline
(:func:`make_pp_train_step` over :func:`stack_pipeline_params`), expert
parallelism (the ``ep`` strategies of :func:`make_gspmd_train_step`), and
:func:`make_ring_attention`, ring attention over whole ``(B, H, S, D)``
tensors for callers outside a step."""

from bpe_transformer_tpu_torch.parallel.launch import launch
from bpe_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    MeshAxis,
    ProcessGroupRing,
    RingTransport,
    StackedRing,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
)
from bpe_transformer_tpu_torch.parallel.pp import (
    PipelineLayout,
    init_pp_opt_state,
    make_pp_grad_fn,
    make_pp_train_step,
    shard_pp_params,
    stack_pipeline_params,
    unstack_pipeline_params,
)
from bpe_transformer_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    ring_flash_attention,
    ring_self_attention,
    zigzag_indices,
    zigzag_inverse_indices,
    zigzag_positions,
    zigzag_ring_flash_attention,
    zigzag_ring_self_attention,
)
from bpe_transformer_tpu_torch.parallel.sharding import (
    FSDP_MIN_SIZE,
    gather_params,
    param_specs,
    shard_params,
    zero1_opt_specs,
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
from bpe_transformer_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "FSDP_MIN_SIZE",
    "Mesh",
    "MeshAxis",
    "PipelineLayout",
    "ProcessGroupRing",
    "RingTransport",
    "StackedRing",
    "initialize_distributed",
    "gather_params",
    "init_pp_opt_state",
    "launch",
    "make_dp_train_step",
    "make_gspmd_train_step",
    "make_hybrid_mesh",
    "make_mesh",
    "make_pp_grad_fn",
    "make_pp_train_step",
    "make_ring_attention",
    "make_sp_grad_fn",
    "make_sp_train_step",
    "param_specs",
    "ring_flash_attention",
    "ring_self_attention",
    "shard_batch",
    "shard_params",
    "shard_pp_params",
    "shard_sp_batch",
    "sp_forward",
    "stack_pipeline_params",
    "ulysses_attention",
    "unstack_pipeline_params",
    "zigzag_indices",
    "zigzag_inverse_indices",
    "zigzag_positions",
    "zigzag_ring_flash_attention",
    "zigzag_ring_self_attention",
    "zero1_opt_specs",
]
