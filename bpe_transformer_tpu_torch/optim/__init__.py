"""Optimizer and learning-rate schedule (counterparts of
``bpe_transformer_tpu/optim``)."""

from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
from bpe_transformer_tpu_torch.optim.sharded import (
    ShardedAdamWState,
    gather_opt_state,
    opt_state_from_jax,
    restore_opt_state,
    shard_opt_state,
    sharded_adamw_init,
    sharded_adamw_update,
    unshard_opt_state,
)

__all__ = [
    "AdamWState",
    "ShardedAdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "gather_opt_state",
    "opt_state_from_jax",
    "restore_opt_state",
    "shard_opt_state",
    "sharded_adamw_init",
    "sharded_adamw_update",
    "unshard_opt_state",
]
