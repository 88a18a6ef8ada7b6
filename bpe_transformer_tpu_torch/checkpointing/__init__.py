"""Checkpoints (counterpart of ``bpe_transformer_tpu/checkpointing``): single
files and the sharded v2 directories, with the async writer and the
fallback to the newest valid snapshot."""

from bpe_transformer_tpu_torch.checkpointing.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptionError,
    load_checkpoint,
    load_checkpoint_sharded,
    load_checkpoint_with_fallback,
    save_checkpoint,
    save_checkpoint_sharded,
    training_state,
)

__all__ = [
    "AsyncCheckpointer",
    "CheckpointCorruptionError",
    "load_checkpoint",
    "load_checkpoint_sharded",
    "load_checkpoint_with_fallback",
    "save_checkpoint",
    "save_checkpoint_sharded",
    "training_state",
]
