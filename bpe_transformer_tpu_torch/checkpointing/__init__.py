"""Single-file checkpoints (counterpart of ``bpe_transformer_tpu/checkpointing``)."""

from bpe_transformer_tpu_torch.checkpointing.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptionError,
    load_checkpoint,
    load_checkpoint_with_fallback,
    save_checkpoint,
    training_state,
)

__all__ = [
    "AsyncCheckpointer",
    "CheckpointCorruptionError",
    "load_checkpoint",
    "load_checkpoint_with_fallback",
    "save_checkpoint",
    "training_state",
]
