"""Single-file checkpoints (counterpart of ``bpe_transformer_tpu/checkpointing``)."""

from bpe_transformer_tpu_torch.checkpointing.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    training_state,
)

__all__ = ["load_checkpoint", "save_checkpoint", "training_state"]
