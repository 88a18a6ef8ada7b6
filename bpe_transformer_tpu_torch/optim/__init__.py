"""Optimizer and learning-rate schedule (counterparts of
``bpe_transformer_tpu/optim``)."""

from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]
