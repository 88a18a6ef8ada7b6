"""Training (counterparts of ``bpe_transformer_tpu/training``): the train
and eval steps (``train_step``), the loop on one card or across cards
(``loop``), sampling (``sampling``) and the ``train`` CLI (``cli``)."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

__all__ = [
    "LoopConfig",
    "TrainHParams",
    "generate_ids",
    "generate_text",
    "make_eval_step",
    "make_loss_fn",
    "make_train_step",
    "train",
]

# Lazy: the CLI module imports without torch.
__getattr__ = lazy_attrs(__name__, {
    "LoopConfig": "loop",
    "TrainHParams": "train_step",
    "generate_ids": "sampling",
    "generate_text": "sampling",
    "make_eval_step": "train_step",
    "make_loss_fn": "train_step",
    "make_train_step": "train_step",
    "train": "loop",
})
