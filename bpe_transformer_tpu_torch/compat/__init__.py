"""The reference adapter surface of the port: the 21 torch-in, torch-out
functions of the reference suite's ``tests/adapters.py`` (the port's
counterpart of ``bpe_transformer_tpu/compat``).

The names resolve lazily (PEP 562), as in the JAX package, so importing
this package costs nothing until an adapter is asked for.  The JAX
package's ``compat/shardmap.py`` (an alias that puts ``shard_map`` onto
old ``jax`` versions) has no counterpart: there is no ``jax`` here.
"""

_ADAPTER_NAMES = (
    "get_adamw_cls",
    "get_tokenizer",
    "run_cross_entropy",
    "run_embedding",
    "run_get_batch",
    "run_get_lr_cosine_schedule",
    "run_gradient_clipping",
    "run_linear",
    "run_load_checkpoint",
    "run_multihead_self_attention",
    "run_multihead_self_attention_with_rope",
    "run_rmsnorm",
    "run_rope",
    "run_save_checkpoint",
    "run_scaled_dot_product_attention",
    "run_silu",
    "run_softmax",
    "run_swiglu",
    "run_train_bpe",
    "run_transformer_block",
    "run_transformer_lm",
)


def __getattr__(name: str):
    if name in _ADAPTER_NAMES:
        import importlib

        module = importlib.import_module("bpe_transformer_tpu_torch.compat.adapters")
        value = getattr(module, name)
        globals()[name] = value  # resolve once per process
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_ADAPTER_NAMES)
