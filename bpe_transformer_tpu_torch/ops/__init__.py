"""Tensor ops of the port (counterparts of ``bpe_transformer_tpu/ops``)."""
