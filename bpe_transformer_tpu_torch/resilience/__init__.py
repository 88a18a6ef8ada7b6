"""Checkpoint integrity (the port's own copy of the checksum parts of
``bpe_transformer_tpu/resilience``)."""
