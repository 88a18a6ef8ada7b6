"""Resilience (the port's counterparts of ``bpe_transformer_tpu/resilience``):
checkpoint integrity (``integrity``), deterministic fault injection
(``faults``) and the exit descriptions of the supervisor (``supervisor``)."""
