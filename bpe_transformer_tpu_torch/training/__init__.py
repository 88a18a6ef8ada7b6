"""Single-device training: the train step, the loop and the ``train`` CLI
(counterparts of ``bpe_transformer_tpu/training``)."""
