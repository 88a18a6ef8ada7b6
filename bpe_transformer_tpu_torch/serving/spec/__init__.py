"""Speculative decoding on the paged engine (port of
``bpe_transformer_tpu/serving/spec``): draft propose, one batched target
verify, rejection sampling and KV rewind.

- ``draft``: :class:`DraftSpec` (a tiny geometry or a truncated view of the
  target), :class:`DraftModel`, and the draft's propose and prefill passes;
- ``engine``: :class:`SpecEngine`, the paged engine whose tick emits 1..K+1
  tokens per slot, and the verify tail :func:`spec_verify_tail`.
"""

from bpe_transformer_tpu_torch.serving.spec.draft import DraftModel, DraftSpec
from bpe_transformer_tpu_torch.serving.spec.engine import SpecEngine, spec_verify_tail

__all__ = ["DraftModel", "DraftSpec", "SpecEngine", "spec_verify_tail"]
