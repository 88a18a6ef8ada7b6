"""Training losses (port of ``bpe_transformer_tpu/ops/losses.py``): mean
cross-entropy with a float32 logsumexp, and the sequence-chunked LM loss
that never materializes the full ``(batch, seq, vocab)`` logits."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bpe_transformer_tpu_torch.ops.core import head_logits


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets (...)`` under ``logits
    (..., vocab)``, in float32 (stable at any logit scale)."""
    logits32 = logits.float()
    target_logit = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    return (torch.logsumexp(logits32, dim=-1) - target_logit).mean()


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL of float32 ``logits (..., vocab)``."""
    target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - target_logit


def _chunk_nll(hc, head_w, tc, nll=token_nll):
    return nll(head_logits(hc, head_w), tc).sum()


def chunked_lm_cross_entropy(
    hidden: torch.Tensor,
    lm_head_w: torch.Tensor,
    targets: torch.Tensor,
    chunk_size: int,
    nll=token_nll,
) -> torch.Tensor:
    """Mean LM cross-entropy of ``hidden (batch, seq, d)`` under
    ``lm_head_w (vocab, d)`` without the full logits: each ``chunk_size``
    slice of the sequence projects to the vocab and reduces to its NLL
    under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``),
    so its ``(batch, chunk, vocab)`` logits are recomputed on the backward
    instead of kept.  ``nll(logits, targets)`` gives the per-token NLL (the
    vocab-parallel one of ``parallel/gspmd.py`` under tensor parallelism)."""
    batch, seq, _ = hidden.shape
    if seq % chunk_size:
        raise ValueError(f"seq {seq} not divisible by loss chunk_size {chunk_size}")
    total = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, seq, chunk_size):
        hc = hidden[:, start : start + chunk_size]
        tc = targets[:, start : start + chunk_size]
        total = total + checkpoint(_chunk_nll, hc, lm_head_w, tc, nll, use_reentrant=False)
    return total / (batch * seq)


def lm_loss(
    hidden: torch.Tensor,
    lm_head_w: torch.Tensor,
    targets: torch.Tensor,
    chunk_size: int | None,
    nll=None,
) -> torch.Tensor:
    """LM cross-entropy from final hidden states: ``chunk_size`` is clamped
    to the sequence, and the full logits are used when it does not divide
    the sequence (or is None).  ``nll``: see :func:`chunked_lm_cross_entropy`."""
    seq = hidden.shape[-2]
    chunk = min(chunk_size, seq) if chunk_size else None
    if chunk and seq % chunk == 0:
        return chunked_lm_cross_entropy(hidden, lm_head_w, targets, chunk, nll or token_nll)
    if nll is not None:
        return nll(head_logits(hidden, lm_head_w), targets).mean()
    return cross_entropy(head_logits(hidden, lm_head_w), targets)
