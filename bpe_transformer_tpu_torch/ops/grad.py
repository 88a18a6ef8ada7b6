"""Gradient utilities (port of ``bpe_transformer_tpu/ops/grad.py``):
global-norm clipping over a parameter tree, with the eps of
``torch.nn.utils.clip_grad_norm_`` in the denominator."""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every tensor of ``tree``, accumulated in float32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def clip_by_global_norm(grads, max_norm: float, eps: float = 1e-6):
    """Scale ``grads`` so their combined L2 norm is at most ``max_norm``;
    returns ``(clipped_grads, pre_clip_norm)``.  The factor
    ``max_norm / (norm + eps)`` applies only when the norm exceeds the
    budget."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + eps), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm
