"""Gradient utilities (port of ``bpe_transformer_tpu/ops/grad.py``):
global-norm clipping over a parameter tree, with the eps of
``torch.nn.utils.clip_grad_norm_`` in the denominator.

On CUDA tensors the norm is the sum-of-squares kernel of ``csrc/adamw.cu``
(``kernels/adamw.py``: every leaf in one launch, then one for the root); on
CPU tensors the plain per-leaf sum.  The training step does not build the
clipped tree: ``optim.adamw.clip_adamw_update`` scales each gradient inside
the AdamW kernel."""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import adamw as kernel
from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every tensor of ``tree``, accumulated in float32."""
    return kernel.global_norm(tree_leaves(tree))


def scale_grads(grads, norm: torch.Tensor, max_norm: float, eps: float = 1e-6):
    """``grads`` clipped by their pre-clip global ``norm``: each times
    ``min(1, max_norm / (norm + eps))``, rounded back to its dtype."""
    scale = kernel.clip_scale(norm, max_norm, eps)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm: float, eps: float = 1e-6):
    """Scale ``grads`` so their combined L2 norm is at most ``max_norm``;
    returns ``(clipped_grads, pre_clip_norm)``.  The factor
    ``max_norm / (norm + eps)`` applies only when the norm exceeds the
    budget."""
    norm = global_norm(grads)
    return scale_grads(grads, norm, max_norm, eps), norm
