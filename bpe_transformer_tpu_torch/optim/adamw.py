"""AdamW (port of ``bpe_transformer_tpu/optim/adamw.py``): torch's decoupled
ordering, weight decay multiplying the parameter before the Adam step is
subtracted, float32 moments whatever the parameter dtype.

The state mirrors the parameter tree (first and second moments) plus the
step count.  ``step`` is a 0-d int32 tensor kept on the host: the schedule
and the bias correction read it every step, and reading a host tensor
never waits for the card.  The moments live beside the parameters.

The update runs in ``kernels/adamw.py``: on CUDA tensors the multi-tensor
kernel of ``csrc/adamw.cu``, every leaf in one launch (with the clip,
:func:`clip_adamw_update`, two); on CPU tensors the plain per-leaf loop.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from bpe_transformer_tpu_torch.kernels import adamw as kernel
from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the host
    m: Any  # first moment, the parameter tree's structure
    v: Any  # second moment


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr: float,
    *,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    delta_norms: list | None = None,
):
    """One AdamW step; returns ``(params, new_state)``.

    Bias correction uses ``step + 1``.  The parameters and moments are
    updated in place (the JAX package donates their buffers to the same
    effect) and returned in the same trees.  ``delta_norms``, a list,
    receives each leaf's float32 ``||new - old||`` (0-d tensors, in
    tree-leaf order), taken before the new values are written: the update
    norm that the dynamics tap reads without a copy of the old weights.
    """
    step = int(state.step) + 1
    kernel.adamw(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        step=step, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
        delta_norms=delta_norms,
    )
    return params, AdamWState(
        step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v
    )


@torch.no_grad()
def clip_adamw_update(
    params,
    grads,
    state: AdamWState,
    lr: float,
    *,
    max_norm: float,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    delta_norms: list | None = None,
):
    """``ops.grad.clip_by_global_norm(grads, max_norm)`` then
    :func:`adamw_update` on the clipped gradients, in one pass; returns
    ``(params, new_state, pre_clip_norm)``.  ``grads`` is read, never
    written; the clipped gradients are never built (``ops.grad.scale_grads``
    builds them from the norm).  Marks ``bpt.clip`` and ``bpt.adamw``."""
    step = int(state.step) + 1
    grad_norm = kernel.clip_adamw(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        step=step, lr=lr, max_norm=max_norm, betas=betas, eps=eps,
        weight_decay=weight_decay, delta_norms=delta_norms,
    )
    return params, AdamWState(
        step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v
    ), grad_norm
