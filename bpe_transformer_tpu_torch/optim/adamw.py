"""AdamW (port of ``bpe_transformer_tpu/optim/adamw.py``): torch's decoupled
ordering, weight decay multiplying the parameter before the Adam step is
subtracted, float32 moments whatever the parameter dtype.

The state mirrors the parameter tree (first and second moments) plus the
step count.  ``step`` is a 0-d int32 tensor kept on the host: the schedule
and the bias correction read it every step, and reading a host tensor
never waits for the card.  The moments live beside the parameters.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

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
    b1, b2 = betas
    step = int(state.step) + 1
    bias1 = 1.0 - b1**step
    bias2 = 1.0 - b2**step
    for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v)
    ):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        update = (m / bias1) / (torch.sqrt(v / bias2) + eps)
        new = (p.float() * (1.0 - lr * weight_decay) - lr * update).to(p.dtype)
        if delta_norms is not None:
            delta_norms.append(torch.dist(new.float(), p.float()))
        p.copy_(new)
    return params, AdamWState(
        step=torch.tensor(step, dtype=torch.int32), m=state.m, v=state.v
    )
