"""Device-side health stats of a train step (the port of
``bpe_transformer_tpu/telemetry/health.py``).

Every stat is a 0-d tensor on the step's device, appended to the step's
``metrics``: nothing here reads a value back, so an opt-in health-enabled
step adds reductions on the card and no host sync; the values ride the
loop's existing once-per-``log_every`` read.

- non-finite detection: a 0/1 flag for the loss plus element counts over the
  gradient and (post-update) parameter trees;
- per-layer-group grad/param L2 norms: leaves bucketed into ``embed`` /
  ``attn`` / ``ffn`` / ``norm`` / ``head`` groups by their key path.

The JAX package also exports MoE's ``moe_aux`` here; the port's MoE comes
with the multi-GPU slice.  Host-side, :func:`flatten_health` turns the
fetched values into the flat JSONL keys (``grad_norm/attn``,
``nonfinite_grads``).
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.tree import path_str, tree_flatten_with_path, tree_leaves

#: Substring -> group, checked in order against the leaf's key path (the
#: first match wins; "ln" comes after the more specific names).
_GROUP_PATTERNS: tuple[tuple[str, str], ...] = (
    ("attn", "attn"),
    ("ffn", "ffn"),
    ("token_embeddings", "embed"),
    ("lm_head", "head"),
    ("ln", "norm"),
)


def group_of(key_path: str) -> str:
    """Layer-group bucket for a param-tree key path string."""
    for pattern, group in _GROUP_PATTERNS:
        if pattern in key_path:
            return group
    return "other"


def leaf_norms(leaves) -> list[torch.Tensor]:
    """The float32 L2 norm of each tensor: one multi-tensor reduction on the
    card (``torch._foreach_norm``), not a launch a leaf."""
    return list(torch._foreach_norm([leaf.detach().float() for leaf in leaves]))


def grouped_norm(norms: list, index: list[int]) -> torch.Tensor:
    """The L2 norm of the tensors ``index`` picks, from their norms."""
    return torch.linalg.vector_norm(torch.stack([norms[i] for i in index]))


def leaf_nonfinite(leaves) -> torch.Tensor:
    """The non-finite element count of each tensor, stacked (int64): a mask
    and a sum a leaf, so the only temporary is one leaf's bool mask, never
    a copy of the tree."""
    return torch.stack([torch.sum(~torch.isfinite(leaf.detach())) for leaf in leaves])


def group_norms(tree) -> dict:
    """Per-layer-group L2 norms of a tree, ``{group: float32 0-d tensor}``."""
    pairs = tree_flatten_with_path(tree)
    norms = leaf_norms([leaf for _, leaf in pairs])
    groups: dict = {}
    for i, (path, _) in enumerate(pairs):
        groups.setdefault(group_of(path_str(path)), []).append(i)
    return {group: grouped_norm(norms, index) for group, index in sorted(groups.items())}


def nonfinite_count(tree) -> torch.Tensor:
    """Total count of non-finite elements over every leaf (int32 0-d)."""
    return torch.sum(leaf_nonfinite(tree_leaves(tree))).to(torch.int32)


def health_metrics(loss, grads, params) -> dict:
    """The health sub-dict of a train step's metrics.  ``params`` should be
    the post-update tree, so optimizer-produced non-finites are caught the
    step they appear."""
    return {
        "nonfinite_loss": (~torch.isfinite(loss.detach())).to(torch.int32),
        "nonfinite_grads": nonfinite_count(grads),
        "nonfinite_params": nonfinite_count(params),
        "grad_norms": group_norms(grads),
        "param_norms": group_norms(params),
    }


def flatten_health(health: dict) -> dict:
    """Host-side: fetched health metrics -> flat JSONL keys
    (``{"grad_norms": {"attn": x}}`` becomes ``{"grad_norm/attn": x}``);
    counts become ints, norms floats."""
    flat: dict = {}
    for key in ("nonfinite_loss", "nonfinite_grads", "nonfinite_params"):
        if key in health:
            flat[key] = int(health[key])
    for src, prefix in (("grad_norms", "grad_norm"), ("param_norms", "param_norm")):
        for group, value in health.get(src, {}).items():
            flat[f"{prefix}/{group}"] = float(value)
    if "moe_aux" in health:
        flat["moe_aux"] = float(health["moe_aux"])
    return flat
