"""Training-dynamics introspection inside the train step (the port of
``bpe_transformer_tpu/telemetry/dynamics.py``).

Per-layer resolution of what `telemetry.health` reports per layer group:

- **per-layer gradient and parameter L2 norms** — one scalar per
  transformer layer (``layers.N``) plus the embed/head/final-norm tensors;
- **update-to-param ratios** — ``||Δp|| / ||p||`` of the real AdamW update
  (post-clip, post-weight-decay, the parameter delta itself);
- **per-block activation statistics** (``models.transformer.
  forward_hidden_stats``) — RMS / absmax / non-finite count of every
  block's output plus the mean attention entropy per layer (sampled from
  batch element 0);
- **per-tensor non-finite counts** for NaN/Inf localization — counted on
  the step's INPUT params and on the gradients, giving a
  ``first_nonfinite`` tensor path (``params/layers.3.ffn.w1``).

The port's AdamW updates the parameters in place, so the step cannot hold
the input tree and the output tree at once without a second copy of the
weights.  It keeps none: the input params' non-finite counts are taken
before the update, and ``adamw_update(..., delta_norms=...)`` hands back
the norm of each leaf's delta, computed from the old and new values before
the new ones are written (:func:`dynamics_from_parts`).  Norms are one
multi-tensor reduction a tree; counts are a mask and a sum a leaf
(``telemetry/health.py``), whose only temporary is one leaf's mask.
:func:`dynamics_metrics` takes the two trees, as the JAX function does.

Every value is a tensor on the step's device and rides the loop's
once-per-``log_every`` read: no extra host sync.  Host-side,
:func:`flatten_dynamics` turns the fetched values into the flat keys of a
``kind="dynamics"`` record.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.telemetry.health import grouped_norm, leaf_nonfinite, leaf_norms
from bpe_transformer_tpu_torch.tree import path_str, tree_flatten_with_path, tree_leaves


def layer_label(path: str) -> str:
    """Per-layer bucket of a dotted tensor path: ``layers.N`` for block
    tensors, the top-level name (``token_embeddings``/``lm_head``/
    ``ln_final``) otherwise."""
    parts = path.split(".")
    if parts[0] == "layers" and len(parts) > 1:
        return f"layers.{parts[1]}"
    return parts[0]


def _per_layer(paths: list[str], norms: list) -> dict:
    """``{layer_label: float32 0-d}`` from per-leaf norms."""
    labels: dict = {}
    for i, path in enumerate(paths):
        labels.setdefault(layer_label(path), []).append(i)
    return {label: grouped_norm(norms, index) for label, index in sorted(labels.items())}


def tensor_paths(tree) -> list[str]:
    return [path_str(path) for path, _ in tree_flatten_with_path(tree)]


def per_layer_norms(tree, reduce=None) -> dict:
    """Per-layer L2 norms of a tree as ``{layer_label: float32 0-d}``
    (``reduce``: see ``telemetry.health.leaf_norms``)."""
    return _per_layer(tensor_paths(tree), leaf_norms(tree_leaves(tree), reduce))


def per_tensor_nonfinite(tree, reduce=None) -> dict:
    """Non-finite element count of every leaf, keyed by dotted tensor path
    (int32 0-d tensors)."""
    counts = leaf_nonfinite(tree_leaves(tree), reduce).to(torch.int32)
    return {path: counts[i] for i, path in enumerate(tensor_paths(tree))}


def dynamics_from_parts(grads, params_after, update_norms: list, nonfinite_params: dict,
                        act_stats=None, reduce_grads=None, reduce_params=None) -> dict:
    """The dynamics sub-dict from what the in-place step can keep:
    ``update_norms`` holds each leaf's float32 ``||new - old||`` (in
    tree-leaf order; whole-leaf norms) and ``nonfinite_params`` the input
    params' :func:`per_tensor_nonfinite`.  ``grads`` should be the pre-clip
    gradients.  ``reduce_grads`` and ``reduce_params``: see
    ``telemetry.health.health_metrics``."""
    paths = tensor_paths(params_after)
    param_norms = per_layer_norms(params_after, reduce_params)
    update = _per_layer(paths, update_norms)
    out = {
        "grad_norm": per_layer_norms(grads, reduce_grads),
        "param_norm": param_norms,
        "update_ratio": {
            label: update[label] / (param_norms[label] + 1e-12) for label in param_norms
        },
        "nonfinite_params": nonfinite_params,
        "nonfinite_grads": per_tensor_nonfinite(grads, reduce_grads),
    }
    if act_stats is not None:
        out["act"] = act_stats
    return out


def dynamics_metrics(grads, params_before, params_after, act_stats=None) -> dict:
    """The dynamics sub-dict from two parameter trees (the JAX function's
    signature).  Norms and the update ratio describe the post-update params;
    the non-finite localization counts ``params_before``."""
    update_norms = [
        torch.dist(a.detach().float(), b.detach().float())
        for a, b in zip(tree_leaves(params_after), tree_leaves(params_before))
    ]
    return dynamics_from_parts(grads, params_after, update_norms,
                               per_tensor_nonfinite(params_before), act_stats)


def flatten_dynamics(dyn: dict) -> dict:
    """Host-side: fetched dynamics values -> flat ``kind="dynamics"`` record
    keys.

    Norm/ratio scalars become ``grad_norm/layers.N`` etc.; activation
    arrays fan out per layer (``act_rms/layers.N``, ``attn_entropy/...``);
    non-finite counts appear only when nonzero, and the first offender
    (params, then activations, then grads) lands in ``first_nonfinite``.
    """
    flat: dict = {}
    for src in ("grad_norm", "param_norm", "update_ratio"):
        for label, value in dyn.get(src, {}).items():
            flat[f"{src}/{label}"] = float(value)
    act = dyn.get("act")
    act_first = None
    if act:
        for name, prefix in (
            ("rms", "act_rms"),
            ("absmax", "act_absmax"),
            ("attn_entropy", "attn_entropy"),
        ):
            for i, value in enumerate(act.get(name, ())):
                flat[f"{prefix}/layers.{i}"] = float(value)
        for i, count in enumerate(act.get("nonfinite", ())):
            if int(count):
                flat[f"act_nonfinite/layers.{i}"] = int(count)
                if act_first is None:
                    act_first = f"act/layers.{i}"
    first = None
    for src, label in (("nonfinite_params", "params"), ("nonfinite_grads", "grads")):
        src_first = None
        for path, count in dyn.get(src, {}).items():
            if int(count):
                flat[f"{src}/{path}"] = int(count)
                if src_first is None:
                    src_first = f"{label}/{path}"
        if first is None:
            first = src_first
            if src == "nonfinite_params" and first is None:
                first = act_first
    if first is not None:
        flat["first_nonfinite"] = first
    return flat


def dynamics_record(step: int, flat: dict) -> dict:
    """One ``kind="dynamics"`` record (schema: `telemetry.schema`)."""
    return {"kind": "dynamics", "step": step, **flat}
