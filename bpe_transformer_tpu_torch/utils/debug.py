"""Debug toggles: NaN checking and finite-ness assertions (the port's
counterpart of ``bpe_transformer_tpu/utils/debug.py``).

The JAX package turns on ``jax_debug_nans``; the port's counterpart is
autograd's anomaly mode with NaN checks, which names the forward op whose
backward produced a NaN.  :func:`check_finite` is the explicit check at a
step boundary, with the JAX package's message.
"""

from __future__ import annotations

import contextlib

import torch

from bpe_transformer_tpu_torch.tree import tree_flatten_with_path


@contextlib.contextmanager
def nan_checks(enabled: bool = True):
    """``torch.autograd.set_detect_anomaly(enabled, check_nan=True)`` within
    the block, the previous mode restored on exit.  A backward that makes a
    NaN then raises at the op that made it, with the forward's traceback.
    Slow: for debugging runs, not production training."""
    previous = torch.is_anomaly_enabled()
    previous_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(previous, check_nan=previous_nan)


def _keystr(tree, path: tuple) -> str:
    """``path`` as ``jax.tree_util.keystr`` writes it: ``['key']`` for a dict
    key, ``.field`` for a named tuple's field, ``[i]`` for a list or tuple
    index."""
    parts = []
    node = tree
    for key in path:
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            parts.append(f".{node._fields[key]}")
        else:
            parts.append(f"[{key!r}]")
        node = node[key]
    return "".join(parts)


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` when a leaf of ``tree`` holds a NaN or an
    infinity, naming every such leaf by its path.

    Every leaf's ``isfinite`` reduction is launched first and the results
    come to the host in one read, so the check costs one sync whatever the
    tree's size; meant for checkpoint boundaries, so that a corrupted state
    is never written."""
    leaves = [(path, leaf) for path, leaf in tree_flatten_with_path(tree)
              if isinstance(leaf, torch.Tensor)]
    if not leaves:
        return
    finite = torch.stack([torch.isfinite(leaf).all() for _, leaf in leaves]).tolist()
    bad = [_keystr(tree, path) for (path, _), ok in zip(leaves, finite) if not ok]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
