"""The run must not have loaded the JAX package or JAX itself: the port is
what is measured.  Names are compared by their top-level part (before the
first dot) whole, so ``bpe_transformer_tpu_torch`` is not
``bpe_transformer_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "bpe_transformer_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
