"""Seeded weights and tokens, made on the device in a few large calls.

The parameter tree is the configuration's architecture's (``spec.
architecture``): its ``layout(model)`` lists each leaf's path, shape and
init law, and the functions here take that layout.  Every ``"matrix"``
leaf is drawn in one call, from a truncated normal (std 0.02, cut at 3 std)
as the models' own init law; every ``"gain"`` leaf in a second, ``1 + 0.1
z`` so that the gains are not all 1 and the comparison sees them; a
``"zeros"`` leaf is zeros.  The draws come from a ``torch.Generator`` on
the device seeded with the run's seed, in float32, matrices in layout
order then gains, and are cast to the dtype asked for in one call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INITS = ("matrix", "gain", "zeros")


def _insert(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def skeleton(layout: list) -> dict:
    """The parameter tree of ``layout`` with each leaf's shape in its place."""
    tree: dict = {}
    for path, shape, _ in layout:
        _insert(tree, path, shape)
    return tree


def tree_from(layout: list, host_leaves: list, device, dtype=None) -> dict:
    """The parameter tree of ``layout`` holding ``host_leaves`` (in
    :func:`leaves` order) on ``device``, cast to ``dtype`` when given."""
    it = iter(host_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, list):
            return [build(x) for x in node]
        return next(it).to(device=device, dtype=dtype)

    return build(skeleton(layout))


def make_params(layout: list, seed: int, device, dtype=torch.float32) -> dict:
    """The parameter tree of ``layout`` from ``seed``, on ``device`` in
    ``dtype``: one draw for the matrices, one for the gains."""
    unknown = {init for _, _, init in layout} - set(INITS)
    if unknown:
        raise ValueError(f"init laws {sorted(unknown)} are not among {INITS}")
    sizes = {init: [math.prod(s) for _, s, i in layout if i == init] for init in INITS}
    n_mat, n_gain = sum(sizes["matrix"]), sum(sizes["gain"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(n_mat + n_gain, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat[:n_mat], 0.0, 0.02, -0.06, 0.06, generator=gen)
    flat[n_mat:].normal_(1.0, 0.1, generator=gen)
    flat = flat.to(dtype)
    chunks = {"matrix": iter(flat[:n_mat].split(sizes["matrix"])),
              "gain": iter(flat[n_mat:].split(sizes["gain"]))}
    tree: dict = {}
    for path, shape, init in layout:
        value = (torch.zeros(shape, dtype=dtype, device=device) if init == "zeros"
                 else next(chunks[init]).view(shape).clone())
        _insert(tree, path, value)
    return tree


def leaves(tree) -> list:
    """The leaves of a parameter tree in sorted-key order (the order the
    program's flat layouts use)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted paths of :func:`leaves`, in the same order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, item in enumerate(tree) for n in leaf_names(item, f"{prefix}{i}.")]
    return [prefix[:-1]]


def token_pool(seed: int, vocab: int, n: int) -> np.ndarray:
    """``n`` token ids (int32, on the host) drawn uniformly over the
    vocabulary from ``seed``: the array the training feed samples windows
    from."""
    return np.random.default_rng([int(seed), 1]).integers(0, vocab, n, dtype=np.int32)
