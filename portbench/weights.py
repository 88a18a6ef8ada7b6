"""Seeded weights and tokens, made on the device in a few large calls.

The parameter tree is the layout the program takes and the plain reference
reads (``(d_out, d_in)`` matrices):

    {"token_embeddings": (V, d), "lm_head": (V, d), "ln_final": (d,),
     "layers": [{"attn": {"q_proj", "k_proj", "v_proj", "output_proj"},
                 "ln1": (d,), "ln2": (d,),
                 "ffn": {"w1": (ff, d), "w2": (d, ff), "w3": (ff, d)}
                    or {"router": (e, d), "w1": (e, ff, d),
                        "w2": (e, d, ff), "w3": (e, ff, d)}}, ...]}

Every matrix is drawn in one call, from a truncated normal (std 0.02, cut at
3 std) as the models' own init law; every norm gain in a second, ``1 + 0.1
z`` so that the gains are not all 1 and the comparison sees them.  Both come
from a ``torch.Generator`` on the device seeded with the run's seed, in
float32, and are cast to the dtype asked for in one call.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def leaf_shapes(cfg: dict) -> list[tuple[tuple, tuple]]:
    """``(path, shape)`` of every leaf, matrices first, then norm gains."""
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    d_kv = (cfg.get("num_kv_heads") or cfg["num_heads"]) * (d // cfg["num_heads"])
    mats = [(("token_embeddings",), (v, d)), (("lm_head",), (v, d))]
    norms = [(("ln_final",), (d,))]
    for i in range(cfg["num_layers"]):
        mats += [(("layers", i, "attn", "q_proj"), (d, d)),
                 (("layers", i, "attn", "k_proj"), (d_kv, d)),
                 (("layers", i, "attn", "v_proj"), (d_kv, d)),
                 (("layers", i, "attn", "output_proj"), (d, d))]
        if cfg.get("ffn_type") == "moe":
            e = cfg["n_experts"]
            mats += [(("layers", i, "ffn", "router"), (e, d)),
                     (("layers", i, "ffn", "w1"), (e, ff, d)),
                     (("layers", i, "ffn", "w2"), (e, d, ff)),
                     (("layers", i, "ffn", "w3"), (e, ff, d))]
        else:
            mats += [(("layers", i, "ffn", "w1"), (ff, d)),
                     (("layers", i, "ffn", "w2"), (d, ff)),
                     (("layers", i, "ffn", "w3"), (ff, d))]
        norms += [(("layers", i, "ln1"), (d,)), (("layers", i, "ln2"), (d,))]
    return mats + norms


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


def skeleton(cfg: dict) -> dict:
    """The parameter tree of ``cfg`` with each leaf's shape in its place."""
    tree: dict = {}
    for path, shape in leaf_shapes(cfg):
        _insert(tree, path, shape)
    return tree


def tree_from(cfg: dict, host_leaves: list, device, dtype=None) -> dict:
    """The parameter tree of ``cfg`` holding ``host_leaves`` (in
    :func:`leaves` order) on ``device``, cast to ``dtype`` when given."""
    it = iter(host_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, list):
            return [build(x) for x in node]
        return next(it).to(device=device, dtype=dtype)

    return build(skeleton(cfg))


def make_params(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The parameter tree of ``cfg`` from ``seed``, on ``device`` in
    ``dtype``: one draw for the matrices, one for the gains."""
    shapes = leaf_shapes(cfg)
    n_mat = sum(math.prod(s) for p, s in shapes if len(s) > 1)
    n_norm = sum(math.prod(s) for p, s in shapes if len(s) == 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(n_mat + n_norm, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat[:n_mat], 0.0, 0.02, -0.06, 0.06, generator=gen)
    flat[n_mat:].normal_(1.0, 0.1, generator=gen)
    flat = flat.to(dtype)
    tree: dict = {}
    for (path, shape), chunk in zip(shapes, flat.split([math.prod(s) for _, s in shapes])):
        _insert(tree, path, chunk.view(shape).clone())
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
