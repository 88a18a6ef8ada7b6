"""Transformer parameters and the FFN dispatch (port of the parts of
``bpe_transformer_tpu/models/transformer.py`` that serving runs).

Parameters are the JAX package's tree as a plain nested dict of tensors::

    {"token_embeddings": (V, d),
     "layers": [{"attn": {"q_proj", "k_proj", "v_proj", "output_proj"},
                 "ln1": (d,), "ln2": (d,), "ffn": {"w1", "w2", "w3"}}, ...],
     "ln_final": (d,), "lm_head": (V, d)}     # no lm_head when tied

with every matrix in the ``(d_out, d_in)`` layout, so the torch-style flat
state dict and the JAX tree (as numpy arrays) both map onto it 1:1.
"""

from __future__ import annotations

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.ops.core import swiglu

Params = dict


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters with the JAX package's tree and init law:
    truncated normal (std 0.02, cut at 3 std) projections, unit norms.

    Draws come from ``generator`` on the generator's own device and are then
    moved to ``device`` (a seed gives the same weights whatever the target).
    The values differ from ``jax.random``'s for the same seed; carry JAX
    weights across with :func:`params_from_jax` instead.
    """
    dev = resolve_device(device)
    if config.ffn_type not in (None, "swiglu"):
        raise NotImplementedError(
            f"ffn_type={config.ffn_type!r} is not ported yet (SwiGLU only)"
        )
    gen_dev = generator.device

    def dense(d_out, d_in, std=0.02):
        w = torch.empty((d_out, d_in), dtype=torch.float32, device=gen_dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        return (w * std).to(device=dev, dtype=dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    d, ff, v = config.d_model, config.d_ff, config.vocab_size
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head
    embed = dense(v, d)
    head = dense(v, d)
    layers = []
    for _ in range(config.num_layers):
        layers.append(
            {
                "attn": {
                    "q_proj": dense(d, d),
                    "k_proj": dense(d_kv, d),
                    "v_proj": dense(d_kv, d),
                    "output_proj": dense(d, d),
                },
                "ln1": ones(d),
                "ln2": ones(d),
                "ffn": {"w1": dense(ff, d), "w2": dense(d, ff), "w3": dense(ff, d)},
            }
        )
    params = {"token_embeddings": embed, "layers": layers, "ln_final": ones(d)}
    if not config.tie_embeddings:
        params["lm_head"] = head
    return params


def lm_head_weight(params: Params, config: ModelConfig) -> torch.Tensor:
    """The vocab-projection matrix: the embedding itself when tied."""
    if config.tie_embeddings:
        return params["token_embeddings"]
    return params["lm_head"]


def _ffn(x: torch.Tensor, ffn_params: dict, config: ModelConfig) -> torch.Tensor:
    """FFN dispatch for the SwiGLU FFN: ``ffn_impl="pallas"`` runs the fused
    kernel (``kernels/swiglu.py``), anything else the plain composition."""
    if config.ffn_type not in (None, "swiglu"):
        raise NotImplementedError(
            f"ffn_type={config.ffn_type!r} is not ported yet (SwiGLU only)"
        )
    w1, w2, w3 = ffn_params["w1"], ffn_params["w2"], ffn_params["w3"]
    if config.ffn_impl == "pallas":
        from bpe_transformer_tpu_torch.kernels.swiglu import swiglu_fused

        return swiglu_fused(x, w1, w2, w3)
    return swiglu(x, w1, w2, w3)


def _tensor(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.tensor(np.asarray(value), device=device)  # a copy: JAX arrays are read-only


def params_from_jax(tree, device: str | torch.device = "cuda") -> Params:
    """The JAX param tree (``jax.device_get``/numpy leaves) as tensors on
    ``device``, with the same nesting and keys."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    return _tensor(tree, dev)


def params_from_state_dict(
    state_dict: dict,
    num_layers: int,
    tied: bool = False,
    device: str | torch.device = "cuda",
) -> Params:
    """Build the param tree from flat torch-style keys (numpy or tensor
    values): ``token_embeddings.weight``,
    ``layers.{i}.attn.{q,k,v,output}_proj.weight``,
    ``layers.{i}.ln{1,2}.weight``, ``layers.{i}.ffn.w{1,2,3}.weight``,
    ``ln_final.weight`` and, unless ``tied``, ``lm_head.weight``."""
    dev = resolve_device(device)

    def get(key):
        return _tensor(state_dict[key], dev)

    head = {} if tied else {"lm_head": get("lm_head.weight")}
    layers = []
    for i in range(num_layers):
        p = f"layers.{i}."
        layers.append(
            {
                "attn": {
                    name: get(p + f"attn.{name}.weight")
                    for name in ("q_proj", "k_proj", "v_proj", "output_proj")
                },
                "ln1": get(p + "ln1.weight"),
                "ln2": get(p + "ln2.weight"),
                "ffn": {w: get(p + f"ffn.{w}.weight") for w in ("w1", "w2", "w3")},
            }
        )
    return {
        "token_embeddings": get("token_embeddings.weight"),
        "layers": layers,
        "ln_final": get("ln_final.weight"),
        **head,
    }
