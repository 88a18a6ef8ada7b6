"""Draft model for speculative decoding (port of
``bpe_transformer_tpu/serving/spec/draft.py``): its config, its parameters,
and the propose and prefill passes over its own dense KV cache.

A draft shares the target's vocabulary and context window and guesses K
tokens per slot per tick; the target scores all of them in one batched
verify pass (``serving/spec/engine.py``).  Two ways to get one
(:class:`DraftSpec`):

* **tiny geometry**: its own ``d_model``/``num_layers``/``num_heads``/
  ``d_ff``, initialized from a seeded ``torch.Generator`` (``seed``), or
  given trained parameters;
* **truncated view** (``truncate_layers: N``): the target's first N blocks
  with its embedding and head, sharing the target's tensors (the same
  ``torch.Tensor`` objects; int8 weight dicts pass through whole), so it
  adds no weight memory.

As in the JAX package the draft runs the plain attention and FFN paths
(``attention_impl``/``ffn_impl``/``decode_attention_impl`` "xla"); its
linears take the int8 matmul kernel when it views an int8 target, and the
truncated draft of a ``gelu`` target, itself a ``gelu`` model, runs the GeLU
kernel in every FFN (the JAX draft's FFN calls its Pallas kernel too).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.decode import decode_step, prefill
from bpe_transformer_tpu_torch.models.transformer import init_params, lm_head_weight
from bpe_transformer_tpu_torch.ops.quant import is_quantized
from bpe_transformer_tpu_torch.serving.engine import activation_dtype, filter_logits, gumbel_noise
from bpe_transformer_tpu_torch.tree import tree_leaves

__all__ = ["DraftSpec", "DraftModel", "propose", "draft_prefill"]

_GEOMETRY = ("d_model", "num_layers", "num_heads", "d_ff")


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """Declarative draft description (the ``--draft-config`` JSON).

    Exactly one of ``truncate_layers`` or the geometry fields selects the
    draft.  ``vocab_size``, when given, is checked against the target: the
    acceptance rule compares distributions over one vocabulary.
    """

    truncate_layers: int | None = None
    d_model: int | None = None
    num_layers: int | None = None
    num_heads: int | None = None
    d_ff: int | None = None
    num_kv_heads: int | None = None
    vocab_size: int | None = None
    seed: int = 0

    @classmethod
    def from_dict(cls, raw: dict) -> "DraftSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ValueError(f"draft config has unknown key(s): {', '.join(unknown)}")
        return cls(**raw)

    @classmethod
    def from_json(cls, path: str | Path) -> "DraftSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def validate_against(self, target: ModelConfig) -> None:
        """Raise ``ValueError`` for a draft the target can never verify: a
        vocabulary mismatch, a truncation deeper than the target, both a
        truncation and a geometry, or an incomplete geometry."""
        if self.vocab_size is not None and self.vocab_size != target.vocab_size:
            raise ValueError(
                f"draft vocab_size={self.vocab_size} != target vocab_size={target.vocab_size}: "
                "speculative verification compares distributions over one shared vocabulary"
            )
        if self.truncate_layers is not None:
            if not 1 <= self.truncate_layers <= target.num_layers:
                raise ValueError(
                    f"truncate_layers={self.truncate_layers} must be in "
                    f"[1, {target.num_layers}] (the target's depth)"
                )
            if any(getattr(self, f) is not None for f in _GEOMETRY):
                raise ValueError("give truncate_layers OR a draft geometry, not both")
        else:
            missing = [f for f in _GEOMETRY if getattr(self, f) is None]
            if missing:
                raise ValueError(
                    "draft geometry incomplete: missing " + ", ".join(missing)
                    + " (or set truncate_layers)"
                )

    def resolve(self, target: ModelConfig) -> ModelConfig:
        """The draft's :class:`ModelConfig`: the target's vocabulary,
        context, RoPE and activation dtype, the plain execution paths, and a
        dense (never paged) KV cache."""
        self.validate_against(target)
        common = dict(attention_impl="xla", ffn_impl="xla", decode_attention_impl="xla",
                      remat=False)
        if self.truncate_layers is not None:
            return dataclasses.replace(target, num_layers=self.truncate_layers, **common)
        return ModelConfig(
            vocab_size=target.vocab_size,
            context_length=target.context_length,
            d_model=self.d_model,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            d_ff=self.d_ff,
            num_kv_heads=self.num_kv_heads,
            rope_theta=target.rope_theta,
            tie_embeddings=False,
            activation_dtype=target.activation_dtype,
            **common,
        )


def _cast_tree(tree, dtype: torch.dtype):
    """``tree`` with every float leaf at ``dtype``; leaves already there and
    int8 weight dicts pass through as the same objects."""
    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {key: _cast_tree(value, dtype) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(item, dtype) for item in tree)
    return tree if tree.dtype == dtype else tree.to(dtype)


class DraftModel:
    """A draft ready to run: the resolved config, its parameters and its
    LM head, built from a :class:`DraftSpec` against the target's
    parameters and config.  ``params`` overrides the parameters (a trained
    geometry draft)."""

    def __init__(self, target_params, target_config: ModelConfig, spec: DraftSpec, params=None,
                 *, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        self.spec = spec
        self.config = spec.resolve(target_config)
        self.truncated = spec.truncate_layers is not None
        if params is None:
            if self.truncated:
                params = dict(target_params)
                params["layers"] = list(target_params["layers"][: spec.truncate_layers])
            else:
                params = init_params(self.config, torch.Generator().manual_seed(spec.seed),
                                     device=dev)
        act = activation_dtype(self.config)
        head = lm_head_weight(params, self.config)
        self.lm_head = head if is_quantized(head) else head.to(act)
        self.params = _cast_tree(params, act)
        #: Weight bytes the draft adds: its leaves that are not the target's
        #: (by identity); 0 for a truncated view.
        target_ids = {id(leaf) for leaf in tree_leaves(target_params)}
        self.param_bytes = sum(
            t.numel() * t.element_size() for t in tree_leaves(self.params)
            if id(t) not in target_ids
        )


@torch.inference_mode()
def propose(draft: DraftModel, cache, tokens, positions, active, temps, top_ks, top_ps,
            generators, k: int):
    """K draft tokens per slot: K dense decode steps over the draft's own
    cache (written in place).  Step ``j`` feeds the previous token (step 0:
    the slot's not-yet-written last token) at its position, filters the
    logits under the slot's knobs and draws ``d_j``; ``q_j`` is the filtered
    softmax it was drawn from, the exact one-hot of the raw argmax for
    greedy slots.  Sampled slots draw one gumbel row a step from their
    ``generators`` entry.  A last step writes ``d_K``'s KV row, so that a
    fully accepted window leaves no hole in the draft cache.  Inactive slots
    keep their token, position and cache rows.

    ``tokens``/``positions``/``active``/knobs are host arrays ``(slots,)``;
    returns ``(draft_tokens (S, K) int64, draft_probs (S, K, V) float32)`` on
    the cache's device.  Positions past the context are clamped to its last
    row, as the JAX package's gathers clamp: such steps are never judged."""
    cfg = draft.config
    dev = cache[0]["k"].device
    ctx, vocab = cfg.context_length, cfg.vocab_size
    n = len(tokens)
    sampled = [s for s in range(n) if active[s] and temps[s] > 0.0]
    temps_t = torch.as_tensor(
        np.where(np.isin(np.arange(n), sampled), temps, 0.0).astype(np.float32), device=dev)
    top_ks_t = torch.as_tensor(top_ks, device=dev)
    top_ps_t = torch.as_tensor(top_ps, device=dev)
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    pos = torch.as_tensor(positions, dtype=torch.int64, device=dev)
    act = torch.as_tensor(active, device=dev)
    ds, qs = [], []
    for _ in range(k):
        logits, _ = decode_step(draft.params, tok, pos.clamp(max=ctx - 1), cache, cfg,
                                lm_head=draft.lm_head, active=act)
        greedy = torch.argmax(logits, dim=-1)
        q = torch.nn.functional.one_hot(greedy, vocab).float()
        d = greedy
        if sampled:
            masked = filter_logits(logits, temps_t, top_ks_t, top_ps_t)
            gumbel = torch.zeros((n, vocab), dtype=torch.float32, device=dev)
            for s in sampled:
                gumbel[s] = gumbel_noise(generators[s], vocab, dev)
            is_sampled = temps_t > 0.0
            d = torch.where(is_sampled, torch.argmax(masked + gumbel, dim=-1), greedy)
            q = torch.where(is_sampled[:, None], torch.softmax(masked, dim=-1), q)
        tok = torch.where(act, d, tok)
        pos = torch.where(act, pos + 1, pos)
        ds.append(tok)
        qs.append(q)
    decode_step(draft.params, tok, pos.clamp(max=ctx - 1), cache, cfg, lm_head=draft.lm_head,
                active=act, return_hidden=True)
    return torch.stack(ds, dim=1), torch.stack(qs, dim=1)


@torch.inference_mode()
def draft_prefill(draft: DraftModel, cache, prompt, slot: int, bucket: int) -> None:
    """Fill ``slot``'s rows of the draft cache from the whole prompt, padded
    to ``bucket`` (the dense engine's prefill without its sampling: the
    target's prefill owns the first token).  The slot's whole cache row is
    replaced, zeros past the bucket."""
    dev = cache[0]["k"].device
    plen = len(prompt)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :plen] = prompt
    row = []
    for layer in cache:
        layer["k"][slot].zero_()
        layer["v"][slot].zero_()
        row.append({"k": layer["k"][slot : slot + 1], "v": layer["v"][slot : slot + 1]})
    prefill(draft.params, torch.as_tensor(padded, device=dev), draft.config, row,
            lm_head=draft.lm_head, last_pos=torch.tensor([plen - 1], device=dev))
