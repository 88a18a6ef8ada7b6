"""Autoregressive sampling from a trained LM (the port's rewrite of
``bpe_transformer_tpu/training/sampling.py``).

Generations that fit the context window take the KV-cached path: one
:func:`~bpe_transformer_tpu_torch.models.decode.prefill` of the prompt, then
one :func:`~bpe_transformer_tpu_torch.models.decode.decode_step` a token, at
the config's activation dtype (the config's kernel knobs pick the kernels).
Longer generations slide a ``context_length`` window and re-run the full
:func:`~bpe_transformer_tpu_torch.models.transformer.forward` each token.
An MoE model's cached path routes with the decode capacity (from
``context_length``: a decode step drops no token), the sliding window with
the full forward's default capacity, as in the JAX package; the two differ
only where the full forward itself drops tokens.

Sampling is the serving engine's (``serving/engine.py`` ``sample_tokens``):
temperature 0 is the raw argmax; otherwise top-k/top-p filtered logits plus
gumbel noise from a ``torch.Generator`` seeded with ``seed``.  Greedy ids
equal the JAX package's; seeded draws follow the same law with other bits.
"""

from __future__ import annotations

import sys

import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.decode import decode_step, init_kv_cache, prefill
from bpe_transformer_tpu_torch.models.transformer import (
    forward,
    lm_head_weight,
    params_from_jax,
)
from bpe_transformer_tpu_torch.serving.engine import (
    TOP_K_DISABLED,
    TOP_P_DISABLED,
    activation_dtype,
    gumbel_noise,
    sample_tokens,
)
from bpe_transformer_tpu_torch.tree import tree_map


class _Sampler:
    """``_sample_from_logits``'s counterpart: one token from a ``(1, vocab)``
    float32 logits row, drawing noise only when the temperature is set."""

    def __init__(self, temperature: float, top_k: int | None, top_p: float | None,
                 seed: int, device: torch.device):
        self.device = device
        self.greedy = temperature == 0.0
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.temps = torch.tensor([temperature], dtype=torch.float32, device=device)
        self.top_ks = torch.tensor([TOP_K_DISABLED if top_k is None else top_k], device=device)
        self.top_ps = torch.tensor(
            [TOP_P_DISABLED if top_p is None else top_p], dtype=torch.float32, device=device
        )

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        gumbel = gumbel_noise(self.generator, logits.shape, self.device)
        return sample_tokens(logits, gumbel, self.temps, self.top_ks, self.top_ps)


@torch.inference_mode()
def generate_ids(
    params,
    config: ModelConfig,
    prompt_ids: list[int],
    max_new_tokens: int = 128,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    seed: int = 0,
    stop_id: int | None = None,
    device: str | torch.device = "cuda",
) -> list[int]:
    """Sample token ids continuing ``prompt_ids`` (sliding-window context);
    ``params`` is a tree of tensors or numpy arrays (a loaded checkpoint's),
    moved to ``device``."""
    dev = resolve_device(device)
    ctx = config.context_length
    prompt = list(prompt_ids)[-ctx:]
    if not prompt:
        raise ValueError("prompt must contain at least one token")
    act = activation_dtype(config)
    params = params_from_jax(params, dev)
    sample = _Sampler(temperature, top_k, top_p, seed, dev)

    out: list[int] = []
    if len(prompt) + max_new_tokens <= ctx:
        # KV-cached path at the activation dtype, the head cast to it too
        # (logits stay float32).
        lm_head = lm_head_weight(params, config).to(act)
        params = tree_map(lambda p: p.to(act), params)
        cache = init_kv_cache(config, 1, dtype=act, device=dev)
        logits, cache = prefill(params, torch.tensor([prompt], device=dev), config, cache,
                                lm_head=lm_head)
        token = sample(logits)
        for i in range(max_new_tokens):
            out.append(int(token[0]))
            if (stop_id is not None and out[-1] == stop_id) or i == max_new_tokens - 1:
                break
            logits, cache = decode_step(params, token, len(prompt) + i, cache, config,
                                        lm_head=lm_head)
            token = sample(logits)
        return out

    # Sliding-window path (prompt + continuation exceed the window): a full
    # forward per token.
    if config.decode_attention_impl != "xla":
        print(
            "generate_ids: generation exceeds the context window, taking the "
            "sliding-window path; decode_attention_impl="
            f"{config.decode_attention_impl!r} only applies to the KV-cached path "
            "(shorten max_new_tokens to fit the window to use it)",
            file=sys.stderr,
        )
    buf = list(prompt)
    for _ in range(max_new_tokens):
        logits = forward(params, torch.tensor([buf], device=dev), config)[:, -1]
        next_id = int(sample(logits)[0])
        out.append(next_id)
        if stop_id is not None and next_id == stop_id:
            break
        buf = (buf + [next_id])[-ctx:]
    return out


def generate_text(
    params,
    config: ModelConfig,
    tokenizer,
    prompt: str = "",
    max_new_tokens: int = 128,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> str:
    """Encode ``prompt``, sample a continuation, return prompt + decode."""
    return prompt + tokenizer.decode(
        generate_prompt_ids(params, config, tokenizer, prompt, max_new_tokens, temperature,
                            top_k, top_p, seed, device)
    )


def generate_prompt_ids(
    params,
    config: ModelConfig,
    tokenizer,
    prompt: str = "",
    max_new_tokens: int = 128,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[int]:
    """The ids :func:`generate_text` decodes: ``prompt`` encoded (token 0
    when empty), continued until the tokenizer's first special token or the
    budget."""
    prompt_ids = tokenizer.encode(prompt) if prompt else [0]
    stop_id = None
    specials = getattr(tokenizer, "special_tokens", None) or []
    if specials:
        stop_id = tokenizer.encode(specials[0])[0]
    return generate_ids(
        params, config, prompt_ids, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, seed=seed, stop_id=stop_id, device=device,
    )
