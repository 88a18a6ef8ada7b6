"""Autoregressive sampling from a trained LM (the port's rewrite of
``bpe_transformer_tpu/training/sampling.py``).

Generations that fit the context window take the KV-cached path,
:func:`~bpe_transformer_tpu_torch.models.decode.generate_cached` on one row
(one prefill, then one decode step a token, at the config's activation
dtype; the config's kernel knobs pick the kernels), truncated at the first
``stop_id``.
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
from bpe_transformer_tpu_torch.models.decode import _token_sampler, generate_cached
from bpe_transformer_tpu_torch.models.transformer import forward, params_from_jax


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
    params = params_from_jax(params, dev)
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    if len(prompt) + max_new_tokens <= ctx:
        ids = generate_cached(
            params, [prompt], config=config, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, stop_id=stop_id,
            generator=generator, device=dev,
        )
        # Tokens after the first stop_id are pinned to it: truncating there
        # gives the sliding-window path's early exit.
        out = ids[0].tolist()
        if stop_id is not None and stop_id in out:
            out = out[: out.index(stop_id) + 1]
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
    sample = _token_sampler(1, temperature, top_k, top_p, generator, dev)
    out: list[int] = []
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
