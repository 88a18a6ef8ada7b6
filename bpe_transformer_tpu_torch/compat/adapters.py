"""The 21 reference adapter functions on the port's own modules.

Signature contract: the reference suite's ``tests/adapters.py``, as the JAX
package's ``compat/adapters.py`` implements it.  There the tensors cross to
``jnp`` and back; here they go straight into the port's ``ops``, ``models``,
``optim``, ``data``, ``checkpointing`` and ``tokenization`` modules with no
conversion, and every adapter computes on the device of the tensors it is
given (a CUDA tensor on the card, a CPU tensor on the host).
``run_get_batch`` puts its batch on the ``device`` it is asked for.

``get_adamw_cls()`` is a ``torch.optim.Optimizer`` whose ``step`` runs the
port's in-place ``adamw_update`` on each parameter, with the JAX facade's
state keys (``step``: a 0-d int32 tensor on the host; ``exp_avg`` and
``exp_avg_sq``: float32 moments beside the parameter).
``run_save_checkpoint`` writes the JAX adapters' file layout (the model's
state dict as ``params``, the optimizer's state dict under
``extra["torch_optimizer_state"]``, numpy leaves), so either package's
``run_load_checkpoint`` reads the other's files.
"""

from __future__ import annotations

import os
from collections.abc import Iterable
from typing import IO, Any, BinaryIO

import numpy as np
import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.transformer import forward as lm_forward
from bpe_transformer_tpu_torch.models.transformer import (
    params_from_state_dict,
    transformer_block_aux,
)
from bpe_transformer_tpu_torch.ops.core import (
    embedding,
    linear,
    multihead_self_attention,
    rmsnorm,
    scaled_dot_product_attention,
    silu,
    softmax,
    swiglu,
)
from bpe_transformer_tpu_torch.ops.grad import clip_by_global_norm
from bpe_transformer_tpu_torch.ops.losses import cross_entropy
from bpe_transformer_tpu_torch.ops.rope import apply_rope, rope_tables
from bpe_transformer_tpu_torch.optim.adamw import AdamWState, adamw_update
from bpe_transformer_tpu_torch.optim.schedule import cosine_schedule
from bpe_transformer_tpu_torch.tokenization import BPETokenizer, train_bpe

# ----------------------------------------------------------- model ops


def run_linear(d_in, d_out, weights, in_features) -> torch.Tensor:
    return linear(in_features, weights)


def run_embedding(vocab_size, d_model, weights, token_ids) -> torch.Tensor:
    return embedding(weights, token_ids)


def run_swiglu(d_model, d_ff, w1_weight, w2_weight, w3_weight, in_features) -> torch.Tensor:
    return swiglu(in_features, w1_weight, w2_weight, w3_weight)


def run_scaled_dot_product_attention(Q, K, V, mask=None) -> torch.Tensor:
    return scaled_dot_product_attention(Q, K, V, mask)


def run_multihead_self_attention(
    d_model, num_heads, q_proj_weight, k_proj_weight, v_proj_weight,
    o_proj_weight, in_features,
) -> torch.Tensor:
    return multihead_self_attention(
        in_features, q_proj_weight, k_proj_weight, v_proj_weight, o_proj_weight,
        num_heads, causal=True,
    )


def run_multihead_self_attention_with_rope(
    d_model, num_heads, max_seq_len, theta,
    q_proj_weight, k_proj_weight, v_proj_weight, o_proj_weight,
    in_features, token_positions=None,
) -> torch.Tensor:
    return multihead_self_attention(
        in_features, q_proj_weight, k_proj_weight, v_proj_weight, o_proj_weight,
        num_heads, positions=token_positions, rope_theta=theta, max_seq_len=max_seq_len,
        causal=True,
    )


def run_rope(d_k, theta, max_seq_len, in_query_or_key, token_positions) -> torch.Tensor:
    x = in_query_or_key
    cos, sin = rope_tables(x.shape[-1], max_seq_len, theta, dtype=x.dtype, device=x.device)
    return apply_rope(x, token_positions, cos, sin)


def run_transformer_block(
    d_model, num_heads, d_ff, max_seq_len, theta, weights, in_features
) -> torch.Tensor:
    config = ModelConfig(
        vocab_size=1,  # unused by a single block
        context_length=max_seq_len,
        d_model=d_model,
        num_layers=1,
        num_heads=num_heads,
        d_ff=d_ff,
        rope_theta=theta,
    )
    x = in_features
    filler = {
        "token_embeddings.weight": torch.zeros(1, d_model),
        "ln_final.weight": torch.ones(d_model),
        "lm_head.weight": torch.zeros(1, d_model),
    }
    params = params_from_state_dict(
        {f"layers.0.{k}": v for k, v in weights.items()} | filler,
        num_layers=1, device=x.device,
    )
    cos_sin = rope_tables(d_model // num_heads, max_seq_len, theta, device=x.device)
    positions = torch.arange(x.shape[-2], device=x.device)
    out, _ = transformer_block_aux(x, params["layers"][0], config, cos_sin, positions)
    return out


def run_transformer_lm(
    vocab_size, context_length, d_model, num_layers, num_heads, d_ff,
    rope_theta, weights, in_indices,
) -> torch.Tensor:
    config = ModelConfig(
        vocab_size=vocab_size,
        context_length=context_length,
        d_model=d_model,
        num_layers=num_layers,
        num_heads=num_heads,
        d_ff=d_ff,
        rope_theta=rope_theta,
    )
    params = params_from_state_dict(weights, num_layers, device=in_indices.device)
    return lm_forward(params, in_indices, config)


def run_rmsnorm(d_model, eps, weights, in_features) -> torch.Tensor:
    return rmsnorm(in_features, weights, eps=eps)


def run_silu(in_features) -> torch.Tensor:
    return silu(in_features)


def run_softmax(in_features, dim) -> torch.Tensor:
    return softmax(in_features, dim=dim)


# ------------------------------------------------------------- training


def run_cross_entropy(inputs, targets) -> torch.Tensor:
    return cross_entropy(inputs, targets)


def run_gradient_clipping(parameters: Iterable[torch.nn.Parameter], max_l2_norm: float) -> None:
    params = [p for p in parameters if p.grad is not None]
    clipped, _ = clip_by_global_norm([p.grad for p in params], max_l2_norm)
    with torch.no_grad():
        for p, g in zip(params, clipped):
            p.grad.copy_(g)


class _PortAdamW(torch.optim.Optimizer):
    """``torch.optim.Optimizer`` facade over the port's AdamW: torch autograd
    fills the gradients, ``optim.adamw.adamw_update`` writes the parameter
    and its moments in place."""

    def __init__(self, params, lr=1e-3, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-8):
        defaults = dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int32)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                _, new_state = adamw_update(
                    [p], [p.grad],
                    AdamWState(step=state["step"], m=[state["exp_avg"]], v=[state["exp_avg_sq"]]),
                    lr=group["lr"], betas=tuple(group["betas"]), eps=group["eps"],
                    weight_decay=group["weight_decay"],
                )
                state["step"] = new_state.step
        return loss


def get_adamw_cls() -> Any:
    return _PortAdamW


def run_get_lr_cosine_schedule(
    it, max_learning_rate, min_learning_rate, warmup_iters, cosine_cycle_iters
):
    return cosine_schedule(
        it, max_learning_rate, min_learning_rate, warmup_iters, cosine_cycle_iters
    )


# ------------------------------------------------------------------ data


def run_get_batch(dataset, batch_size, context_length, device) -> tuple[torch.Tensor, torch.Tensor]:
    from bpe_transformer_tpu_torch.data.dataset import get_batch

    # Validate the device eagerly (an invalid ordinal must raise).
    torch.empty(0, device=device)
    x, y = get_batch(np.asarray(dataset), batch_size, context_length)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


# -------------------------------------------------------- serialization


def _tree_to_numpy(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _tree_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_numpy(v) for v in obj)
    return obj


def _tree_to_torch(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _tree_to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_torch(v) for v in obj)
    return obj


def run_save_checkpoint(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    iteration: int,
    out: str | os.PathLike | BinaryIO | IO[bytes],
):
    from bpe_transformer_tpu_torch.checkpointing import save_checkpoint

    save_checkpoint(
        out,
        params=_tree_to_numpy(dict(model.state_dict())),
        opt_state=None,
        iteration=iteration,
        extra={"torch_optimizer_state": _tree_to_numpy(optimizer.state_dict())},
    )


def run_load_checkpoint(
    src: str | os.PathLike | BinaryIO | IO[bytes],
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
) -> int:
    from bpe_transformer_tpu_torch.checkpointing import load_checkpoint

    payload = load_checkpoint(src)
    model.load_state_dict(_tree_to_torch(payload["params"]))
    optimizer.load_state_dict(_tree_to_torch(payload["extra"]["torch_optimizer_state"]))
    return payload["iteration"]


# --------------------------------------------------------- tokenization


def get_tokenizer(
    vocab: dict[int, bytes],
    merges: list[tuple[bytes, bytes]],
    special_tokens: list[str] | None = None,
) -> Any:
    return BPETokenizer(vocab=vocab, merges=merges, special_tokens=special_tokens)


def run_train_bpe(
    input_path: str | os.PathLike,
    vocab_size: int,
    special_tokens: list[str],
    **kwargs,
) -> tuple[dict[int, bytes], list[tuple[bytes, bytes]]]:
    return train_bpe(
        input_path=input_path, vocab_size=vocab_size, special_tokens=special_tokens
    )
