"""Model-FLOPs accounting and the card's peak rates (the port's rewrite of
``bpe_transformer_tpu/utils/flops.py``: the training-step, prefill and
decode-tick FLOPs, the peak tables that the rooflines read, and
:func:`mfu`).

The FLOPs estimate is the JAX package's ("6ND + attention"):

    forward FLOPs = 2 * N_matmul * tokens + 4 * L * S * d_model * tokens

where ``N_matmul`` counts parameters that take part in dense matmuls
(attention/FFN projections and the LM head; the embedding gather is
bandwidth, not FLOPs).

The peak tables hold NVIDIA H100 rows only, keyed on a substring of the CUDA
device name (``torch.cuda.get_device_name``): dense bf16 tensor-core
FLOP/s and HBM bytes/s from NVIDIA's H100 data sheet (SXM: 989 TFLOP/s,
3.35 TB/s; PCIe: 756 TFLOP/s, 2.0 TB/s).  Any other name, the CPU
included, has no peak: the roofline's verdict is then ``"unknown"``.
"""

from __future__ import annotations

from bpe_transformer_tpu_torch.models.config import ModelConfig

#: ``(device-name substring, dense bf16 FLOP/s, HBM bytes/s)``, most
#: specific first: "H100 PCIe" must not fall through to the SXM row, whose
#: name on the card is "NVIDIA H100 80GB HBM3".
_H100_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
)


def _peak_row(device_kind: str | None):
    kind = (device_kind or "").lower()
    for pattern, flops, bandwidth in _H100_PEAKS:
        if pattern in kind:
            return flops, bandwidth
    return None


def peak_flops_per_chip(device_kind: str | None) -> float | None:
    """Dense bf16 tensor-core FLOP/s of the named card, or None when the
    table has no row for it."""
    row = _peak_row(device_kind)
    return row[0] if row else None


def peak_hbm_bytes_per_sec(device_kind: str | None) -> float | None:
    """HBM bytes/s of the named card, or None when the table has no row."""
    row = _peak_row(device_kind)
    return row[1] if row else None


def matmul_param_count(config: ModelConfig) -> int:
    """Parameters participating in dense matmuls (excludes embedding gather)."""
    d, ff, L = config.d_model, config.d_ff, config.num_layers
    # q + output are (d, d); GQA shrinks k/v to (num_kv_heads * d_head, d).
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head
    attn = 2 * d * d + 2 * d * d_kv
    if config.ffn_type == "moe":
        ffn = config.router_top_k * 3 * d * ff + d * config.n_experts
    elif config.ffn_type in ("silu", "gelu"):
        ffn = 2 * d * ff
    else:  # SwiGLU: w1, w3 (d->ff) and w2 (ff->d)
        ffn = 3 * d * ff
    lm_head = d * config.vocab_size
    return L * (attn + ffn) + lm_head


def train_step_flops(config: ModelConfig, batch: int, seq: int | None = None) -> float:
    """Model FLOPs of one full training step (forward + backward) at the
    given shape: three times the forward estimate above."""
    S = seq or config.context_length
    tokens = batch * S
    matmul = 2.0 * matmul_param_count(config) * tokens
    attention = 4.0 * config.num_layers * S * config.d_model * tokens
    return 3.0 * (matmul + attention)


def decode_tick_flops(config: ModelConfig, n_tokens: int, kv_positions: int) -> float:
    """Model FLOPs of ONE serving decode tick: ``n_tokens`` single-token
    forwards (each sweeps the matmul weights once) plus attention against
    ``kv_positions`` total visible cache positions (``4 * d_model`` FLOPs
    per visible key per layer for QK^T and AV)."""
    matmul = 2.0 * matmul_param_count(config) * n_tokens
    attention = 4.0 * config.num_layers * config.d_model * kv_positions
    return matmul + attention


def prefill_flops(config: ModelConfig, tokens: int) -> float:
    """Model FLOPs of one prefill of ``tokens`` positions: the forward third
    of :func:`train_step_flops` at batch 1 and that sequence length (the
    full-sequence attention term, as the training count has it)."""
    return train_step_flops(config, 1, tokens) / 3.0


def mfu(
    config: ModelConfig,
    batch: int,
    step_time_s: float,
    device_kind: str,
    n_chips: int = 1,
    seq: int | None = None,
) -> float | None:
    """Model FLOPs utilization of a training step in [0, 1]:
    :func:`train_step_flops` over ``step_time_s`` against ``n_chips`` cards'
    dense bf16 peak; None when the table has no row for ``device_kind`` or
    the time is not positive."""
    peak = peak_flops_per_chip(device_kind)
    if peak is None or step_time_s <= 0:
        return None
    achieved = train_step_flops(config, batch, seq) / step_time_s
    return achieved / (peak * max(n_chips, 1))
