"""The yardstick's arithmetic: model FLOPs, each kernel call's least work,
and the card's peaks.

The model FLOPs are a frozen copy of the program's
``bpe_transformer_tpu_torch/utils/flops.py`` (the "6ND + attention"
estimate), kept here so that a change to the program cannot change what
the benchmark counts.  Its attention term counts the whole ``S x S`` score
matrix (not the causal half), as the original does; ``mfu`` metrics inherit
that convention.

The kernel counts are the work of a call, not of an implementation: FLOPs
and bytes from the call's input and output shapes, each input byte read
once and each output byte written once, and causal attention counted over
the lower triangle it needs.  A call's least time is the larger of its
FLOPs over the peak rate and its bytes over the peak bandwidth.

A configuration is a plain mapping with the model's sizes (the ``model``
object of a ``configs/*.json`` file).
"""

from __future__ import annotations

#: ``(device-name substring, dense bf16 FLOP/s, HBM bytes/s)``, most
#: specific first (NVIDIA's H100 data sheet, dense, no sparsity; the SXM
#: part's name on the card is "NVIDIA H100 80GB HBM3").
PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
)


def peaks(device_kind: str | None) -> tuple[float, float] | None:
    """``(FLOP/s, bytes/s)`` of the named card, or None when the table has
    no row for it (then no roofline or utilization is reported)."""
    kind = (device_kind or "").lower()
    for pattern, flops, bandwidth in PEAKS:
        if pattern in kind:
            return flops, bandwidth
    return None


# ------------------------------------------------------------ model FLOPs


def matmul_param_count(cfg: dict) -> int:
    """Parameters that take part in dense matmuls (the embedding gather is
    bandwidth, not FLOPs)."""
    d, ff, n_layers = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    d_head = d // cfg["num_heads"]
    d_kv = (cfg.get("num_kv_heads") or cfg["num_heads"]) * d_head
    attn = 2 * d * d + 2 * d * d_kv
    ffn_type = cfg.get("ffn_type")
    if ffn_type == "moe":
        ffn = cfg["router_top_k"] * 3 * d * ff + d * cfg["n_experts"]
    elif ffn_type in ("silu", "gelu"):
        ffn = 2 * d * ff
    else:
        ffn = 3 * d * ff
    return n_layers * (attn + ffn) + d * cfg["vocab_size"]


def train_step_flops(cfg: dict, batch: int, seq: int | None = None) -> float:
    """Model FLOPs of one training step (forward + backward): three times
    the forward's ``2 N tokens + 4 L S d tokens``."""
    s = seq or cfg["context_length"]
    tokens = batch * s
    matmul = 2.0 * matmul_param_count(cfg) * tokens
    attention = 4.0 * cfg["num_layers"] * s * cfg["d_model"] * tokens
    return 3.0 * (matmul + attention)


def decode_tick_flops(cfg: dict, n_tokens: int, kv_positions: int) -> float:
    """Model FLOPs of one decode tick: ``n_tokens`` one-token forwards and
    attention over ``kv_positions`` visible cache positions in all."""
    matmul = 2.0 * matmul_param_count(cfg) * n_tokens
    attention = 4.0 * cfg["num_layers"] * cfg["d_model"] * kv_positions
    return matmul + attention


def prefill_flops(cfg: dict, tokens: int) -> float:
    """Model FLOPs of one prefill of ``tokens`` positions (the forward third
    of :func:`train_step_flops` at batch 1)."""
    return train_step_flops(cfg, 1, tokens) / 3.0


# ------------------------------------------------------ kernel call work


def flash_attention_rope_work(batch: int, heads: int, seq: int, d_head: int,
                              itemsize: int) -> tuple[float, float]:
    """``(FLOPs, bytes)`` of one causal RoPE flash forward as the training
    step calls it: q, k, v ``(B, H, S, D)`` and the cos/sin rows ``(S,
    D/2)`` in, the output ``(B, H, S, D)`` and the float32 row
    log-sum-exp ``(B, H, S)`` out.  QK^T and PV over the ``S (S + 1) / 2``
    causal pairs (RoPE's rotations are a lower-order term, not counted)."""
    bh = batch * heads
    pairs = seq * (seq + 1) / 2
    flops = 4.0 * bh * d_head * pairs
    qkvo = 4 * bh * seq * d_head * itemsize
    tables = 2 * seq * (d_head // 2) * itemsize
    lse = bh * seq * 4
    return flops, float(qkvo + tables + lse)


def swiglu_work(m: int, d: int, ff: int, itemsize: int) -> tuple[float, float]:
    """``(FLOPs, bytes)`` of one SwiGLU FFN call on ``m`` rows: the three
    ``d x ff`` products; x and the three weights in, the output out."""
    flops = 6.0 * m * d * ff
    nbytes = (2 * m * d + 3 * d * ff) * itemsize
    return flops, float(nbytes)


def decode_attention_work(rows: int, heads: int, kv_heads: int, d_head: int,
                          visible: int, itemsize: int) -> tuple[float, float]:
    """``(FLOPs, bytes)`` of one decode-attention call over ``rows`` live
    sequences that see ``visible`` cache positions in all: q and the output
    ``(rows, H, D)``, each visible K and V row ``(KV, D)`` read once, and
    the positions (int64)."""
    flops = 4.0 * heads * d_head * visible
    nbytes = 2 * rows * heads * d_head * itemsize + 2 * visible * kv_heads * d_head * itemsize
    return flops, float(nbytes + 8 * rows)


def least_seconds(flops: float, nbytes: float, device_kind: str | None) -> float | None:
    """The larger of ``flops`` over the peak rate and ``nbytes`` over the
    peak bandwidth, or None without a peak row."""
    row = peaks(device_kind)
    if row is None:
        return None
    return max(flops / row[0], nbytes / row[1])
