"""Roofline classification (the port's rewrite of ``roofline`` and
``decode_tick_roofline`` from ``bpe_transformer_tpu/telemetry/attribution.py``;
the rest of that module waits for the training-observability slice).

Peaks come from ``utils/flops.py``'s H100 table, keyed on the CUDA device
name; on any other device the verdict is ``"unknown"`` and the projected
time is None, while the byte and FLOP counts stay real.
"""

from __future__ import annotations

from bpe_transformer_tpu_torch.utils.flops import peak_flops_per_chip, peak_hbm_bytes_per_sec


def roofline(
    flops: float | None,
    bytes_accessed: float | None,
    device_kind: str | None,
    name: str = "program",
) -> dict:
    """Classify one unit of work against the device roofline: the raw
    counters, the arithmetic intensity (FLOPs/byte), the ridge point (peak
    FLOP/s over peak bytes/s) and a ``bound`` verdict, ``"compute-bound"``
    / ``"memory-bound"`` / ``"unknown"`` (no counters, or no peak-table row
    for the device)."""
    intensity = None
    if flops and bytes_accessed:
        intensity = flops / bytes_accessed
    peak_f = peak_flops_per_chip(device_kind)
    peak_bw = peak_hbm_bytes_per_sec(device_kind)
    ridge = peak_f / peak_bw if peak_f and peak_bw else None
    bound = "unknown"
    if intensity is not None and ridge is not None:
        bound = "compute-bound" if intensity >= ridge else "memory-bound"
    return {
        "name": name,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": round(intensity, 3) if intensity is not None else None,
        "ridge_flops_per_byte": round(ridge, 3) if ridge is not None else None,
        "bound": bound,
        "peak_flops_per_sec": peak_f,
        "peak_hbm_bytes_per_sec": peak_bw,
    }


def decode_tick_roofline(
    *,
    flops: float,
    weight_bytes: float,
    kv_bytes: float,
    act_bytes: float,
    device_kind: str | None,
) -> dict:
    """The serving decode tick's analytic roofline: its byte stream split
    into **weights** (the per-tick sweep of the matmul weights), **KV** (the
    live attention read stream) and **activations** (estimated), against
    the card's ridge point.  ``projected_tick_s`` (total bytes over peak
    bandwidth) is the memory-bound floor of one tick."""
    total = float(weight_bytes) + float(kv_bytes) + float(act_bytes)
    row = roofline(flops if flops else None, total if total else None, device_kind,
                   name="decode_tick")
    peak_bw = row["peak_hbm_bytes_per_sec"]
    row.update(
        {
            "weight_bytes": int(weight_bytes),
            "kv_bytes": int(kv_bytes),
            "act_bytes": int(act_bytes),
            "weight_frac": round(weight_bytes / total, 4) if total else None,
            "projected_tick_s": round(total / peak_bw, 9) if peak_bw and total else None,
        }
    )
    return row
