"""The decode tick's tail and the speculative verify tail, fused (port of
``bpe_transformer_tpu/kernels/pallas/sample.py``).

Unfused, a tick ends with the head projection to ``(rows, vocab)`` float32
logits, ``serving.engine.filter_logits`` (two full sorts for runtime top-k
and top-p) and a gumbel argmax.  :func:`fused_head_sample` does the same in
two launches of ``csrc/sample.cu``: a hand-written head projection into a
float32 logit workspace (on the tensor cores where :func:`head_path` says
so), then one thread block cluster per row (:func:`finalize_geometry`) that
filters by a sort-free radix select over the row's keys and samples.
:func:`fused_verify_head` is the speculative-decoding verify tail
(``serving/spec/engine.py``): per row the raw-argmax token, the filtered
target probability ``p_d`` of the judged draft token, and a sample of the
residual ``max(p - q, 0)``.

``head`` is the LM head, a ``(vocab, d)`` tensor or the int8 dict of
``ops/quant.py``; knobs are ``(rows,)`` tensors (``temps`` 0 = greedy,
``top_ks`` 0 = disabled, ``top_ps`` >= 1 disabled).  ``gumbel`` ``(rows,
vocab)`` is the caller's noise, so the fused and unfused tails take the same
draws; greedy rows take the raw argmax and read no noise.

The wrappers launch the kernels for CUDA tensors (raising if the build or the
launch fails) and run :func:`fused_head_sample_plain` /
:func:`fused_verify_head_plain` for CPU tensors.  ``logits_out``, a
``(rows, vocab)`` float32 tensor, receives the projected logits (an engine
allocates it once; without it the wrapper allocates one).  Launches are
counted in ``kernels/_build.py`` under ``fused_head_sample`` and
``fused_verify_head``.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.kernels.quant_matmul import _sm_count
from bpe_transformer_tpu_torch.ops.core import head_logits
from bpe_transformer_tpu_torch.serving.engine import filter_logits, sample_tokens


#: Blocks a row's finalize cluster may have (the portable cluster size).
MAX_CLUSTER = 8


def head_path(x_dtype, head_dtype, d: int) -> str:
    """The projection a call runs: ``"tensor_cores"`` for bf16 hidden rows
    against a bf16 or int8 head when ``d`` is a multiple of 16 (rows TMA can
    describe), else ``"cuda_cores"`` (float32 rows, which keep float32
    accuracy, and a float32 head, which the CUDA-core kernel rounds to bf16
    as it loads it)."""
    if x_dtype == torch.bfloat16 and head_dtype in (torch.bfloat16, torch.int8) and d % 16 == 0:
        return "tensor_cores"
    return "cuda_cores"


def head_tile_rows(rows: int) -> int:
    """Hidden rows a tensor-core projection block takes: ``rows`` rounded up
    to a multiple of 8 (the wgmma's N), at most 64 (more rows run 64-row
    tiles side by side)."""
    return min(64, -(-rows // 8) * 8)


def finalize_geometry(rows: int, vocab: int, sms: int) -> tuple[int, int]:
    """``(cluster, chunk)`` of the finalize launch: each row's cluster of
    blocks, as many as keep ``rows * cluster`` within two blocks on each of
    the card's ``sms`` SMs (1 to :data:`MAX_CLUSTER`), and the columns each
    block owns.  At 40 rows one block an SM finishes top-k rows faster but
    top-p-only rows much slower than two (PERF.md, B10)."""
    cluster = max(1, min(MAX_CLUSTER, 2 * sms // rows, vocab))
    chunk = -(-vocab // cluster)
    return -(-vocab // chunk), chunk  # no block without a column


def verify_rows(logits, temps, top_ks, top_ps, judge, q, gumbel):
    """The plain verify math on ``(rows, vocab)`` logits: ``(greedy, p_d,
    bonus)``.  ``p`` is the softmax of the filtered logits (the exact
    one-hot of the raw argmax for greedy rows), ``p_d = p[judge]``, and the
    bonus samples the residual ``max(p - q, 0)`` (``p`` itself when it has
    no mass) by gumbel argmax, or takes its argmax for greedy rows."""
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    sampled = (temps > 0.0)[:, None]
    p_soft = torch.softmax(filter_logits(logits, temps, top_ks, top_ps), dim=-1)
    p = torch.where(sampled, p_soft, torch.nn.functional.one_hot(greedy, vocab).to(p_soft.dtype))
    p_d = torch.gather(p, 1, judge.long()[:, None])[:, 0]
    res = torch.clamp(p - q.float(), min=0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0, res, p)
    log_res = torch.where(res > 0, torch.log(res), float("-inf"))
    bonus = torch.where(sampled[:, 0], torch.argmax(log_res + gumbel, dim=-1),
                        torch.argmax(res, dim=-1))
    return greedy, p_d, bonus


def fused_head_sample_plain(hidden, head, temps, top_ks, top_ps, gumbel) -> torch.Tensor:
    """``head_logits`` -> ``filter_logits`` -> gumbel argmax / raw argmax
    (``serving.engine.sample_tokens``)."""
    return sample_tokens(head_logits(hidden, head), gumbel, temps, top_ks, top_ps)


def fused_verify_head_plain(hidden, head, temps, top_ks, top_ps, judge, q, gumbel):
    """``head_logits`` -> :func:`verify_rows`."""
    return verify_rows(head_logits(hidden, head), temps, top_ks, top_ps, judge, q, gumbel)


def _head_operands(head, vocab: int, d: int):
    """``(values, scale or None, head dtype code)``, checked."""
    if isinstance(head, dict):
        q, scale = head["q"], head["scale"]
        if q.shape != (vocab, d) or scale.shape != (vocab,):
            raise ValueError(
                f"quantized head q {tuple(q.shape)} / scale {tuple(scale.shape)} must be "
                f"({vocab}, {d}) / ({vocab},)"
            )
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(
                f"quantized head must be int8 + float32, got {q.dtype} / {scale.dtype}"
            )
        return q, scale, _build.INT8_CODE
    if head.shape != (vocab, d):
        raise ValueError(f"head {tuple(head.shape)} must be ({vocab}, {d})")
    code = _build.DTYPE_CODES.get(head.dtype)
    if code is None:
        raise ValueError(f"head dtype {head.dtype} unsupported (float32, bfloat16, int8 dict)")
    return head, None, code


def _launch(name, hidden, head, temps, top_ks, top_ps, ins, outs, logits_out):
    """Check the operands and launch ``csrc/sample.cu``'s ``name``: ``ins``
    are the per-row inputs after the knobs (verify's int32 judge, then the
    float32 ``(rows, vocab)`` tensors, the gumbel noise last), ``outs`` the
    outputs, in the C entry point's order."""
    rows, d = hidden.shape
    vocab = ins[-1].shape[-1]
    hq, scale, head_code = _head_operands(head, vocab, d)
    tensor_cores = head_path(hidden.dtype, hq.dtype, d) == "tensor_cores"
    cluster, chunk = finalize_geometry(rows, vocab, _sm_count(hidden.device))
    if logits_out is None:
        logits_out = torch.empty((rows, vocab), dtype=torch.float32, device=hidden.device)
    if logits_out.shape != (rows, vocab):
        raise ValueError(f"logits_out {tuple(logits_out.shape)} must be ({rows}, {vocab})")
    if any(t.shape[0] != rows for t in ins):
        raise ValueError(f"{name}: per-row inputs {[tuple(t.shape) for t in ins]} for {rows} rows")
    hidden = hidden.contiguous()
    if hidden.data_ptr() % 16:
        hidden = hidden.clone()  # a row view of a larger tensor may start unaligned
    knobs = (temps.to(torch.float32).contiguous(), top_ks.to(torch.int32).contiguous(),
             top_ps.to(torch.float32).contiguous())
    ptrs = (hidden, hq, scale, *knobs, *ins, logits_out, *outs)
    rest = ptrs[3:]
    code, stream = _build.kernel_args(
        name, hidden,
        f32=(() if scale is None else (scale,)) + tuple(t for t in rest if t.is_floating_point()),
        others=(hq,) + tuple(t for t in rest if not t.is_floating_point()),
    )
    fn = _build.entry("sample", f"{name}_launch", len(ptrs), 7)
    rc = fn(code, *(None if t is None else t.data_ptr() for t in ptrs), head_code, rows, vocab,
            d, head_tile_rows(rows) if tensor_cores else 0, cluster, chunk, stream)
    _build.check(rc, name)
    _build.count(name)


def fused_head_sample(hidden, head, temps, top_ks, top_ps, gumbel, *, logits_out=None):
    """One token per row of ``hidden (rows, d)`` (int64, see module
    docstring): the CUDA kernels for CUDA tensors,
    :func:`fused_head_sample_plain` for CPU tensors."""
    if hidden.device.type == "cpu":
        logits = head_logits(hidden, head)
        if logits_out is not None:
            logits_out.copy_(logits)
        return sample_tokens(logits, gumbel, temps, top_ks, top_ps)
    tokens = torch.empty(hidden.shape[0], dtype=torch.int64, device=hidden.device)
    _launch("fused_head_sample", hidden, head, temps, top_ks, top_ps,
            (gumbel.to(torch.float32).contiguous(),), (tokens,), logits_out)
    return tokens


def fused_verify_head(hidden, head, temps, top_ks, top_ps, judge, q, gumbel, *,
                      logits_out=None):
    """``(greedy, p_d, bonus)`` for the verify rows ``hidden (rows, d)``
    (rows = slots * (K+1), slot-major), ``judge (rows,)`` the draft token
    each row judges, ``q`` and ``gumbel`` ``(rows, vocab)``: the CUDA kernels
    for CUDA tensors, :func:`fused_verify_head_plain` for CPU tensors."""
    if hidden.device.type == "cpu":
        logits = head_logits(hidden, head)
        if logits_out is not None:
            logits_out.copy_(logits)
        return verify_rows(logits, temps, top_ks, top_ps, judge, q, gumbel)
    rows, dev = hidden.shape[0], hidden.device
    greedy = torch.empty(rows, dtype=torch.int64, device=dev)
    p_d = torch.empty(rows, dtype=torch.float32, device=dev)
    bonus = torch.empty(rows, dtype=torch.int64, device=dev)
    ins = (judge.to(torch.int32).contiguous(), q.to(torch.float32).contiguous(),
           gumbel.to(torch.float32).contiguous())
    _launch("fused_verify_head", hidden, head, temps, top_ks, top_ps, ins, (greedy, p_d, bonus),
            logits_out)
    return greedy, p_d, bonus
