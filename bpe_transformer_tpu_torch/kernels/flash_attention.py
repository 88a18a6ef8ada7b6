"""Flash attention, forward and backward, causal or not, with and without
RoPE in the kernel (port of
``bpe_transformer_tpu/kernels/pallas/flash_attention.py``:
``flash_attention`` with its FA-2 custom VJP, ``flash_attention_with_rope``,
and the ring-attention interface ``flash_attention_with_lse`` and
``flash_attention_block_bwd``).

``q, k, v`` are ``(..., seq, d_head)`` with any leading dims (batch, heads);
the result has ``q``'s shape and dtype.  The kernels take any ``d_head``: it
is zero-padded to a launch width (:func:`padded_head_dim`: the next of 16,
32, 64, 128 and 256, or a multiple of 256 above) and sliced back, with the
softmax scale of the true ``d_head``.  Above 256 the kernels split the
output columns into chunks of 256 over a grid axis (:func:`_geometry`), so
their registers do not grow with the head dim.

The forward and the backward are bound by operations at training lengths.
In bf16 the forward runs on the tensor cores (``wgmma`` with TMA-fed K/V
tiles; a head below 64 is padded to 64, and RoPE keeps its rotated tiles as
a bf16 pair, high part and residual, so the scores stay at float32
accuracy), and so does the backward at widths 64 and 128
(:func:`backward_width`, :func:`backward_path`); in float32, which must keep
float32 accuracy, and in bf16 above width 128 (backward) or 256 (forward),
both run on the CUDA cores (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` say why and how).

* :func:`flash_attention` launches ``csrc/flash_attention.cu``.  When a
  gradient is wanted it goes through :class:`FlashAttention`, whose forward
  also writes the row logsumexp and whose backward launches the two kernels
  of ``csrc/flash_attention_bwd.cu`` (dK/dV, then dQ); it saves what the JAX
  custom VJP saves, ``(q, k, v, out, lse)``, so the attention forward never
  re-runs for its backward.  Without a gradient (serving) no lse is written.
* :func:`flash_attention_with_lse` is the forward with the row logsumexp,
  and :func:`flash_attention_block_bwd` one K/V block's partial
  ``(dq, dk, dv)`` given the GLOBAL output and logsumexp: the two calls the
  ring-flash schedules (``parallel/ring_attention.py``) make per ring step.
* :func:`flash_attention_rope` takes ``cos, sin`` tables ``(seq, d_head/2)``
  already gathered at the token positions and rotates q/k inside the forward
  kernel (:class:`FlashAttentionRope`).  Its backward is the JAX package's
  ``_flash_rope_bwd``: rotate q/k in plain torch, run the backward kernels,
  rotate dq/dk back with ``-sin``, and form the table gradients in plain
  torch.

For CPU tensors both run their plain versions (materialized float32 scores,
differentiated by autograd); for CUDA tensors they launch the kernels or
raise.  Launches are counted in ``kernels/_build.py`` under
``flash_attention``, ``flash_attention_rope``, ``flash_attention_bwd_dkdv``
and ``flash_attention_bwd_dq`` (causal), and ``flash_attention_nc``,
``flash_attention_bwd_dkdv_nc`` and ``flash_attention_bwd_dq_nc``
(non-causal).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.ops.core import MASK_VALUE
from bpe_transformer_tpu_torch.ops.rope import apply_rope

#: Register widths the kernels are instantiated for; a wider head runs at the
#: last of them in output-column chunks of that width.
HEAD_DIMS = (16, 32, 64, 128, 256)
COL_CHUNK = HEAD_DIMS[-1]
#: Narrowest width of the bf16 tensor-core kernels (one 128-byte row).
TC_MIN_WIDTH = 64
#: Widths of the bf16 tensor-core backward: at 256 its dK and dV
#: accumulators alone would take 256 registers a thread.
TC_BWD_WIDTHS = (64, 128)
#: Query tile of the tensor-core backward, whose lse and delta rows it
#: stages whole: rows are padded to a multiple of it (lse with a value that
#: makes every padded query's P exactly 0).
TC_BWD_TILE = 64
_LSE_PAD = 1e30


def padded_head_dim(d: int) -> int:
    """The width a head dim ``d`` runs at: the smallest of
    :data:`HEAD_DIMS` that holds it, or ``d`` rounded up to a multiple of
    :data:`COL_CHUNK` above the last."""
    if d < 1:
        raise ValueError(f"d_head={d} must be positive")
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // COL_CHUNK) * COL_CHUNK


def col_chunks(width: int) -> int:
    """Output-column chunks of a launch at ``width``: one up to
    :data:`COL_CHUNK`, ``width / COL_CHUNK`` above."""
    return max(1, width // COL_CHUNK)


def check_blocks(s: int, causal: bool, block_q: int, block_k: int) -> None:
    """The JAX package's block-size check of a non-causal call: ``seq``
    divisible by ``lcm(min(block_q, seq), min(block_k, seq))``.  The block
    sizes decide only this check; the CUDA tiling is the port's own."""
    block = math.lcm(min(block_q, s), min(block_k, s))
    if not causal and s % block:
        raise ValueError(
            f"non-causal flash attention requires seq ({s}) divisible by the block size "
            f"({block})"
        )


def flash_attention_plain(q, k, v, causal: bool = True, return_lse: bool = False):
    """Materialized-scores reference in float32 (the JAX package's
    ``_xla_attention`` oracle), cast to ``q``'s dtype; with ``return_lse``
    also the float32 row logsumexp of the scaled scores, shape
    ``(..., seq)``."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    scores = torch.matmul(q32, k32.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if causal:
        s = q.shape[-2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, MASK_VALUE)
    out = torch.matmul(torch.softmax(scores, dim=-1), v32).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_rope_plain(q, k, v, cos, sin, return_lse: bool = False):
    """The JAX package's ``_xla_rope_attention`` oracle: interleaved-pair
    RoPE on q/k in float32 with the position-gathered tables, then
    :func:`flash_attention_plain`; the result in ``q``'s dtype."""
    positions = torch.arange(q.shape[-2], device=q.device)
    qr = apply_rope(q.float(), positions, cos, sin)
    kr = apply_rope(k.float(), positions, cos, sin)
    res = flash_attention_plain(qr, kr, v.float(), True, return_lse)
    if return_lse:
        return res[0].to(q.dtype), res[1]
    return res.to(q.dtype)


def _bwd_plain(q, k, v, out, lse, g, causal: bool):
    """P and dS of the backward kernels with materialized float32 scores."""
    q32 = q.float() * q.shape[-1] ** -0.5
    k32, v32, g32 = k.float(), v.float(), g.float()
    scores = torch.matmul(q32, k32.transpose(-1, -2))
    p = torch.exp(scores - lse.reshape(q.shape[:-1])[..., None])
    if causal:
        s = q.shape[-2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(g32, v32.transpose(-1, -2)) - delta)
    return q32, k32, g32, p, ds


def flash_attention_bwd_dkdv_plain(q, k, v, out, lse, g, causal: bool = True):
    """The dK/dV kernel's arithmetic in plain torch: ``(dk, dv)`` from the
    forward's residuals (``lse`` of any shape holding ``q.shape[:-1]``
    values) and the upstream gradient ``g``."""
    q32, _, g32, p, ds = _bwd_plain(q, k, v, out, lse, g, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, out, lse, g, causal: bool = True):
    """The dQ kernel's arithmetic in plain torch."""
    _, k32, _, _, ds = _bwd_plain(q, k, v, out, lse, g, causal)
    return (torch.matmul(ds, k32) * q.shape[-1] ** -0.5).to(q.dtype)


def _geometry(q, k, v) -> tuple[int, int, int, int]:
    """``(bh, s, width, chunks)`` of a launch on q/k/v of one shape whose
    head dim is a launch width (:func:`padded_head_dim`), with its
    output-column chunks (:func:`col_chunks`)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    *batch, s, d = q.shape
    if padded_head_dim(d) != d:
        raise ValueError(f"d_head={d} is not a launch width (see padded_head_dim)")
    return math.prod(batch), s, d, col_chunks(d)


def _pad_head(x, width: int):
    """``x`` contiguous, zero-padded on the last dim to ``width``."""
    d = x.shape[-1]
    return (x if d == width else F.pad(x, (0, width - d))).contiguous()


def _name(base: str, causal: bool) -> str:
    return base if causal else f"{base}_nc"


def forward_width(d: int, dtype) -> int:
    """The width the forward kernel runs a head dim ``d`` at: bf16 takes the
    tensor cores from :data:`TC_MIN_WIDTH` up."""
    width = padded_head_dim(d)
    if dtype == torch.bfloat16:
        width = max(width, TC_MIN_WIDTH)
    return width


def backward_width(d: int, dtype) -> int:
    """The width the backward kernels run a head dim ``d`` at: as the
    forward (:func:`forward_width`), bf16 from :data:`TC_MIN_WIDTH` up."""
    return forward_width(d, dtype)


def backward_path(width: int, dtype) -> str:
    """The design the backward kernels run at a launch ``width``:
    ``"tensor_cores"`` for bf16 at :data:`TC_BWD_WIDTHS`, else
    ``"cuda_cores"`` (float32 at every width, bf16 from 256 up)."""
    if dtype == torch.bfloat16 and width in TC_BWD_WIDTHS:
        return "tensor_cores"
    return "cuda_cores"


def _forward(q, k, v, cos=None, sin=None, with_lse: bool = False, causal: bool = True):
    """Launch the forward kernel on CUDA tensors of any head dim
    (zero-padded to :func:`forward_width` for the launch); returns
    ``(out, lse)`` (``lse`` None unless ``with_lse``, else float32
    ``(bh, seq)``)."""
    d = q.shape[-1]
    width = forward_width(d, q.dtype)
    q, k, v = (_pad_head(t, width) for t in (q, k, v))
    bh, s, _, _ = _geometry(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) if with_lse else None
    tables = ()
    if cos is not None:
        if not causal:
            raise ValueError("RoPE in the kernel is causal only")
        if cos.shape != (s, d // 2) or sin.shape != (s, d // 2):
            raise ValueError(
                f"cos/sin must be gathered at the token positions to (seq, d//2) = "
                f"{(s, d // 2)}, got {tuple(cos.shape)} / {tuple(sin.shape)}"
            )
        # Pairs are interleaved, so whole pairs pad at the end: table column
        # i still rotates columns 2i, 2i+1 of the padded rows.
        cos, sin = (_pad_head(t.float(), width // 2) for t in (cos, sin))
        tables = (cos, sin)
    name = "flash_attention_rope" if tables else _name("flash_attention", causal)
    code, stream = _build.kernel_args(
        name, q, k, v, out, f32=tables + ((lse,) if with_lse else ())
    )
    fn = _build.entry("flash_attention", "flash_attention_launch", 7, 5)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(cos), ptr(sin),
        out.data_ptr(), ptr(lse), bh, s, width, d, int(causal), stream,
    )
    _build.check(rc, name)
    _build.count(name)
    if width != d:
        out = out[..., :d].contiguous()
    return out, lse


def _bwd_stats(lse, delta, bh: int, s: int, width: int, dtype):
    """lse and delta as contiguous ``(bh, rows)`` float32: ``rows`` is ``s``,
    or ``s`` padded to a multiple of :data:`TC_BWD_TILE` for the tensor
    cores (lse padded with a value whose ``exp(score - lse)`` is 0, delta
    with 0).  No copy when ``s`` is already a multiple."""
    lse, delta = lse.reshape(bh, s), delta.reshape(bh, s)
    pad = -s % TC_BWD_TILE if backward_path(width, dtype) == "tensor_cores" else 0
    if pad:
        lse = F.pad(lse, (0, pad), value=_LSE_PAD)
        delta = F.pad(delta, (0, pad))
    return lse.contiguous(), delta.contiguous()


def _launch_bwd(which: str, q, k, v, g, lse, delta, causal: bool = True, d: int | None = None):
    """Launch one backward kernel (``"dkdv"`` -> ``(dk, dv)``, ``"dq"`` ->
    ``dq``) on contiguous CUDA tensors of one geometry whose head dim is a
    launch width; ``d`` is the true head dim (the softmax scale's) when the
    tensors are zero-padded past it.  The design is
    :func:`backward_path`'s."""
    bh, s, width, _ = _geometry(q, k, v)
    name = _name(f"flash_attention_bwd_{which}", causal)
    lse, delta = _bwd_stats(lse, delta, bh, s, width, q.dtype)
    if which == "dkdv":
        grads = (torch.empty_like(k), torch.empty_like(v))
    else:
        grads = (torch.empty_like(q),)
    code, stream = _build.kernel_args(name, q, k, v, g, *grads, f32=(lse, delta))
    fn = _build.entry("flash_attention_bwd", f"flash_attention_bwd_{which}_launch",
                      6 + len(grads), 6)
    rc = fn(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in grads), bh, s, width, d or width,
        lse.shape[1], int(causal), stream,
    )
    _build.check(rc, name)
    _build.count(name)
    return grads


def _backward(q, k, v, out, lse, g, causal: bool = True):
    """dq, dk, dv from the forward's residuals through the two backward
    kernels (head dims padded to :func:`backward_width`).  ``delta =
    rowsum(dO * O)`` is one plain float32 reduction, as it is one XLA pass
    in the JAX package."""
    d = q.shape[-1]
    width = backward_width(d, q.dtype)
    delta = (g.float() * out.float()).sum(-1)
    q, k, v, g = (_pad_head(t, width) for t in (q, k, v, g))
    dk, dv = _launch_bwd("dkdv", q, k, v, g, lse, delta, causal, d)
    (dq,) = _launch_bwd("dq", q, k, v, g, lse, delta, causal, d)
    if width != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention on the card with the FA-2 backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, with_lse=True, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_backward(*ctx.saved_tensors, g, ctx.causal), None)


def _table_grads(x, dxr):
    """cos/sin gradients of the elementwise rotation ``x -> x_rot`` given
    ``dL/dx_rot``, summed over the leading (batch, head) dims."""
    x, dxr = x.float(), dxr.float()
    xe, xo = x[..., 0::2], x[..., 1::2]
    ge, go = dxr[..., 0::2], dxr[..., 1::2]
    dims = tuple(range(x.ndim - 2))
    return (ge * xe + go * xo).sum(dims), (go * xe - ge * xo).sum(dims)


class FlashAttentionRope(torch.autograd.Function):
    """Flash attention with RoPE inside the forward kernel; the backward
    rotates in plain torch around the FA-2 kernels (JAX's
    ``_flash_rope_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, cos, sin, with_lse=True)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        positions = torch.arange(q.shape[-2], device=q.device)
        qr = apply_rope(q.float(), positions, cos, sin).to(q.dtype)
        kr = apply_rope(k.float(), positions, cos, sin).to(k.dtype)
        dqr, dkr, dv = _backward(qr, kr, v, out, lse, g)
        dq = apply_rope(dqr.float(), positions, cos, -sin).to(q.dtype)
        dk = apply_rope(dkr.float(), positions, cos, -sin).to(k.dtype)
        dcos = dsin = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            dcq, dsq = _table_grads(q, dqr)
            dck, dsk = _table_grads(k, dkr)
            dcos, dsin = (dcq + dck).to(cos.dtype), (dsq + dsk).to(sin.dtype)
        return dq, dk, dv, dcos, dsin


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention over the last two axes: the CUDA kernels for CUDA tensors,
    :func:`flash_attention_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal=causal)[0]


def flash_attention_with_lse(q, k, v, causal: bool, block_q: int = 256, block_k: int = 256):
    """Forward and per-row logsumexp ``(out, lse)``, ``lse`` float32 of shape
    ``(..., seq)``: the statistic a ring caller merges partial outputs of
    visiting K/V shards by.  Forward only (the ring owns the backward).
    A non-causal call needs ``seq`` divisible by the block sizes, as in the
    JAX package (:func:`check_blocks`)."""
    *batch, s, _ = q.shape
    check_blocks(s, causal, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_lse=True)
    out, lse = _forward(q, k, v, with_lse=True, causal=causal)
    return out, lse.reshape(*batch, s)


def flash_attention_block_bwd(q, k, v, out, lse, g, causal: bool, block_q: int = 256,
                              block_k: int = 256):
    """Partial ``(dq, dk, dv)`` of one visiting K/V block given the GLOBAL
    forward output ``out`` and logsumexp ``lse`` (``(..., seq)``): the
    recomputed ``exp(s_blk - lse)`` are the block's true attention weights,
    so the results are its additive contributions (the ring-flash backward).
    ``q`` and ``k``/``v`` share one shard shape, whose ``seq`` must divide by
    the block sizes (the JAX package's check, causal or not)."""
    s = q.shape[-2]
    if s % math.lcm(min(block_q, s), min(block_k, s)):
        raise ValueError(f"block backward needs seq ({s}) divisible by the block sizes")
    if q.device.type == "cpu":
        return (flash_attention_bwd_dq_plain(q, k, v, out, lse, g, causal),
                *flash_attention_bwd_dkdv_plain(q, k, v, out, lse, g, causal))
    return _backward(q, k, v, out, lse, g, causal)


def flash_attention_rope(q, k, v, cos, sin) -> torch.Tensor:
    """Causal attention with RoPE applied to q/k inside the kernel; ``cos,
    sin`` are ``(seq, d_head/2)`` table rows at the token positions.  The
    CUDA kernels for CUDA tensors, :func:`flash_attention_rope_plain` for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_rope_plain(q, k, v, cos, sin)
    if _wants_grad(q, k, v, cos, sin):
        return FlashAttentionRope.apply(q, k, v, cos, sin)
    return _forward(q, k, v, cos, sin)[0]
