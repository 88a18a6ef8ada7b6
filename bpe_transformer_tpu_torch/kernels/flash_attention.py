"""Causal flash attention, forward and backward, with and without RoPE in the
kernel (port of ``bpe_transformer_tpu/kernels/pallas/flash_attention.py``:
``flash_attention`` with its FA-2 custom VJP, and
``flash_attention_with_rope``).

``q, k, v`` are ``(..., seq, d_head)`` with any leading dims (batch, heads);
the result has ``q``'s shape and dtype.  Only ``causal=True`` is ported (the
only form the model calls).

* :func:`flash_attention` launches ``csrc/flash_attention.cu``.  When a
  gradient is wanted it goes through :class:`FlashAttention`, whose forward
  also writes the row logsumexp and whose backward launches the two kernels
  of ``csrc/flash_attention_bwd.cu`` (dK/dV, then dQ); it saves what the JAX
  custom VJP saves, ``(q, k, v, out, lse)``, so the attention forward never
  re-runs for its backward.  Without a gradient (serving) no lse is written.
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
and ``flash_attention_bwd_dq``.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.ops.core import MASK_VALUE
from bpe_transformer_tpu_torch.ops.rope import apply_rope

#: Head dims the kernels are instantiated for.
HEAD_DIMS = (16, 32, 64, 128)


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


def _bwd_plain(q, k, v, out, lse, g):
    """P and dS of the backward kernels with materialized float32 scores."""
    q32 = q.float() * q.shape[-1] ** -0.5
    k32, v32, g32 = k.float(), v.float(), g.float()
    s = q.shape[-2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.matmul(q32, k32.transpose(-1, -2))
    p = torch.exp(scores - lse.reshape(q.shape[:-1])[..., None]).masked_fill(~keep, 0.0)
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(g32, v32.transpose(-1, -2)) - delta)
    return q32, k32, g32, p, ds


def flash_attention_bwd_dkdv_plain(q, k, v, out, lse, g):
    """The dK/dV kernel's arithmetic in plain torch: ``(dk, dv)`` from the
    forward's residuals (``lse`` of any shape holding ``q.shape[:-1]``
    values) and the upstream gradient ``g``."""
    q32, _, g32, p, ds = _bwd_plain(q, k, v, out, lse, g)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, out, lse, g):
    """The dQ kernel's arithmetic in plain torch."""
    _, k32, _, _, ds = _bwd_plain(q, k, v, out, lse, g)
    return (torch.matmul(ds, k32) * q.shape[-1] ** -0.5).to(q.dtype)


def _geometry(q, k, v) -> tuple[int, int, int]:
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    *batch, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"d_head={d} unsupported by the kernel {HEAD_DIMS}")
    bh = 1
    for dim in batch:
        bh *= dim
    return bh, s, d


def _forward(q, k, v, cos=None, sin=None, with_lse: bool = False):
    """Launch the forward kernel on contiguous CUDA tensors; returns
    ``(out, lse)`` (``lse`` None unless ``with_lse``)."""
    bh, s, d = _geometry(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) if with_lse else None
    tables = ()
    if cos is not None:
        if cos.shape != (s, d // 2) or sin.shape != (s, d // 2):
            raise ValueError(
                f"cos/sin must be gathered at the token positions to (seq, d//2) = "
                f"{(s, d // 2)}, got {tuple(cos.shape)} / {tuple(sin.shape)}"
            )
        cos, sin = cos.float().contiguous(), sin.float().contiguous()
        tables = (cos, sin)
    name = "flash_attention_rope" if tables else "flash_attention"
    code, stream = _build.kernel_args(
        name, q, k, v, out, f32=tables + ((lse,) if with_lse else ())
    )
    fn = _build.entry("flash_attention", "flash_attention_launch", 7, 3)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(cos), ptr(sin),
        out.data_ptr(), ptr(lse), bh, s, d, stream,
    )
    _build.check(rc, name)
    _build.count(name)
    return out, lse


def _launch_bwd(which: str, q, k, v, g, lse, delta):
    """Launch one backward kernel (``"dkdv"`` -> ``(dk, dv)``, ``"dq"`` ->
    ``dq``) on contiguous CUDA tensors of one geometry."""
    bh, s, d = _geometry(q, k, v)
    name = f"flash_attention_bwd_{which}"
    if which == "dkdv":
        grads = (torch.empty_like(k), torch.empty_like(v))
    else:
        grads = (torch.empty_like(q),)
    code, stream = _build.kernel_args(name, q, k, v, g, *grads, f32=(lse, delta))
    fn = _build.entry("flash_attention_bwd", f"{name}_launch", 6 + len(grads), 3)
    rc = fn(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in grads), bh, s, d, stream,
    )
    _build.check(rc, name)
    _build.count(name)
    return grads


def _backward(q, k, v, out, lse, g):
    """dq, dk, dv from the forward's residuals through the two backward
    kernels.  ``delta = rowsum(dO * O)`` is one plain float32 reduction, as
    it is one XLA pass in the JAX package."""
    g = g.contiguous()
    delta = (g.float() * out.float()).sum(-1).reshape(lse.shape).contiguous()
    dk, dv = _launch_bwd("dkdv", q, k, v, g, lse, delta)
    (dq,) = _launch_bwd("dq", q, k, v, g, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal flash attention on the card with the FA-2 backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return _backward(*ctx.saved_tensors, g)


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
    """Causal attention over the last two axes: the CUDA kernels for CUDA
    tensors, :func:`flash_attention_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if not causal:
        raise NotImplementedError("the flash kernel is ported for causal=True only")
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v)[0]


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
