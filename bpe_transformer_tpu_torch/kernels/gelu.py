"""Tanh-approximation GeLU (port of
``bpe_transformer_tpu/kernels/pallas/gelu.py::gelu`` and its custom JVP).

Elementwise on any shape, float32 or bfloat16.  The forward is the JAX
kernel's formula with its clamp (``exp`` of more than ``2 * 44`` overflows
float32, while ``tanh`` has saturated long before ``2u = 30``)::

    u = 0.79788456 * (x + 0.044715 * x * x * x)
    e = exp(min(2 u, 30));  tanh = (e - 1) / (e + 1)
    y = 0.5 * x * (1 + tanh)

and the backward is the JAX package's ``_gelu_jvp``, which takes ``tanh``
itself::

    dx = g * (0.5 (1 + t) + 0.5 x (1 - t t) * 0.79788456 (1 + 3 * 0.044715 x x)),
    t = tanh(u)

Both compute in float32 and round once to ``x``'s dtype, as the TPU's
vector unit does; the JAX package's interpret mode on bfloat16 input rounds
after every operation instead, which the port does not copy.

:func:`gelu` is :class:`GeLU`: its forward launches the forward kernel of
``csrc/gelu.cu`` for CUDA tensors and runs :func:`gelu_plain` for CPU
tensors; its backward launches the backward kernel of the same file (one
launch where eager PyTorch would run about ten) or runs
:func:`gelu_bwd_plain`.  Launches are counted in ``kernels/_build.py`` under
``gelu`` and ``gelu_bwd``.
"""

from __future__ import annotations

import torch

from bpe_transformer_tpu_torch.kernels import _build

_SQRT_2_OVER_PI = 0.79788456
_C = 0.044715
#: The C entry points take the element count as an int, with room for the
#: 32-bit index of a chunk's last vector past the end (csrc/gelu.cu MAX_N).
_MAX_ELEMS = 2**31 - 1 - 4 * 256 * 8


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """The forward in float32, in the JAX expression's order of association
    (``((c x) x) x``), rounded once to ``x``'s dtype."""
    x32 = x.float()
    inner = _SQRT_2_OVER_PI * (x32 + _C * x32 * x32 * x32)
    e = torch.exp(torch.clamp(2.0 * inner, max=30.0))
    tanh = (e - 1.0) / (e + 1.0)
    return (0.5 * x32 * (1.0 + tanh)).to(x.dtype)


def gelu_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` times the closed-form derivative at ``x`` (``_gelu_jvp``), in
    float32, rounded once to ``x``'s dtype."""
    x32, g32 = x.float(), g.float()
    u = _SQRT_2_OVER_PI * (x32 + _C * x32 * x32 * x32)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _C * x32 * x32)
    grad = 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * du
    return (grad * g32).to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t  # a view may start unaligned


def _launch(symbol: str, name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Launch ``symbol`` of ``csrc/gelu.cu`` on the contiguous ``inputs``
    (all of one shape and dtype) into a new tensor of that shape."""
    inputs = tuple(_aligned(t) for t in inputs)
    out = torch.empty_like(inputs[0])
    n = out.numel()
    if n > _MAX_ELEMS:
        raise ValueError(f"{name}: {n} elements, the kernel takes at most {_MAX_ELEMS}")
    if n == 0:
        return out
    code, stream = _build.kernel_args(name, *inputs, out)
    fn = _build.entry("gelu", symbol, len(inputs) + 1, 1)
    rc = fn(code, *(t.data_ptr() for t in inputs), out.data_ptr(), n, stream)
    _build.check(rc, name)
    _build.count(name)
    return out


def _gelu_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel for CUDA tensors, :func:`gelu_plain` for CPU
    tensors."""
    if x.device.type == "cpu":
        return gelu_plain(x)
    return _launch("gelu_launch", "gelu", x)


def _gelu_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel for CUDA tensors, :func:`gelu_bwd_plain` for CPU
    tensors."""
    if x.shape != g.shape:
        raise ValueError(f"gelu_bwd: x {tuple(x.shape)} and g {tuple(g.shape)} differ")
    if x.device.type == "cpu":
        return gelu_bwd_plain(x, g)
    return _launch("gelu_bwd_launch", "gelu_bwd", x, g)


class GeLU(torch.autograd.Function):
    """GeLU forward (kernel) with the closed-form backward (kernel)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _gelu_backward(x, g)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximation GeLU, differentiable (:class:`GeLU`)."""
    return GeLU.apply(x)
