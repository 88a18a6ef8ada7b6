"""Ring transports for sequence parallelism (the port's counterpart of the
``seq`` axis of ``bpe_transformer_tpu/parallel/mesh.py``'s meshes, as the
ring schedules use it).

A transport is what the ring code in :mod:`parallel.ring_attention` needs
of the ring's ranks, and nothing more:

* ``size``: the number of ranks n on the ring;
* ``index(device)``: the ids of the ranks this process holds, a long tensor
  of shape ``(local,)`` (JAX's ``axis_index``);
* ``shift(x)``: ``x`` as each rank receives it from rank - 1, that is every
  rank sends its block to rank + 1 (JAX's ``ppermute(i -> i + 1)``).

Every tensor the ring code handles carries these ranks as a leading dim of
size ``local``, so rank masks built from ``index()`` broadcast against it and
the schedules are written once.  :class:`StackedRing` holds all n ranks on
one device (``local = n``), the counterpart of ``shard_map`` over a size-n
axis of one host's devices: its ``shift`` is a roll of the leading dim, and
a kernel call of the ring runs all n ranks' blocks in one launch.  A
process-group transport over ``torch.distributed`` (``local = 1``, ``shift``
a send to rank + 1 and a receive from rank - 1) implements the same three
members; it comes with the multi-GPU training slice.
"""

from __future__ import annotations

from typing import Protocol

import torch


class RingTransport(Protocol):
    size: int

    def index(self, device: torch.device | str | None = None) -> torch.Tensor: ...

    def shift(self, x: torch.Tensor) -> torch.Tensor: ...


class StackedRing:
    """All ``n`` ranks of the ring stacked on the leading dim of tensors on
    one device."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.size = n

    def index(self, device: torch.device | str | None = None) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.size:
            raise ValueError(
                f"leading dim {x.shape[0]} of a stacked ring tensor must be the ring "
                f"size {self.size}"
            )
        return torch.roll(x, 1, dims=0)
