"""Token datasets and batch sampling on the host (the port's own copy of
``bpe_transformer_tpu/data/dataset.py``: ``load_token_file``,
``check_dataset_geometry``, ``get_batch``, ``BatchLoader``; numpy only).

A tokenized corpus is a flat binary token file opened with ``np.memmap``;
the sampler gathers ``(B, ctx)`` windows at uniform random starts in
``[0, len - ctx)``, labels shifted by one.  The same generator state gives
the same batches as the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_token_file(path: str | Path, dtype: str = "uint16") -> np.ndarray:
    """Open a flat binary token file as a read-only memmap, refusing a
    missing, empty or odd-sized file with a clear message."""
    path = Path(path)
    dt = np.dtype(dtype)
    if not path.exists():
        raise FileNotFoundError(f"token file {path} does not exist")
    size = path.stat().st_size
    if size == 0:
        raise ValueError(
            f"token file {path} is empty — tokenization produced no output "
            "or the write was lost"
        )
    if size % dt.itemsize:
        raise ValueError(
            f"token file {path} is {size} bytes, not a multiple of the "
            f"{dt.itemsize}-byte dtype {dt.name} — truncated write or "
            "mismatched --dtype?"
        )
    return np.memmap(path, dtype=dt, mode="r")


def check_dataset_geometry(
    dataset: np.ndarray, context_length: int, batch_size: int, name: str = "dataset"
) -> None:
    """Fail fast when a token array cannot serve ``(batch_size,
    context_length)`` windows: it needs at least ``context_length + 1``
    tokens."""
    n = len(dataset)
    need = context_length + 1
    if n < need:
        raise ValueError(
            f"{name} holds {n} tokens but sampling batches of shape "
            f"({batch_size}, {context_length}) needs at least "
            f"context_length + 1 = {need} tokens — the token file is too "
            "short for this model's context (shrink context_length or "
            "tokenize more data)"
        )


def get_batch(
    dataset: np.ndarray,
    batch_size: int,
    context_length: int,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``(inputs, labels)`` of shape ``(B, ctx)`` (int64); only the
    sampled windows of a memmap are read."""
    if rng is None:
        rng = np.random.default_rng()
    n_starts = len(dataset) - context_length
    if n_starts <= 0:
        raise ValueError(
            f"dataset of {len(dataset)} tokens too short for context {context_length}"
        )
    starts = rng.integers(0, n_starts, size=batch_size)
    offsets = np.arange(context_length + 1)
    windows = np.asarray(dataset[starts[:, None] + offsets[None, :]], dtype=np.int64)
    return windows[:, :-1], windows[:, 1:]


class BatchLoader:
    """Seeded, stateful batch stream over a token array."""

    def __init__(self, dataset: np.ndarray, batch_size: int, context_length: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.context_length = context_length
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        return get_batch(self.dataset, self.batch_size, self.context_length, self._rng)
