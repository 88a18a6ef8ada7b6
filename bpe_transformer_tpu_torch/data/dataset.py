"""Token datasets and batch sampling on the host (the port's own copy of
``bpe_transformer_tpu/data/dataset.py``: ``load_token_file``,
``check_dataset_geometry``, ``get_batch``, ``BatchLoader`` and
``tokenize_to_memmap``; numpy only).

A tokenized corpus is a flat binary token file opened with ``np.memmap``;
the sampler gathers ``(B, ctx)`` windows at uniform random starts in
``[0, len - ctx)``, labels shifted by one.  The same generator state gives
the same batches as the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def tokenize_to_memmap(
    tokenizer,
    text_path: str | Path,
    out_path: str | Path,
    dtype: str = "uint16",
) -> np.ndarray:
    """Stream-encode ``text_path`` and write a flat binary token file.

    ``uint16`` covers vocabularies up to 65,535 (all BASELINE configs);
    pass ``uint32`` beyond that.  Returns a read-only memmap of the result.
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    dt = np.dtype(dtype)
    vocab = getattr(tokenizer, "vocab", None)
    if vocab and max(vocab) > np.iinfo(dt).max:
        raise ValueError(
            f"vocab ids up to {max(vocab)} do not fit dtype {dt.name} "
            f"(max {np.iinfo(dt).max}); pass dtype='uint32'"
        )
    with open(text_path, encoding="utf-8") as src, open(out_path, "wb") as dst:
        # Written in runs of ~1M tokens, not a syscall per line.
        buffer: list[int] = []
        for token_id in tokenizer.encode_iterable(src):
            buffer.append(token_id)
            if len(buffer) >= 1 << 20:
                np.asarray(buffer, dtype=dt).tofile(dst)
                buffer.clear()
        if buffer:
            np.asarray(buffer, dtype=dt).tofile(dst)
    return load_token_file(out_path, dtype)


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
