"""Token datasets and batch sampling on the host (the port's own copy of
``bpe_transformer_tpu/data/dataset.py``: ``load_token_file``,
``check_dataset_geometry``, ``get_batch``, ``BatchPrefetcher``,
``BatchLoader`` and ``tokenize_to_memmap``; numpy only).

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


class BatchPrefetcher:
    """Lookahead pipeline for per-iteration batch construction.

    The training loop's host-side batch work per step — memmap window
    gather, numpy stacking/reshaping — is host time between the step's
    launches.  This prefetcher moves it onto a single worker thread: while
    the card runs step *i*, the worker is already sampling the batch for
    step *i+1*, so the main thread finds it ready and only pays the copy to
    the card.

    The worker stays torch-free: ``make_batch`` returns host (numpy) arrays
    and the copy to the card stays on the main thread, in the order of the
    loop's own launches on its stream.

    ``make_batch(iteration)`` must be a pure function of the iteration (the
    loop's per-iteration seeding makes it one), so prefetched batches are
    byte-identical to synchronously-built ones — determinism, resume, and
    the chaos harness's per-iteration faults are unaffected.  A worker
    exception (e.g. an injected dataset-read fault) surfaces on the main
    thread at the matching :meth:`get`.

    ``depth=0`` disables the thread entirely (synchronous fallback).
    """

    def __init__(self, make_batch, depth: int = 1):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._make = make_batch
        self._depth = depth
        self._pool = None
        if depth > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="batch-prefetch"
            )
        self._pending: dict[int, object] = {}

    def get(self, iteration: int):
        """The device batch for ``iteration``: the prefetched one when the
        worker built it, else built synchronously (first step, or after an
        :meth:`invalidate`)."""
        future = self._pending.pop(iteration, None)
        if future is not None:
            return future.result()
        return self._make(iteration)

    def schedule(self, iteration: int) -> None:
        """Start building ``iteration``'s batch in the background (no-op
        when disabled, already pending, or the pipeline is full)."""
        if (
            self._pool is None
            or iteration in self._pending
            or len(self._pending) >= self._depth
        ):
            return
        self._pending[iteration] = self._pool.submit(self._make, iteration)

    def invalidate(self, reraise: bool = False) -> None:
        """Drop every pending batch (rollback/seed-salt changes make them
        stale); in-flight work is drained first.

        ``reraise=True`` re-raises the first worker exception instead of
        discarding it — the rollback path uses this so a fault consumed by
        a prefetched-then-discarded batch (e.g. a fire-once injected
        dataset-read fault) still surfaces instead of vanishing with the
        pipeline.  The default (shutdown/close) swallows: a pending error
        for an iteration the run will never reach must not break a
        graceful exit."""
        pending, self._pending = self._pending, {}
        first_error: Exception | None = None
        for future in pending.values():
            try:
                future.result()
            except Exception as exc:  # noqa: BLE001 - optionally re-raised
                if first_error is None:
                    first_error = exc
        if reraise and first_error is not None:
            raise first_error

    def close(self) -> None:
        self.invalidate()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


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
