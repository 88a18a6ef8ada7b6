"""Byte-pair-encoding tokenizer: encode/decode + bounded-memory streaming (the
port's copy of ``bpe_transformer_tpu/tokenization/tokenizer.py``, pure-Python
encode path only: the JAX package's native C++ encoder has no port yet).

Behavioral parity targets (all host CPU):

* id-level equality with ``tiktoken.get_encoding("gpt2")`` when loaded from
  the GPT-2 vocab/merges artifacts (pinned by the reference's tokenizer test
  suite, ``tests/test_tokenizer.py:88-413``);
* special tokens are never split and map straight to their vocab id, with
  longer specials winning over overlapping shorter ones;
* ``encode_iterable`` streams a file handle with bounded memory (the
  reference enforces <1 MB address-space growth on a 5 MB corpus,
  `test_tokenizer.py:416-429`).

Design: instead of the reference's per-pass rescan of the merge list
(`bpe_tokenizer.py:209-290`), merges are compiled once into a rank table over
*id pairs*; each pre-token then repeatedly applies its lowest-rank adjacent
pair (earliest position on ties), which is the same greedy order at much
lower cost.  The per-pretoken memo cache is bounded so streaming encodes
cannot grow without limit (the reference's cache is unbounded).
"""

from __future__ import annotations

import pickle
from abc import ABC, abstractmethod
from collections.abc import Iterable, Iterator
import multiprocessing
from pathlib import Path

from bpe_transformer_tpu_torch.settings import ENCODING
from bpe_transformer_tpu_torch.tokenization.pretokenization import (
    iter_pretoken_strings,
    split_on_special_tokens,
)

_REPLACEMENT = "�".encode(ENCODING)

# Per-process tokenizer for Pool workers: the parent pickles the tokenizer
# ONCE per worker (initializer) instead of once per task, so each worker
# builds its merge tables a single time and reuses them.
_WORKER_TOKENIZER: "BPETokenizer | None" = None


def _stream_worker_init(tokenizer: "BPETokenizer") -> None:
    global _WORKER_TOKENIZER
    _WORKER_TOKENIZER = tokenizer


def _stream_worker_encode(segment: str) -> list[int]:
    return _WORKER_TOKENIZER.encode(segment)


class Tokenizer(ABC):
    """Minimal tokenizer interface (mirrors the reference ABC,
    ``bpe_transformer/tokenization/tokenizer.py:6-31``)."""

    @property
    @abstractmethod
    def vocab(self) -> dict[int, bytes]: ...

    @property
    @abstractmethod
    def merges(self) -> list[tuple[bytes, bytes]]: ...

    @abstractmethod
    def encode(self, text: str) -> list[int]: ...

    @abstractmethod
    def encode_iterable(self, iterable: Iterable[str]) -> Iterator[int]: ...

    @abstractmethod
    def decode(self, ids: list[int]) -> str: ...


class BPETokenizer(Tokenizer):
    """Encode/decode text with a trained byte-level BPE vocabulary."""

    #: Memo-cache capacity (distinct pre-tokens).  Cleared when full so a
    #: pathological stream cannot grow the process footprint unboundedly.
    CACHE_CAPACITY = 50_000

    def __init__(
        self,
        vocab: dict[int, bytes],
        merges: list[tuple[bytes, bytes]],
        special_tokens: list[str] | None = None,
    ):
        self._vocab = vocab
        self._merges = merges
        self._special_tokens = list(dict.fromkeys(special_tokens or []))
        # Special tokens absent from the vocab get fresh ids at the end.
        present = set(vocab.values())
        for token in self._special_tokens:
            token_bytes = token.encode(ENCODING)
            if token_bytes not in present:
                vocab[len(vocab)] = token_bytes
                present.add(token_bytes)
        self._id_of: dict[bytes, int] = {v: k for k, v in vocab.items()}
        self._special_ids = {
            t: self._id_of[t.encode(ENCODING)] for t in self._special_tokens
        }

        # Compile merges to an id-pair rank table: (left_id, right_id) ->
        # (rank, merged_id).  Merges whose operands or result are absent from
        # the vocab can never apply and are dropped.
        self._pair_rank: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (left, right) in enumerate(merges):
            li = self._id_of.get(left)
            ri = self._id_of.get(right)
            mi = self._id_of.get(left + right)
            if li is None or ri is None or mi is None:
                continue
            self._pair_rank.setdefault((li, ri), (rank, mi))

        # Byte-value -> id table for seeding pre-tokens.
        self._byte_id = [self._id_of.get(bytes([b])) for b in range(256)]
        self._cache: dict[bytes, tuple[int, ...]] = {}

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cache"] = {}
        return state

    # ---------------------------------------------------------------- props

    @property
    def vocab(self) -> dict[int, bytes]:
        return self._vocab

    @property
    def merges(self) -> list[tuple[bytes, bytes]]:
        return self._merges

    @property
    def special_tokens(self) -> list[str]:
        return list(self._special_tokens)

    # ------------------------------------------------------------- loading

    @classmethod
    def from_files(
        cls,
        vocab_filepath: str | Path,
        merges_filepath: str | Path,
        special_tokens: list[str] | None = None,
    ) -> "BPETokenizer":
        """Build a tokenizer from pickled trainer artifacts.

        Special tokens missing from the stored vocab are appended at the end,
        as the reference loader does (`bpe_tokenizer.py:292-320`).
        """
        return cls(
            vocab=cls.load_vocab(vocab_filepath, special_tokens),
            merges=cls.load_merges(merges_filepath),
            special_tokens=special_tokens,
        )

    @staticmethod
    def load_vocab(
        file_path: str | Path, special_tokens: list[str] | None = None
    ) -> dict[int, bytes]:
        with open(file_path, "rb") as f:
            vocab: dict[int, bytes] = pickle.load(f)
        if special_tokens:
            present = set(vocab.values())
            for token in special_tokens:
                token_bytes = token.encode(ENCODING)
                if token_bytes not in present:
                    vocab[len(vocab)] = token_bytes
        return vocab

    @staticmethod
    def load_merges(file_path: str | Path) -> list[tuple[bytes, bytes]]:
        with open(file_path, "rb") as f:
            merges: list[tuple[bytes, bytes]] = pickle.load(f)
        return merges

    # ------------------------------------------------------------- encode

    def encode(self, text: str) -> list[int]:
        """Encode ``text`` into token ids (specials map directly)."""
        out: list[int] = []
        parts = split_on_special_tokens(text, self._special_tokens, training=False)
        for part in parts:
            if not part:
                continue
            special_id = self._special_ids.get(part)
            if special_id is not None:
                out.append(special_id)
                continue
            for pretoken in iter_pretoken_strings(part):
                out.extend(self._encode_pretoken(pretoken.encode(ENCODING)))
        return out

    def _encode_pretoken(self, pretoken: bytes) -> tuple[int, ...]:
        cached = self._cache.get(pretoken)
        if cached is not None:
            return cached

        byte_id = self._byte_id
        # Bytes absent from the vocab are skipped (the JAX package's policy
        # on both of its encode paths).
        ids = [i for b in pretoken if (i := byte_id[b]) is not None]
        rank_of = self._pair_rank
        while len(ids) > 1:
            # Lowest-rank adjacent pair wins; earliest position breaks ties.
            best_rank = None
            best_pos = -1
            merged_id = -1
            for i in range(len(ids) - 1):
                hit = rank_of.get((ids[i], ids[i + 1]))
                if hit is not None and (best_rank is None or hit[0] < best_rank):
                    best_rank, merged_id = hit
                    best_pos = i
            if best_pos < 0:
                break
            ids[best_pos : best_pos + 2] = (merged_id,)

        result = tuple(ids)
        if len(self._cache) >= self.CACHE_CAPACITY:
            self._cache.clear()
        self._cache[pretoken] = result
        return result

    # ------------------------------------------------------------- decode

    def decode(self, ids: list[int]) -> str:
        """Decode ids to text; unknown ids become U+FFFD."""
        vocab = self._vocab
        data = b"".join(vocab.get(i, _REPLACEMENT) for i in ids)
        return data.decode(ENCODING, errors="replace")

    # ----------------------------------------------------------- streaming

    def encode_iterable(
        self, iterable: Iterable[str], n_workers: int | None = None
    ) -> Iterator[int]:
        """Lazily encode a string iterable (e.g. a file handle).

        Buffers only up to the last newline, so memory stays bounded
        regardless of input size.  ``n_workers > 1`` fans complete lines out
        over a process pool.
        """
        if n_workers is None or n_workers <= 1:
            yield from self._encode_stream_serial(iterable)
        else:
            yield from self._encode_stream_parallel(iterable, n_workers)

    @staticmethod
    def _iter_segments(iterable: Iterable[str]) -> Iterator[str]:
        """Newline-bounded segments of a string stream.

        The single segmentation policy shared by every streaming encode path
        (serial, parallel) so they all emit identical token streams:
        buffer each incoming chunk and flush up to the last newline.
        """
        pending = ""
        for chunk in iterable:
            pending += chunk
            cut = pending.rfind("\n")
            if cut != -1:
                yield pending[: cut + 1]
                pending = pending[cut + 1 :]
        if pending:
            yield pending

    def _encode_stream_serial(self, iterable: Iterable[str]) -> Iterator[int]:
        for segment in self._iter_segments(iterable):
            yield from self.encode(segment)

    def _encode_stream_parallel(
        self, iterable: Iterable[str], n_workers: int
    ) -> Iterator[int]:
        batch: list[str] = []
        batch_size = n_workers * 10
        with multiprocessing.get_context("spawn").Pool(
            processes=n_workers,
            initializer=_stream_worker_init,
            initargs=(self,),
        ) as pool:
            for segment in self._iter_segments(iterable):
                batch.append(segment)
                if len(batch) >= batch_size:
                    for encoded in pool.map(_stream_worker_encode, batch, chunksize=5):
                        yield from encoded
                    batch = []
            if batch:
                for encoded in pool.map(_stream_worker_encode, batch, chunksize=5):
                    yield from encoded
