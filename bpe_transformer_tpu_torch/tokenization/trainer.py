"""Greedy byte-pair-encoding trainer (host CPU; the port's copy of
``bpe_transformer_tpu/tokenization/trainer.py``).  With a C++ compiler on the
host the whole pipeline (scan, count, merge loop) runs in the port's native
engine (``native/``); the Python counting and merge path is the fallback
and gives the same vocabulary and merges.

Produces the same vocabulary and the same *ordered* merge list as the
reference trainer (``bpe_transformer/tokenization/bpe_trainer.py``), which
is pinned exactly by the reference's
``train-bpe-reference-merges.txt`` fixture:

* base vocab = 256 single bytes, then special tokens;
* at each step merge the adjacent pair with the highest total count, ties
  broken toward the lexicographically *greater* ``(bytes, bytes)`` pair;
* within a pre-token, occurrences merge leftmost-first and never overlap;
* a merge is only recorded if it actually applied somewhere.

The internal design is different from the reference: distinct pre-tokens are
stored once in an indexed word table with multiplicities, pair bookkeeping is
exact (full recount of a word's adjacent pairs on every rewrite, rather than
the reference's delta tracking), and the max-heap uses lazy invalidation via
a count check at pop time.
"""

from __future__ import annotations

import heapq
import os
import pickle
from collections import Counter
from pathlib import Path

from bpe_transformer_tpu_torch.settings import DEFAULT_OUTPUT_DIR, ENCODING
from bpe_transformer_tpu_torch.tokenization.pretokenization import (
    Pretoken,
    count_pretokens,
    split_on_special_tokens,
)

#: Streaming read size and the pending-buffer cap that triggers the exact
#: incremental add_prefix flush (module-level so tests can shrink them).
STREAM_CHUNK_CHARS = 1 << 22
PENDING_FLUSH_CHARS = 1 << 26

Pair = tuple[int, int]


class _HeapEntry:
    """Max-heap entry: most frequent pair first; on ties the pair whose
    ``(bytes, bytes)`` representation is lexicographically greater wins.

    ``pair_bytes`` is captured at push time; vocab entries are immutable once
    assigned, so the captured value never goes stale.
    """

    __slots__ = ("count", "pair", "pair_bytes")

    def __init__(self, count: int, pair: Pair, pair_bytes: tuple[bytes, bytes]):
        self.count = count
        self.pair = pair
        self.pair_bytes = pair_bytes

    def __lt__(self, other: "_HeapEntry") -> bool:
        if self.count != other.count:
            return self.count > other.count
        return self.pair_bytes > other.pair_bytes


def _merge_occurrences(word: list[int], a: int, b: int, z: int) -> list[int] | None:
    """Replace leftmost, non-overlapping ``(a, b)`` runs in ``word`` with ``z``.

    Returns the rewritten word, or None when the pair does not occur.
    """
    n = len(word)
    out: list[int] = []
    i = 0
    hit = False
    while i < n - 1:
        if word[i] == a and word[i + 1] == b:
            out.append(z)
            i += 2
            hit = True
        else:
            out.append(word[i])
            i += 1
    if not hit:
        return None
    if i == n - 1:
        out.append(word[-1])
    return out


class BPETrainer:
    """Train a byte-level BPE vocabulary on a text corpus.

    Same public surface as the reference trainer: ``vocab_size`` /
    ``special_tokens`` constructor, :meth:`train`, :attr:`vocab`,
    :attr:`merges`, :meth:`save_trainer`.
    """

    def __init__(self, vocab_size: int, special_tokens: list[str] | None = None):
        if vocab_size < 256:
            raise ValueError("Invalid vocab size: must be at least 256")
        self._target_vocab_size = vocab_size
        # Preserve caller order, dropping duplicates.
        self._special_tokens = list(dict.fromkeys(special_tokens or []))
        self._vocab: dict[int, bytes] = {i: bytes([i]) for i in range(256)}
        for offset, token in enumerate(self._special_tokens):
            self._vocab[256 + offset] = token.encode(ENCODING)
        self._merges: list[tuple[bytes, bytes]] = []

    # ------------------------------------------------------------------ API

    @property
    def vocab(self) -> dict[int, bytes]:
        return self._vocab

    @property
    def merges(self) -> list[tuple[bytes, bytes]]:
        return self._merges

    @property
    def special_tokens(self) -> list[str]:
        return self._special_tokens

    @property
    def vocab_size(self) -> int:
        return self._target_vocab_size

    def train(self, input_path: str | Path, n_workers: int | None = None) -> None:
        """Pre-tokenize ``input_path`` and learn merges to the target size.

        With a C++ toolchain the whole pipeline (scan, count, merge loop)
        runs natively, streaming the file in bounded-memory chunks; the
        Python counting + merge path is the fallback (``BT_NATIVE=0``
        selects it).
        """
        if self._train_native_file(input_path):
            return
        pretoken_counts = count_pretokens(
            input_path,
            self._special_tokens,
            training=True,
            n_workers=n_workers,
        )
        self.train_from_pretokens(pretoken_counts)

    def _train_native_file(self, input_path: str | Path) -> bool:
        """Stream-count + train via the C++ engine; False when unavailable."""
        if os.environ.get("BT_NATIVE", "1") == "0":
            return False
        try:
            from bpe_transformer_tpu_torch.native import engine as native_engine

            if not native_engine.is_available():
                return False
            counter = native_engine.NativePretokenCounter()
        except Exception:
            return False

        specials = self._special_tokens

        def feed(text: str) -> None:
            for part in split_on_special_tokens(text, specials, training=True):
                if part:
                    counter.add(part)

        # newline="" disables universal-newline translation so CRLF corpora
        # count identically to the binary-read Python path.
        with open(input_path, encoding=ENCODING, errors="ignore", newline="") as f:
            if specials:
                # Cut the stream only at complete special-token occurrences:
                # pre-tokens never span a special, so these cuts are exactly
                # lossless (mirrors find_chunk_boundaries' invariant).
                max_keep = max(len(s) for s in specials) - 1
                pending = ""
                while True:
                    chunk = f.read(STREAM_CHUNK_CHARS)
                    if not chunk:
                        break
                    pending += chunk
                    cut = max(pending.rfind(s) for s in specials)
                    if cut > 0:
                        feed(pending[:cut])
                        pending = pending[cut:]
                    elif len(pending) > PENDING_FLUSH_CHARS:
                        if cut == 0:
                            # The only special occurrence sits at index 0:
                            # strip it (training=True discards specials) so
                            # its bytes never reach add_prefix as ordinary
                            # text.  Longest-first mirrors
                            # split_on_special_tokens' overlap handling.
                            for s in sorted(specials, key=len, reverse=True):
                                if pending.startswith(s):
                                    pending = pending[len(s):]
                                    break
                        # No special in sight: keep memory bounded by exact
                        # token streaming, retaining enough characters to
                        # cover a special straddling the boundary.
                        head = pending[: len(pending) - max_keep]
                        data = head.encode(ENCODING)
                        consumed = counter.add_prefix(data)
                        pending = (
                            data[consumed:].decode(ENCODING)
                            + pending[len(pending) - max_keep :]
                        )
                if pending:
                    feed(pending)
            else:
                # No specials: exact incremental scan — the C++ side counts
                # every pre-token that provably cannot change with more
                # input, and returns the undecided tail to carry over.
                tail = b""
                while True:
                    chunk = f.read(STREAM_CHUNK_CHARS)
                    if not chunk:
                        break
                    data = tail + chunk.encode(ENCODING)
                    consumed = counter.add_prefix(data)
                    tail = data[consumed:]
                if tail:
                    counter.add(tail)

        vocab = self._vocab
        base = len(vocab)
        pairs = counter.train_bpe(
            [vocab[i] for i in range(base)], self._target_vocab_size
        )
        next_id = base
        for a, b in pairs:
            self._merges.append((vocab[a], vocab[b]))
            vocab[next_id] = vocab[a] + vocab[b]
            next_id += 1
        return True

    def train_from_pretokens(self, pretoken_counts: Counter[Pretoken]) -> None:
        """Learn merges from pre-token multiplicities (already counted).

        Uses the C++ merge loop (``native/src/bt_native.cpp:bt_train_bpe``,
        same selection semantics) when a toolchain is available; the Python
        loop below is the reference implementation and fallback.
        """
        if self._train_native(pretoken_counts):
            return
        words: list[list[int]] = []
        counts: list[int] = []
        for pretoken, count in pretoken_counts.items():
            if len(pretoken) < 2:
                continue
            words.append(list(pretoken))
            counts.append(count)

        pair_counts: Counter[Pair] = Counter()
        pair_words: dict[Pair, set[int]] = {}
        for idx, word in enumerate(words):
            c = counts[idx]
            for pair in zip(word, word[1:]):
                pair_counts[pair] += c
                pair_words.setdefault(pair, set()).add(idx)

        vocab = self._vocab
        heap = [
            _HeapEntry(c, pair, (vocab[pair[0]], vocab[pair[1]]))
            for pair, c in pair_counts.items()
        ]
        heapq.heapify(heap)

        next_id = len(vocab)
        while len(vocab) < self._target_vocab_size and heap:
            entry = heapq.heappop(heap)
            pair = entry.pair
            if pair_counts.get(pair, 0) != entry.count:
                continue  # superseded by a later count update

            a, b = pair
            members = pair_words.get(pair)
            if not members:
                continue
            touched: set[Pair] = set()
            merged_any = False
            for idx in list(members):
                old_word = words[idx]
                new_word = _merge_occurrences(old_word, a, b, next_id)
                if new_word is None:
                    continue
                merged_any = True
                c = counts[idx]
                for p in zip(old_word, old_word[1:]):
                    pair_counts[p] -= c
                    s = pair_words.get(p)
                    if s is not None:
                        s.discard(idx)
                    touched.add(p)
                for p in zip(new_word, new_word[1:]):
                    pair_counts[p] += c
                    pair_words.setdefault(p, set()).add(idx)
                    touched.add(p)
                words[idx] = new_word

            if not merged_any:
                continue

            self._merges.append((vocab[a], vocab[b]))
            vocab[next_id] = vocab[a] + vocab[b]
            next_id += 1
            for p in touched:
                c = pair_counts.get(p, 0)
                if c > 0:
                    heapq.heappush(heap, _HeapEntry(c, p, (vocab[p[0]], vocab[p[1]])))

    def _train_native(self, pretoken_counts: Counter[Pretoken]) -> bool:
        """Learn merges via the C++ loop; False when unavailable."""
        if os.environ.get("BT_NATIVE", "1") == "0":
            return False
        try:
            from bpe_transformer_tpu_torch.native import engine as native_engine

            if not native_engine.is_available():
                return False
            vocab = self._vocab
            base = len(vocab)
            words: list[Pretoken] = []
            counts: list[int] = []
            for pretoken, count in pretoken_counts.items():
                if len(pretoken) < 2:
                    continue
                words.append(pretoken)
                counts.append(count)
            pairs = native_engine.train_bpe_merges(
                words,
                counts,
                [vocab[i] for i in range(base)],
                self._target_vocab_size,
            )
        except Exception:
            return False
        next_id = base
        for a, b in pairs:
            self._merges.append((vocab[a], vocab[b]))
            vocab[next_id] = vocab[a] + vocab[b]
            next_id += 1
        return True

    def save_trainer(self, output_dir: Path | None = None) -> None:
        """Pickle ``vocab.pkl`` and ``merges.pkl`` under ``output_dir``.

        Artifact format matches the reference (`bpe_trainer.py:447-472`), so
        tokenizers can load either implementation's output.
        """
        if output_dir is None:
            output_dir = DEFAULT_OUTPUT_DIR / "tokenizer" / "bpe_trainer"
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / "vocab.pkl", "wb") as f:
            pickle.dump(self._vocab, f)
        with open(output_dir / "merges.pkl", "wb") as f:
            pickle.dump(self._merges, f)


def train_bpe(
    input_path: str | Path,
    vocab_size: int,
    special_tokens: list[str] | None = None,
    n_workers: int | None = None,
) -> tuple[dict[int, bytes], list[tuple[bytes, bytes]]]:
    """Convenience wrapper: train and return ``(vocab, merges)``.

    Mirrors the reference's package-level ``train_bpe`` (`main.py:8-17`).
    """
    trainer = BPETrainer(vocab_size=vocab_size, special_tokens=special_tokens)
    trainer.train(input_path, n_workers=n_workers)
    return trainer.vocab, trainer.merges
