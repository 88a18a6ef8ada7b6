"""Host-side GPT-2-style pre-tokenization without the ``regex`` package (the
port's counterpart of ``bpe_transformer_tpu/tokenization/pretokenization.py``).

The JAX package applies :data:`~bpe_transformer_tpu_torch.settings.GPT2_SPLIT_PATTERN`
with ``regex``, which the port does not depend on.  Here a scanner walks the
alternatives of that pattern in order::

    '(?:[sdmt]|ll|ve|re) | ?\\p{L}+ | ?\\p{N}+ | ?[^\\s\\p{L}\\p{N}]+ | \\s+(?!\\S) | \\s+

with the backtracking of ``regex`` resolved ahead of time, as the JAX
package's C++ scanner does (``native/src/bt_native.cpp``
``next_pretoken_end``):

* a contraction is an apostrophe and ``s``/``d``/``m``/``t`` or
  ``ll``/``ve``/``re`` (lowercase ASCII);
* otherwise an optional ASCII space and a maximal run of one class (letter,
  number or other) when such a run follows;
* otherwise a run of whitespace: all of it at the end of the text, all but
  its last codepoint when two or more are followed by non-space (that last
  one then leads the next pre-token), and a single whitespace codepoint on
  its own.

Each codepoint's class comes from the range tables of
``tokenization/unicode_classes.py`` (``regex``'s own classes, searched with
:func:`bisect.bisect_right`), never from ``unicodedata`` or
``str.isspace``, whose Unicode versions differ from ``regex``'s.  The text is
mapped to one class letter per codepoint with :meth:`str.translate`, and
the runs are found by the stdlib ``re`` on that class string.

Special tokens are split with the stdlib ``re`` on escaped literals; chunking,
counting and the process pool are the JAX package's.  The counts, and
therefore a trained vocabulary, are identical to the JAX package's.
"""

from __future__ import annotations

import bisect
import multiprocessing
import os
import re
from collections import Counter
from functools import reduce
from pathlib import Path
from typing import BinaryIO, Iterable

from bpe_transformer_tpu_torch.settings import ENCODING
from bpe_transformer_tpu_torch.tokenization.unicode_classes import (
    LETTER_RANGES,
    NUMBER_RANGES,
    SPACE_RANGES,
)

Pretoken = tuple[int, ...]

_LETTER, _NUMBER, _SPACE, _OTHER = "L", "N", "S", "O"


def _in_ranges(cp: int, ranges: tuple[tuple[int, int], ...], starts: list[int]) -> bool:
    i = bisect.bisect_right(starts, cp) - 1
    return i >= 0 and cp <= ranges[i][1]


_LETTER_STARTS = [lo for lo, _ in LETTER_RANGES]
_NUMBER_STARTS = [lo for lo, _ in NUMBER_RANGES]
_SPACE_STARTS = [lo for lo, _ in SPACE_RANGES]


def char_class(cp: int) -> str:
    """The class of codepoint ``cp``: ``"L"`` (``\\p{L}``), ``"N"``
    (``\\p{N}``), ``"S"`` (``\\s``) or ``"O"`` (any other)."""
    if _in_ranges(cp, LETTER_RANGES, _LETTER_STARTS):
        return _LETTER
    if _in_ranges(cp, NUMBER_RANGES, _NUMBER_STARTS):
        return _NUMBER
    if _in_ranges(cp, SPACE_RANGES, _SPACE_STARTS):
        return _SPACE
    return _OTHER


class _ClassTable(dict):
    """``str.translate`` table: codepoint -> class letter, filled on first
    sight of each codepoint."""

    def __missing__(self, cp: int) -> str:
        cls = char_class(cp)
        self[cp] = cls
        return cls


_CLASSES = _ClassTable()
_RUNS = {cls: re.compile(f"{cls}+") for cls in (_LETTER, _NUMBER, _SPACE, _OTHER)}
_CONTRACTION_PAIRS = ("ll", "ve", "re")


def _next_end(text: str, classes: str, n: int, i: int) -> int:
    """End (exclusive) of the pre-token that starts at ``i``."""
    c = text[i]
    if c == "'" and i + 1 < n:
        if text[i + 1] in "sdmt":
            return i + 2
        if text[i + 1 : i + 3] in _CONTRACTION_PAIRS:
            return i + 3
    j = i + 1 if c == " " else i
    if j < n and classes[j] != _SPACE:
        return _RUNS[classes[j]].match(classes, j).end()
    end = _RUNS[_SPACE].match(classes, i).end()
    if end == n or end - i == 1:
        return end
    return end - 1


def iter_pretoken_strings(text: str) -> Iterable[str]:
    """Yield GPT-2 pre-token strings of ``text`` in order."""
    classes = text.translate(_CLASSES)
    n = len(text)
    i = 0
    while i < n:
        end = _next_end(text, classes, n, i)
        yield text[i:end]
        i = end


def find_chunk_boundaries(
    file: BinaryIO,
    desired_num_chunks: int,
    special_tokens: list[str] | None = None,
) -> list[int]:
    """Byte offsets that cut ``file`` into ~equal chunks at safe boundaries.

    A boundary is only placed at the start of a special token (default:
    newline) so no pre-token ever straddles two chunks.  May return fewer
    boundaries than requested when guesses collide.
    """
    if special_tokens:
        needles = [t.encode(ENCODING) for t in special_tokens]
    else:
        needles = [b"\n"]

    file.seek(0, os.SEEK_END)
    file_size = file.tell()
    file.seek(0)

    chunk_size = file_size // max(desired_num_chunks, 1)
    guesses = [i * chunk_size for i in range(desired_num_chunks + 1)]
    guesses[-1] = file_size

    read_ahead = 4096
    for bi in range(1, len(guesses) - 1):
        pos = guesses[bi]
        file.seek(pos)
        while True:
            window = file.read(read_ahead)
            if window == b"":
                guesses[bi] = file_size
                break
            hits = [window.find(n) for n in needles]
            hits = [h for h in hits if h != -1]
            if hits:
                guesses[bi] = pos + min(hits)
                break
            pos += read_ahead

    return sorted(set(guesses))


def split_on_special_tokens(
    text: str,
    special_tokens: list[str] | None = None,
    *,
    training: bool = True,
) -> list[str]:
    """Split ``text`` at special tokens so BPE never merges across them.

    ``training=True`` drops the special tokens from the output parts;
    ``training=False`` keeps each special token as its own part (so the
    encoder can map it straight to its vocab id).  Longer special tokens win
    over their prefixes (e.g. ``<|eot|><|eot|>`` before ``<|eot|>``).
    """
    if not special_tokens:
        return [text]
    ordered = sorted(special_tokens, key=len, reverse=True)
    alternation = "|".join(re.escape(t) for t in ordered)
    pattern = alternation if training else f"({alternation})"
    return re.split(pattern, text)


def pretokenize_text(text: str) -> list[bytes]:
    """GPT-2 pre-tokens of ``text`` as UTF-8 byte strings, in order."""
    return [s.encode(ENCODING) for s in iter_pretoken_strings(text)]


def count_pretokens_in_text(
    text: str,
    special_tokens: list[str] | None = None,
    *,
    training: bool = True,
    into: Counter[Pretoken] | None = None,
) -> Counter[Pretoken]:
    """Count pre-tokens (as byte-value tuples) in a text string."""
    counter: Counter[Pretoken] = into if into is not None else Counter()
    specials = set(special_tokens) if special_tokens else set()
    for part in split_on_special_tokens(text, special_tokens, training=training):
        if not part:
            continue
        if part in specials:
            counter[tuple(part.encode(ENCODING))] += 1
            continue
        for pretoken in iter_pretoken_strings(part):
            counter[tuple(pretoken.encode(ENCODING))] += 1
    return counter


def count_pretokens_in_chunk(
    file_path: str | Path,
    start: int,
    end: int,
    training: bool = True,
    special_tokens: list[str] | None = None,
) -> Counter[Pretoken]:
    """Pre-token counts of ``file_path[start:end]`` (a worker unit)."""
    with open(file_path, "rb") as f:
        f.seek(start)
        text = f.read(end - start).decode(ENCODING, errors="ignore")
    return count_pretokens_in_text(text, special_tokens, training=training)


def count_pretokens(
    file_path: str | Path,
    special_tokens: list[str] | None = None,
    *,
    training: bool = True,
    n_workers: int | None = None,
    parallel: bool = True,
) -> Counter[Pretoken]:
    """Pre-token counts for a whole file, optionally fanned out over
    processes (the BPE trainer's entry point).  ``n_workers`` defaults to 4
    and is clamped to the host CPU count; workers are spawned, not forked."""
    if n_workers is None or n_workers <= 0:
        n_workers = 4
    n_workers = min(n_workers, os.cpu_count() or 1)

    with open(file_path, "rb") as f:
        boundaries = find_chunk_boundaries(f, n_workers if parallel else 4, special_tokens)

    spans = list(zip(boundaries[:-1], boundaries[1:]))
    if not parallel or n_workers == 1 or len(spans) <= 1:
        total: Counter[Pretoken] = Counter()
        for start, end in spans:
            total += count_pretokens_in_chunk(file_path, start, end, training, special_tokens)
        return total

    args = [(file_path, start, end, training, special_tokens) for start, end in spans]
    with multiprocessing.get_context("spawn").Pool(processes=n_workers) as pool:
        per_chunk = pool.starmap(count_pretokens_in_chunk, args)
    return reduce(lambda a, b: a + b, per_chunk, Counter())
