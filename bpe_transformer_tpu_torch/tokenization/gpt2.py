"""GPT-2 tokenizer-artifact interop (host CPU).

The port's copy of ``bpe_transformer_tpu/tokenization/gpt2.py``: it reads
the GPT-2-format files a user supplies and fetches nothing.

The GPT-2 release serializes its byte-level vocabulary through a reversible
byte->printable-unicode remapping (public algorithm from the GPT-2 codebase).
This module rebuilds that table and loads ``vocab.json`` / ``merges.txt``
pairs in that format into the plain ``dict[int, bytes]`` / list-of-byte-pairs
representation the rest of this framework uses.

Parity target: the reference consumes the same artifact format in its test
harness (``tests/common.py:10-54``).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """Map every byte 0..255 to a printable unicode character, reversibly.

    Printable latin-1 bytes keep their own character; the remaining 68 bytes
    are shifted up by 256 so every byte has a visible representation.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    byte_values = keep[:]
    char_codes = keep[:]
    bump = 0
    for b in range(256):
        if b not in keep:
            byte_values.append(b)
            char_codes.append(256 + bump)
            bump += 1
    return {b: chr(c) for b, c in zip(byte_values, char_codes)}


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def decode_gpt2_token(token: str) -> bytes:
    """Decode one remapped-unicode token string back to raw bytes."""
    table = unicode_to_bytes()
    return bytes(table[ch] for ch in token)


def load_gpt2_vocab(vocab_path: str | Path) -> dict[int, bytes]:
    """Load a GPT-2-format ``vocab.json`` into ``{id: raw_bytes}``."""
    with open(vocab_path, encoding="utf-8") as f:
        token_to_id: dict[str, int] = json.load(f)
    return {idx: decode_gpt2_token(tok) for tok, idx in token_to_id.items()}


def load_gpt2_merges(merges_path: str | Path) -> list[tuple[bytes, bytes]]:
    """Load a GPT-2-format ``merges.txt`` into ordered raw-byte pairs."""
    merges: list[tuple[bytes, bytes]] = []
    with open(merges_path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip()
            parts = line.split(" ")
            if len(parts) != 2 or not line:
                continue  # header / blank lines
            merges.append((decode_gpt2_token(parts[0]), decode_gpt2_token(parts[1])))
    return merges
