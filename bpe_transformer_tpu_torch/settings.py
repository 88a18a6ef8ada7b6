"""Constants of the host-side tokenization stack (the port's copy of
``bpe_transformer_tpu/settings.py``).

The port's pre-tokenizer implements :data:`GPT2_SPLIT_PATTERN` with its own
scanner (``tokenization/pretokenization.py``) and needs no ``regex``; the
pattern stays here as the definition that scanner follows.
"""

from __future__ import annotations

from pathlib import Path

#: Canonical text encoding used across the tokenization stack.
ENCODING: str = "utf-8"

#: GPT-2 pre-tokenization pattern (Radford et al., 2019), as ``regex`` reads
#: it (``\p{...}`` classes).  Documentation only: nothing compiles it.
GPT2_SPLIT_PATTERN: str = r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""

#: Default directory for trainer artifacts (vocab/merges pickles).
DEFAULT_OUTPUT_DIR: Path = Path(__file__).resolve().parent.parent / "output"
