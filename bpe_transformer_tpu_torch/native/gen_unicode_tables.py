"""Write ``src/unicode_classes.inc``, the C++ scanner's codepoint classes,
from the port's own range tables (``tokenization/unicode_classes.py``).

The GPT-2 pre-tokenization pattern relies on three Unicode classes,
``\\p{L}``, ``\\p{N}`` and ``\\s``, as the ``regex`` module reads them.  The
port holds those classes as sorted ``(lo, hi)`` ranges and never imports
``regex``; this script prints the same ranges in the C++ table format, so
the Python scanner and the native one classify every codepoint alike.  Its
output is byte-identical to the JAX package's generated file (which queries
``regex`` for every codepoint) and is committed, so a build never runs it:

    python -m bpe_transformer_tpu_torch.native.gen_unicode_tables
"""

from __future__ import annotations

from pathlib import Path

from bpe_transformer_tpu_torch.tokenization.unicode_classes import (
    LETTER_RANGES,
    NUMBER_RANGES,
    REGEX_VERSION,
    SPACE_RANGES,
)

OUT = Path(__file__).parent / "src" / "unicode_classes.inc"


def _emit(name: str, ranges) -> str:
    body = ",\n".join("    {0x%06X, 0x%06X}" % (lo, hi) for lo, hi in ranges)
    return (
        f"static const CpRange {name}[] = {{\n{body}\n}};\n"
        f"static const int {name}_len = {len(ranges)};\n"
    )


def render() -> str:
    """The text of ``unicode_classes.inc``."""
    sections = [
        _emit(name, ranges)
        for name, ranges in (
            ("kLetterRanges", LETTER_RANGES),
            ("kNumberRanges", NUMBER_RANGES),
            ("kSpaceRanges", SPACE_RANGES),
        )
    ]
    return (
        "// Auto-generated by gen_unicode_tables.py — do not edit.\n"
        "// Unicode class membership per the Python `regex` module\n"
        f"// (regex {REGEX_VERSION}).\n\n" + "\n".join(sections)
    )


def main() -> None:
    OUT.write_text(render(), encoding="utf-8")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
