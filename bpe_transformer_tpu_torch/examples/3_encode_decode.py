"""Encode/decode demo on the port: load artifacts, round-trip text, stream
a file.

The port's counterpart of ``examples/3_encode_decode.py`` (the reference's
notebook 3): trains a small tokenizer unless artifacts are given, then
shows exact round trips and the bounded-memory streaming encode.  Host
only.

Usage:
    python bpe_transformer_tpu_torch/examples/3_encode_decode.py [--artifacts DIR] [--input PATH]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from _common import SPECIALS, add_input_arg, corpus

from bpe_transformer_tpu_torch import BPETokenizer, BPETrainer


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--artifacts", type=Path, default=None,
                        help="dir with vocab.pkl/merges.pkl; trains one if absent")
    add_input_arg(parser)
    parser.add_argument("--out", type=Path, default=Path("encode_demo"))
    args = parser.parse_args()
    path = corpus(args, args.out)

    if args.artifacts is not None:
        tokenizer = BPETokenizer.from_files(
            args.artifacts / "vocab.pkl", args.artifacts / "merges.pkl", SPECIALS
        )
    else:
        trainer = BPETrainer(vocab_size=1000, special_tokens=SPECIALS)
        trainer.train(path)
        tokenizer = BPETokenizer(trainer.vocab, trainer.merges, SPECIALS)

    sample = "Once upon a time, there was a pretty girl named Lily.<|endoftext|>"
    ids = tokenizer.encode(sample)
    if tokenizer.decode(ids) != sample:
        raise SystemExit("round trip failed")
    print(f"roundtrip OK: {len(sample)} chars -> {len(ids)} tokens")
    print("ids:", ids[:16], "...")
    print("tokens:", [tokenizer.vocab[i] for i in ids[:8]], "...")

    # Streaming encode never holds the whole file.
    start = time.perf_counter()
    with open(path, encoding="utf-8") as f:
        n = sum(1 for _ in tokenizer.encode_iterable(f))
    elapsed = time.perf_counter() - start
    print(f"streamed {path.name}: {n:,} tokens in {elapsed:.2f}s "
          f"({n / elapsed:,.0f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
