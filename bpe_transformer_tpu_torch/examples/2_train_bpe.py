"""BPE training demo on the port: learn a vocabulary and inspect it.

The port's counterpart of ``examples/2_train_bpe.py`` (the reference's
notebook 2): trains a BPE tokenizer on a text file, saves the
``vocab.pkl``/``merges.pkl`` artifacts, and prints the longest learned
token.  Host only.

Usage:
    python bpe_transformer_tpu_torch/examples/2_train_bpe.py [--input PATH] [--vocab-size N] [--out DIR]
"""

from __future__ import annotations

import argparse
import time
import tracemalloc
from pathlib import Path

from _common import SPECIALS, add_input_arg, corpus

from bpe_transformer_tpu_torch import BPETrainer


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    parser.add_argument("--vocab-size", type=int, default=1000)
    parser.add_argument("--out", type=Path, default=Path("bpe_artifacts"))
    args = parser.parse_args()
    path = corpus(args, args.out)

    tracemalloc.start()
    start = time.perf_counter()
    trainer = BPETrainer(vocab_size=args.vocab_size, special_tokens=SPECIALS)
    trainer.train(path)
    elapsed = time.perf_counter() - start
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()

    vocab, merges = trainer.vocab, trainer.merges
    print(f"trained vocab {len(vocab):,} ({len(merges):,} merges) "
          f"in {elapsed:.2f}s, peak traced memory {peak / 2**20:.1f} MB")

    longest = max(vocab.values(), key=len)
    print(f"longest learned token: {longest!r} ({len(longest)} bytes)")

    trainer.save_trainer(args.out)
    print(f"saved vocab.pkl / merges.pkl under {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
