"""Pre-tokenization demo on the port: serial against parallel.

The port's counterpart of ``examples/1_pretokenization.py`` (the
reference's notebook 1, which timed serial against multiprocessing
pre-tokenization): runs both paths of the port's pre-tokenizer (the native
C++ scanner when it builds on this host, the regex-free Python scanner
otherwise) on a text file and reports pre-tokens a second.  Host only.

Usage:
    python bpe_transformer_tpu_torch/examples/1_pretokenization.py [--input PATH] [--workers N]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from _common import SPECIALS, add_input_arg, corpus

from bpe_transformer_tpu_torch.tokenization import (
    parallel_pretokenization,
    serial_pretokenization,
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--out", type=Path, default=Path("pretok_demo"))
    args = parser.parse_args()
    path = corpus(args, args.out)

    start = time.perf_counter()
    serial_counts = serial_pretokenization(path, special_tokens=SPECIALS)
    serial_s = time.perf_counter() - start
    n_tokens = sum(serial_counts.values())
    print(f"serial:   {serial_s:6.2f}s  ({n_tokens / serial_s:,.0f} pretokens/s)")

    start = time.perf_counter()
    parallel_counts = parallel_pretokenization(path, n_workers=args.workers,
                                               special_tokens=SPECIALS)
    parallel_s = time.perf_counter() - start
    print(f"parallel: {parallel_s:6.2f}s  ({n_tokens / parallel_s:,.0f} pretokens/s)")

    if parallel_counts != serial_counts:
        raise SystemExit("parallel != serial pretokenization")
    print(f"{len(serial_counts):,} distinct pretokens, {n_tokens:,} total — paths agree")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
