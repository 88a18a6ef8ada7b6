"""Continuous-batching serving on the port: the offline batch mode.

The port's counterpart of ``examples/10_serving.py``.  A fixed pool of KV
slots decodes many requests through one batched step a tick (B1 the
flash-decoding kernel, B3 the fused SwiGLU), prefill pads prompts into
power-of-two length buckets (B2 the flash kernel), and a FIFO scheduler
feeds free slots as requests arrive.  The demo walks the offline batch
mode (a prompts file in, a completions JSONL out) and checks the
engine's parity: at temperature 0 every batched completion is
byte-identical to a sequential ``generate_ids`` run of the same prompt.
The port builds each kernel library once (no program a bucket, unlike
XLA), so its compile count is the libraries it loaded.

A byte-level model (vocabulary 256 + one stop token) keeps the demo
self-contained; the weights are random, at 8 times the init scale so that
the greedy picks are clear.

Usage:
    python bpe_transformer_tpu_torch/examples/10_serving.py [--input PATH]
        [--new-tokens N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from _common import SPECIALS, add_device_args, add_input_arg, corpus, report_launches

import torch

from bpe_transformer_tpu_torch.models import ModelConfig, init_params
from bpe_transformer_tpu_torch.serving import ServingEngine
from bpe_transformer_tpu_torch.tokenization import BPETokenizer
from bpe_transformer_tpu_torch.training import generate_ids
from bpe_transformer_tpu_torch.tree import tree_map


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    add_device_args(parser)
    parser.add_argument("--new-tokens", type=int, default=12)
    parser.add_argument("--out", type=Path, default=Path("serving_demo"))
    args = parser.parse_args()
    dev = torch.device(args.device)

    config = ModelConfig(vocab_size=257, context_length=128, d_model=64, num_layers=2,
                         num_heads=4, d_ff=128, attention_impl="flash", ffn_impl="pallas",
                         decode_attention_impl="pallas")
    params = tree_map(lambda t: t * 8 if t.ndim == 2 else t,
                      init_params(config, torch.Generator(device=dev).manual_seed(0),
                                  device=dev))
    # id 256, the special token: the serving stop id.
    tokenizer = BPETokenizer(vocab={i: bytes([i]) for i in range(256)}, merges=[],
                             special_tokens=SPECIALS)

    # Ragged prompts from the input text -> a prompts file, one per line.
    text = corpus(args, args.out).read_text(encoding="utf-8", errors="ignore")
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    prompts = [lines[i % len(lines)][: 6 + 13 * i] for i in range(6)]
    prompts_path = Path("serving_prompts.txt")
    prompts_path.write_text("\n".join(prompts) + "\n", encoding="utf-8")

    out_path = Path("serving_completions.jsonl")
    with ServingEngine(params, config, tokenizer=tokenizer,
                       slots=3,  # fewer slots than prompts: retirement + re-admission
                       min_bucket=16, default_stop_id=256, device=dev) as serving:
        results = serving.serve_batch_file(prompts_path, out_path,
                                           max_new_tokens=args.new_tokens, temperature=0.0)
        stats = serving.stats()

    rows = [json.loads(ln) for ln in out_path.read_text().splitlines()]
    print(f"served {len(rows)} prompts through {stats['slots']} slots: "
          f"{stats['tokens_emitted']} tokens in {stats['ticks']} ticks, "
          f"buckets={stats['prefill_buckets']}, kernel libraries loaded "
          f"{stats['compiled_programs']}")

    # Batched-vs-sequential parity at temperature 0.
    for prompt, result in zip(prompts, results, strict=True):
        expected = generate_ids(params, config, tokenizer.encode(prompt),
                                max_new_tokens=args.new_tokens, temperature=0.0, stop_id=256,
                                device=dev)
        if list(result.token_ids) != expected:
            raise SystemExit(f"parity violated: {list(result.token_ids)} != {expected}")
    print("every batched completion matches its sequential generate_ids run "
          "(temperature=0, byte-identical)")
    print(f"first completion: {rows[0]['completion']!r}")
    report_launches()
    print("serving demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
