"""End-to-end LM pretraining on the port: text -> BPE -> memmap -> train
on the card -> sample.

The port's counterpart of ``examples/4_train_lm.py``: train a BPE
tokenizer on the host, stream-encode the corpus to a uint16 memmap, run
the training loop (``train`` with a ``LoopConfig``) on the card, then load
the checkpoint and sample text.  The config's knobs select the kernels:
RoPE inside the flash kernel (B5) with its backward pair (B4) and the fused
SwiGLU (B3) in training; the flash prefill (B2), flash-decoding (B1) and
B3 in sampling.

Usage:
    python bpe_transformer_tpu_torch/examples/4_train_lm.py [--input PATH] [--steps N]
        [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from _common import SPECIALS, add_device_args, add_input_arg, corpus, report_launches

from bpe_transformer_tpu_torch import BPETokenizer, BPETrainer
from bpe_transformer_tpu_torch.checkpointing import load_checkpoint
from bpe_transformer_tpu_torch.data import tokenize_to_memmap
from bpe_transformer_tpu_torch.models import TINYSTORIES_4L
from bpe_transformer_tpu_torch.training import LoopConfig, TrainHParams, generate_text, train


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    add_device_args(parser)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--vocab-size", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--out", type=Path, default=Path("lm_demo"))
    args = parser.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    path = corpus(args, args.out)

    print("1/4  training BPE tokenizer ...")
    trainer = BPETrainer(vocab_size=args.vocab_size, special_tokens=SPECIALS)
    trainer.train(path)
    trainer.save_trainer(args.out / "tokenizer")
    tokenizer = BPETokenizer(trainer.vocab, trainer.merges, SPECIALS)

    print("2/4  encoding corpus to memmap ...")
    tokens = tokenize_to_memmap(tokenizer, path, args.out / "tokens.bin")
    print(f"     {tokens.shape[0]:,} tokens")

    print("3/4  training LM ...")
    config = dataclasses.replace(
        TINYSTORIES_4L, vocab_size=args.vocab_size, context_length=128,
        attention_impl="flash_fused", flash_fused_min_seq=0, ffn_impl="pallas",
        decode_attention_impl="pallas",
    )
    n_val = max(tokens.shape[0] // 20, config.context_length + 1)
    summary = train(
        model_config=config,
        hparams=TrainHParams(
            max_learning_rate=3e-3,
            warmup_iters=max(args.steps // 20, 1),
            cosine_cycle_iters=args.steps,
        ),
        loop=LoopConfig(
            steps=args.steps,
            batch_size=args.batch_size,
            log_every=max(args.steps // 10, 1),
            eval_every=args.steps,
            checkpoint_every=args.steps,
            checkpoint_dir=str(args.out / "checkpoints"),
            metrics_jsonl=str(args.out / "metrics.jsonl"),
        ),
        train_data=tokens[:-n_val],
        val_data=tokens[-n_val:],
        device=args.device,
    )
    print(f"     final train loss {summary['final_train_loss']:.3f}, "
          f"val loss {summary['final_val_loss']:.3f}")

    print("4/4  sampling ...")
    params = load_checkpoint(args.out / "checkpoints" / "latest.ckpt")["params"]
    text = generate_text(params, config, tokenizer, prompt="Once upon a time",
                         max_new_tokens=64, temperature=0.8, top_k=40, device=args.device)
    print(text)
    report_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
