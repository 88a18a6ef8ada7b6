"""Mixture-of-experts training on the port: top-k routing and expert
parallelism.

The port's counterpart of ``examples/6_moe_expert_parallel.py``: a routed
FFN (``models/moe.py``: router, dispatch, experts, combine) trained by the
loop under the ``dp_ep`` strategy (``parallel/gspmd.py``), where the
stacked expert weights are cut over an ``expert`` axis of the mesh and the
router's and experts' outputs are gathered over it.  The ranks are
processes (``--world N``, one a card; gloo ranks with ``--device cpu``):
the mesh is ``{"data": N / e, "expert": e}`` with ``e`` the largest
divisor of N that divides ``--experts``.  At ``--world 1`` (the default)
the one rank holds every expert; a wider world splits them, and each card
holds 1/e of the expert weights and their moments.  Attention runs RoPE
inside the flash kernel (B5, backward B4); the MoE FFN runs no SwiGLU
kernel; sampling runs the flash prefill (B2) and flash-decoding (B1).

Usage:
    python bpe_transformer_tpu_torch/examples/6_moe_expert_parallel.py [--input PATH]
        [--steps N] [--experts 4] [--top-k 2] [--world N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from pathlib import Path

from _common import (
    SPECIALS,
    add_device_args,
    add_input_arg,
    corpus,
    in_world,
    rank0,
    report_launches,
    run_world,
)

from bpe_transformer_tpu_torch import BPETokenizer, BPETrainer
from bpe_transformer_tpu_torch.checkpointing import load_checkpoint
from bpe_transformer_tpu_torch.data import load_token_file, tokenize_to_memmap
from bpe_transformer_tpu_torch.models import TINYSTORIES_4L
from bpe_transformer_tpu_torch.training import LoopConfig, TrainHParams, generate_text, train


def parse_args():
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    add_device_args(parser, world=True)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--vocab-size", type=int, default=512)
    parser.add_argument("--experts", type=int, default=4)
    parser.add_argument("--top-k", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--out", type=Path, default=Path("moe_demo"))
    return parser.parse_args()


def mesh_axes(args) -> dict:
    expert = math.gcd(args.experts, args.world)
    return {"data": args.world // expert, "expert": expert}


def prepare(args) -> None:
    """The tokenizer and the token file, once, before any rank starts."""
    args.out.mkdir(parents=True, exist_ok=True)
    print(f"1/3  mesh {mesh_axes(args)} over {args.world} rank process(es): experts cut over "
          f"the expert axis, the routed tokens gathered over it")
    print("2/3  tokenizer + memmap ...")
    path = corpus(args, args.out)
    trainer = BPETrainer(vocab_size=args.vocab_size, special_tokens=SPECIALS)
    trainer.train(path)
    trainer.save_trainer(args.out / "tokenizer")
    tokens = tokenize_to_memmap(BPETokenizer(trainer.vocab, trainer.merges, SPECIALS), path,
                                args.out / "tokens.bin")
    print(f"     {tokens.shape[0]:,} tokens")


def moe_train(args) -> int:
    if rank0():
        print(f"3/3  MoE training (top-{args.top_k} of {args.experts} experts) ...")
    config = dataclasses.replace(
        TINYSTORIES_4L, vocab_size=args.vocab_size, context_length=128, d_model=128,
        num_layers=2, num_heads=4, d_ff=256, ffn_type="moe", n_experts=args.experts,
        router_top_k=args.top_k, capacity_factor=2.0, attention_impl="flash_fused",
        flash_fused_min_seq=0, decode_attention_impl="pallas",
    )
    summary = train(
        model_config=config,
        hparams=TrainHParams(max_learning_rate=3e-3, warmup_iters=max(args.steps // 10, 1),
                             cosine_cycle_iters=args.steps),
        loop=LoopConfig(
            steps=args.steps,
            batch_size=args.batch_size,
            log_every=max(args.steps // 5, 1),
            eval_every=args.steps,
            checkpoint_every=args.steps,
            checkpoint_dir=str(args.out / "checkpoints"),
            parallel="dp_ep",
            mesh_axes=mesh_axes(args),
        ),
        train_data=load_token_file(args.out / "tokens.bin"),
        device=args.device,
    )
    if not rank0():
        return 0
    first, last = summary["history"][0]["loss"], summary["history"][-1]["loss"]
    print(f"     loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    tokenizer = BPETokenizer.from_files(args.out / "tokenizer" / "vocab.pkl",
                                     args.out / "tokenizer" / "merges.pkl", SPECIALS)
    params = load_checkpoint(args.out / "checkpoints" / "latest.ckpt")["params"]
    text = generate_text(params, config, tokenizer, prompt="Once", max_new_tokens=24,
                         temperature=0.8, top_k=20, device=args.device)
    print("     sample:", text[:120].replace("\n", " "))
    report_launches()
    print("moe expert-parallel OK")
    return 0


def main() -> int:
    args = parse_args()
    if not in_world():
        prepare(args)
    return run_world(lambda: moe_train(args), args.world)


if __name__ == "__main__":
    raise SystemExit(main())
