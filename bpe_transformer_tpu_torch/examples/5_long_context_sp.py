"""Long-context training on the port: sequence parallelism.

The port's counterpart of ``examples/5_long_context_sp.py``.  Every
sequence is cut into shards, one a rank, and attention runs as the ring
schedule (K/V shards travelling around the ring: ``parallel/ring_attention.py``),
the zig-zag ring (``--zigzag``, balanced causal work) or the Ulysses
all-to-all head scatter (``--ulysses``); ``--grad-accum N`` accumulates N
microbatches a update inside the sharded step.

By default the ranks are a ``StackedRing`` of ``--ranks`` (4) on one card:
every shard on the one device, one kernel launch a ring step over all of
them.  ``--world N`` runs N rank processes instead (one a card; gloo ranks
with ``--device cpu``), each holding its shard of every sequence, the K/V
blocks sent rank to rank: what a wider world adds is the memory, each card
holding 1/N of the activations.  Under ``attention_impl="flash"`` the ring
steps run the flash kernels (B2 with its lse, the non-causal B6 and their
backward B4) and the FFN the fused SwiGLU (B3).

Usage:
    python bpe_transformer_tpu_torch/examples/5_long_context_sp.py [--input PATH]
        [--steps N] [--context 512] [--zigzag | --ulysses] [--grad-accum N]
        [--ranks 4 | --world N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
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

import numpy as np
import torch

from bpe_transformer_tpu_torch import BPETokenizer, BPETrainer
from bpe_transformer_tpu_torch.data import get_batch, load_token_file, tokenize_to_memmap
from bpe_transformer_tpu_torch.models import TINYSTORIES_4L, init_params
from bpe_transformer_tpu_torch.optim import adamw_init
from bpe_transformer_tpu_torch.parallel import (
    StackedRing,
    make_mesh,
    make_sp_train_step,
    shard_sp_batch,
)
from bpe_transformer_tpu_torch.training import TrainHParams


def parse_args():
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    add_device_args(parser, world=True)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--vocab-size", type=int, default=512)
    parser.add_argument("--context", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--ranks", type=int, default=4,
                        help="stacked ranks on one device (with --world 1)")
    parser.add_argument("--ulysses", action="store_true",
                        help="the Ulysses all-to-all head scatter instead of the ring")
    parser.add_argument("--zigzag", action="store_true",
                        help="the balanced striped ring schedule (about 2x less causal work)")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="microbatches a update, accumulated inside the sharded step")
    parser.add_argument("--out", type=Path, default=Path("sp_demo"))
    args = parser.parse_args()
    if args.zigzag and args.ulysses:
        parser.error("--zigzag and --ulysses are mutually exclusive")
    return args


def prepare(args) -> None:
    """The tokenizer and the token file, once, before any rank starts."""
    args.out.mkdir(parents=True, exist_ok=True)
    n = args.ranks if args.world == 1 else args.world
    where = f"a stacked ring of {n} on one {args.device} device" if args.world == 1 else (
        f"{n} rank processes")
    print(f"1/3  {where}; context {args.context} -> {args.context // n} tokens a rank")
    print("2/3  tokenizer + memmap ...")
    path = corpus(args, args.out)
    trainer = BPETrainer(vocab_size=args.vocab_size, special_tokens=SPECIALS)
    trainer.train(path)
    tokenizer = BPETokenizer(trainer.vocab, trainer.merges, SPECIALS)
    tokens = tokenize_to_memmap(tokenizer, path, args.out / "tokens.bin")
    print(f"     {tokens.shape[0]:,} tokens")


def sp_train(args) -> int:
    if args.world == 1:
        ring, n, dev = StackedRing(args.ranks), args.ranks, args.device
    else:
        ring = make_mesh({"data": 1, "seq": args.world}, device=args.device)
        n, dev = args.world, ring.device
    if rank0():
        print("3/3  sequence-parallel training ...")
    config = dataclasses.replace(
        TINYSTORIES_4L, vocab_size=args.vocab_size, context_length=args.context, d_model=128,
        num_layers=2,
        # Ulysses scatters heads over the ranks: a multiple of them.
        num_heads=n if args.ulysses else 4,
        d_ff=256, attention_impl="flash", ffn_impl="pallas",
    )
    hparams = TrainHParams(max_learning_rate=3e-3, warmup_iters=max(args.steps // 10, 1),
                           cosine_cycle_iters=args.steps)
    params = init_params(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = adamw_init(params)
    step = make_sp_train_step(config, hparams, ring, zigzag=args.zigzag, ulysses=args.ulysses,
                              accum_steps=args.grad_accum)
    tokens = load_token_file(args.out / "tokens.bin")
    losses = []
    for i in range(args.steps):
        # Every rank samples the same global batch.
        x, y = get_batch(tokens, args.batch_size, args.context, np.random.default_rng(i))
        if args.grad_accum > 1:
            x, y = (a.reshape(args.grad_accum, -1, args.context) for a in (x, y))
        batch = shard_sp_batch((x, y), ring, zigzag=args.zigzag, stacked=args.grad_accum > 1,
                               device=dev)
        params, opt_state, metrics = step(params, opt_state, *batch)
        losses.append(float(metrics["loss"]))
    if rank0():
        schedule = ("Ulysses all-to-all" if args.ulysses
                    else "zig-zag striped ring" if args.zigzag else "contiguous ring")
        accum = (f", {args.grad_accum} accumulated microbatches/update"
                 if args.grad_accum > 1 else "")
        print(f"     loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps "
              f"(seq {args.context} sharded {n}-way, {schedule}{accum})")
        report_launches()
        print("long-context sp OK")
    return 0


def main() -> int:
    args = parse_args()
    if not in_world():
        prepare(args)
    if args.world == 1:
        return sp_train(args)
    return run_world(lambda: sp_train(args), args.world)


if __name__ == "__main__":
    raise SystemExit(main())
