"""The port's command line: ``python -m bpe_transformer_tpu_torch.training.cli
train --data tokens.bin [...]``.

``train`` takes the JAX package's ``bpe-tpu train`` flags that the
single-device loop supports (data, model, schedule and cadence flags, see
:func:`build_parser`), plus ``--resume``, ``--device`` (default ``cuda``) and
the kernel knobs ``--attention-impl`` / ``--ffn-impl``, and prints the
summary as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from bpe_transformer_tpu_torch.models import config as model_configs
from bpe_transformer_tpu_torch.models.config import ModelConfig

PRESETS = {
    "ts-test": model_configs.TS_TEST_CONFIG,
    "tinystories-4l": model_configs.TINYSTORIES_4L,
    "tinystories-12l": model_configs.TINYSTORIES_12L,
    "tinystories-moe": model_configs.TINYSTORIES_MOE,
    "gpt2-small-32k": model_configs.GPT2_SMALL_32K,
    "gpt2-medium": model_configs.GPT2_MEDIUM,
}


def _model_config(args) -> ModelConfig:
    cfg = ModelConfig.from_json(args.model_config) if args.model_config else PRESETS[args.preset]
    knobs = {}
    if args.attention_impl:
        knobs["attention_impl"] = args.attention_impl
    if args.ffn_impl:
        knobs["ffn_impl"] = args.ffn_impl
    return dataclasses.replace(cfg, **knobs) if knobs else cfg


def cmd_train(args) -> int:
    from bpe_transformer_tpu_torch.data import load_token_file
    from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams

    model_config = _model_config(args)
    hparams = TrainHParams(
        max_learning_rate=args.lr,
        min_learning_rate=args.min_lr if args.min_lr is not None else args.lr / 10,
        warmup_iters=args.warmup,
        cosine_cycle_iters=args.lr_cycle if args.lr_cycle else args.steps,
        weight_decay=args.weight_decay,
        grad_clip_norm=args.grad_clip,
    )
    loop = LoopConfig(
        steps=args.steps,
        batch_size=args.batch_size,
        log_every=args.log_every,
        eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        keep_checkpoints=args.keep_checkpoints,
        seed=args.seed,
    )
    train_data = load_token_file(args.data, args.dtype)
    val_data = load_token_file(args.val_data, args.dtype) if args.val_data else None
    summary = train(
        model_config, hparams, loop, train_data, val_data,
        resume_from=args.resume, device=args.device,
    )
    print(json.dumps({k: v for k, v in summary.items() if k != "history"}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli",
        description="PyTorch + CUDA port of the bpe-tpu trainer (one device)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train", help="pretrain a transformer LM on one device")
    p.add_argument("--data", required=True)
    p.add_argument("--val-data", default=None)
    p.add_argument("--dtype", default="uint16", choices=["uint16", "uint32"])
    p.add_argument("--preset", default="tinystories-4l", choices=sorted(PRESETS))
    p.add_argument("--model-config", default=None, help="JSON config path")
    p.add_argument("--attention-impl", default=None, choices=["xla", "flash", "flash_fused"],
                   help="attention kernel knob (default: the config's)")
    p.add_argument("--ffn-impl", default=None, choices=["xla", "pallas"],
                   help="FFN kernel knob (default: the config's)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--min-lr", type=float, default=None)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--lr-cycle", type=int, default=None)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--keep-checkpoints", type=int, default=None, metavar="N")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="checkpoint file, or a directory holding latest.ckpt")
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
