"""The port's command line: ``python -m bpe_transformer_tpu_torch.training.cli
{train,train-tokenizer,tokenize,eval,generate,serve,route,control,fleet,incident}
[...]``.

``train`` takes the JAX package's ``bpe-tpu train`` flags that the
single-device loop supports (data, model, schedule and cadence flags, see
:func:`build_parser`), plus ``--resume``, ``--device`` (default ``cuda``) and
the kernel knobs ``--attention-impl`` / ``--ffn-impl``, and prints the
summary as one JSON line.

``train-tokenizer``, ``tokenize``, ``eval``, ``generate`` and ``serve`` take
the JAX package's flags and exit codes (2 on a flag combination it refuses
before loading anything), plus ``--device`` on the three that run the model.
Differences from the JAX package:

* a checkpoint's stored config keeps its kernel knobs (``attention_impl``,
  ``ffn_impl``, ``decode_attention_impl``): every port kernel runs on the
  card and its plain version on the CPU, so none of them can fail to
  lower; only the training knobs (remat, scan) are reset, as JAX does;
* ``generate --print-ids`` prints ``{"text", "token_ids"}`` as one JSON line;
* ``serve`` has no ``--compile-cache`` (no XLA programs) and no TPU
  block-size check.

``route``, ``control``, ``fleet`` and ``incident`` hand the rest of the
command line to the ``main`` of the torch-free fleet modules
(``serving/router.py``, ``serving/controller.py``, ``telemetry/fleet.py``,
``telemetry/incident.py``), whose parsers define their flags; they run on a
host without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time
from pathlib import Path

import numpy as np

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


def _specials(args) -> list[str]:
    """Resolve --special-token: appended values replace the default rather
    than extending it (argparse appends onto list defaults)."""
    return args.special_token if args.special_token else ["<|endoftext|>"]


def cmd_train_tokenizer(args) -> int:
    from bpe_transformer_tpu_torch.tokenization import BPETrainer

    trainer = BPETrainer(vocab_size=args.vocab_size, special_tokens=_specials(args))
    trainer.train(args.input, n_workers=args.workers)
    trainer.save_trainer(Path(args.output_dir))
    print(
        f"trained vocab of {len(trainer.vocab)} tokens "
        f"({len(trainer.merges)} merges) -> {args.output_dir}"
    )
    return 0


def _load_tokenizer(tokenizer_dir: str, special_tokens: list[str]):
    from bpe_transformer_tpu_torch.tokenization import BPETokenizer

    d = Path(tokenizer_dir)
    return BPETokenizer.from_files(d / "vocab.pkl", d / "merges.pkl", special_tokens=special_tokens)


def cmd_tokenize(args) -> int:
    from bpe_transformer_tpu_torch.data import tokenize_to_memmap

    tokenizer = _load_tokenizer(args.tokenizer_dir, _specials(args))
    tokens = tokenize_to_memmap(tokenizer, args.input, args.output, args.dtype)
    print(f"wrote {len(tokens):,} tokens ({args.dtype}) -> {args.output}")
    return 0


def _load_model_config(args, stored: dict | None = None) -> ModelConfig:
    """Resolve the architecture: explicit JSON > explicit --preset >
    checkpoint-stored config > the preset default.  The stored config keeps
    its kernel knobs and drops its training-only ones (module docstring)."""
    if args.model_config:
        return ModelConfig.from_json(args.model_config)
    if args.preset is not None:
        return PRESETS[args.preset]
    if stored:
        cfg = ModelConfig.from_dict(stored)
        return dataclasses.replace(cfg, remat=False, remat_policy="none", scan_layers=False)
    return PRESETS["tinystories-4l"]


def _load_inference_state(args, *, need_tokenizer: bool):
    """The checkpoint restore + config resolution (+ tokenizer load) that
    eval, generate and serve share: ``(payload, model_config, tokenizer)``,
    ``tokenizer`` None when not requested."""
    from bpe_transformer_tpu_torch.checkpointing import load_checkpoint

    payload = load_checkpoint(args.checkpoint)
    model_config = _load_model_config(args, stored=payload.get("extra", {}).get("model_config"))
    tokenizer = None
    if need_tokenizer:
        tokenizer = _load_tokenizer(args.tokenizer_dir, _specials(args))
    return payload, model_config, tokenizer


def cmd_eval(args) -> int:
    import torch

    from bpe_transformer_tpu_torch.checkpointing import training_state
    from bpe_transformer_tpu_torch.data import get_batch, load_token_file
    from bpe_transformer_tpu_torch.training.train_step import make_eval_step

    payload, model_config, _ = _load_inference_state(args, need_tokenizer=False)
    params, _ = training_state({"params": payload["params"]}, device=args.device)
    eval_step = make_eval_step(model_config)
    data = load_token_file(args.data, args.dtype)
    rng = np.random.default_rng(args.seed)
    dev = params["token_embeddings"].device
    losses = []
    for _ in range(args.batches):
        x, y = get_batch(data, args.batch_size, model_config.context_length, rng)
        losses.append(float(eval_step(params, torch.as_tensor(x, device=dev),
                                      torch.as_tensor(y, device=dev))))
    print(json.dumps({"val_loss": float(np.mean(losses)), "batches": args.batches}))
    return 0


def cmd_generate(args) -> int:
    from bpe_transformer_tpu_torch.training.sampling import generate_prompt_ids

    payload, model_config, tokenizer = _load_inference_state(args, need_tokenizer=True)
    if args.decode_attention:
        model_config = dataclasses.replace(model_config,
                                           decode_attention_impl=args.decode_attention)
    ids = generate_prompt_ids(
        payload["params"], model_config, tokenizer, prompt=args.prompt,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed, device=args.device,
    )
    text = args.prompt + tokenizer.decode(ids)
    print(json.dumps({"text": text, "token_ids": ids}) if args.print_ids else text)
    return 0


def _serve_flag_error(args) -> str | None:
    """The flag combinations ``serve`` refuses before loading anything."""
    if args.prompts_file and not args.output:
        return "--prompts-file needs --output"
    if args.speculate:
        if args.speculate < 1:
            return f"--speculate must be >= 1, got {args.speculate}"
        if not args.paged:
            return ("--speculate needs --paged (the verify pass scores through the paged "
                    "scatter; the KV rewind lives in the block pool)")
        if not args.draft_config:
            return ("--speculate needs --draft-config (a DraftSpec JSON: tiny geometry or "
                    "truncate_layers)")
    elif args.draft_config:
        return "--draft-config needs --speculate K"
    if args.kv_dtype == "int8" and not args.paged:
        return "--kv-dtype int8 needs --paged (the int8 scale pools live in the block pool)"
    if args.decode_attention == "paged" and not args.paged:
        return "--decode-attention paged needs --paged (the kernel reads through the block table)"
    if args.role != "both" and not args.paged:
        return f"--role {args.role} needs --paged (KV migration payloads are block chains)"
    if args.evacuate_to and not args.paged:
        return ("--evacuate-to needs --paged (drain evacuation exports in-flight sessions as "
                "KV block chains)")
    if args.role == "prefill" and args.prompts_file:
        return ("--role prefill cannot run offline batch mode (it never decodes; prefixes "
                "stream out over /kv/export)")
    return None


def cmd_serve(args) -> int:
    """Continuous-batching inference: offline batch mode when
    ``--prompts-file`` is given, else the HTTP JSON endpoint."""
    from bpe_transformer_tpu_torch.models.transformer import params_from_jax
    from bpe_transformer_tpu_torch.serving.server import ServingEngine, make_http_server
    from bpe_transformer_tpu_torch.serving.spec import DraftSpec
    from bpe_transformer_tpu_torch.telemetry import MetricsLogger, Telemetry, run_manifest

    error = _serve_flag_error(args)
    draft_spec = None
    if error is None and args.speculate:
        try:
            draft_spec = DraftSpec.from_json(args.draft_config)
        except (OSError, ValueError, TypeError) as exc:
            error = f"bad --draft-config: {exc}"
    if error is not None:
        print(f"serve: {error}", file=sys.stderr)
        return 2
    payload, model_config, tokenizer = _load_inference_state(args, need_tokenizer=True)
    if args.decode_attention:
        model_config = dataclasses.replace(model_config,
                                           decode_attention_impl=args.decode_attention)
    if args.weight_dtype == "int8" and model_config.ffn_type == "moe":
        print("serve: --weight-dtype int8 does not cover MoE expert stacks; serve this "
              "config at the activation width", file=sys.stderr)
        return 2
    if draft_spec is not None:
        try:
            draft_spec.validate_against(model_config)
        except ValueError as exc:
            print(f"serve: {exc}", file=sys.stderr)
            return 2
    stop_id = None
    if tokenizer.special_tokens:
        stop_id = tokenizer.encode(tokenizer.special_tokens[0])[0]

    logger = MetricsLogger(jsonl_path=args.metrics_jsonl, max_bytes=args.metrics_max_bytes)
    telemetry = Telemetry(sink=logger.log) if args.metrics_jsonl else None
    # Built whether or not a JSONL is written: /statusz serves it.
    manifest = run_manifest(kind="serve", model_config=model_config)
    if telemetry is not None:
        telemetry.emit(manifest)
    try:
        serving = ServingEngine(
            params_from_jax(payload["params"], args.device), model_config, tokenizer=tokenizer, slots=args.slots,
            max_queue=args.max_queue, max_wait_s=args.max_wait, default_stop_id=stop_id,
            default_max_new_tokens=args.max_new_tokens, telemetry=telemetry,
            manifest=manifest, paged=args.paged, block_size=args.block_size,
            num_kv_blocks=args.num_kv_blocks, prefill_chunk=args.prefill_chunk,
            prefill_token_budget=args.prefill_budget, prefix_cache=not args.no_prefix_cache,
            kv_dtype=None if args.kv_dtype == "act" else args.kv_dtype,
            weight_dtype=None if args.weight_dtype == "act" else args.weight_dtype,
            fused_sampling=args.fused_sampling, speculate_k=args.speculate,
            draft_spec=draft_spec, role=args.role,
            flightrecorder_capacity=args.flightrecorder_capacity, device=args.device,
        )
        with serving:
            if args.prompts_file:
                results = serving.serve_batch_file(
                    args.prompts_file, args.output, max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                    seed=args.seed,
                )
                reasons: dict[str, int] = {}
                for r in results:
                    reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
                print(json.dumps({"prompts": len(results), "finish_reasons": reasons,
                                  "output": args.output, **serving.stats()}))
                return 0
            server = make_http_server(serving, host=args.host, port=args.port)
            host, port = server.server_address[:2]

            # SIGTERM drains like Ctrl-C: out of serve_forever (no new
            # connections), then every queued and in-flight request
            # finishes before close() writes the footer.
            def _sigterm(signum, frame):
                raise KeyboardInterrupt

            signal.signal(signal.SIGTERM, _sigterm)
            print(
                f"serving on http://{host}:{port}  (slots={args.slots}, "
                f"queue={args.max_queue}, role={args.role}; POST /generate /kv/export "
                "/kv/import, GET /healthz /metrics /statusz; Ctrl-C/SIGTERM drains then stops)",
                flush=True,
            )
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.shutdown()
                drained = serving.drain(timeout_s=args.drain_timeout,
                                        evacuate_urls=args.evacuate_to)
                # Every finished request's answer is written before exit
                # (an evacuated session's comes back from its relay).
                deadline = time.monotonic() + 10.0
                while drained and server.handlers_in_flight() and time.monotonic() < deadline:
                    time.sleep(0.01)
                print(
                    "drained cleanly"
                    + (" (sessions evacuated over the wire)" if args.evacuate_to else "")
                    if drained
                    else f"drain timed out after {args.drain_timeout}s; cancelling stragglers",
                    flush=True,
                )
                server.server_close()
            return 0
    finally:
        logger.close()


#: Commands served by a torch-free fleet module: the rest of the command
#: line goes to the module's ``main(argv)``, whose parser alone defines the
#: command's flags.
FLEET_COMMANDS = {
    "route": ("bpe_transformer_tpu_torch.serving.router",
              "health-aware HTTP router over serve replicas, with two-tier "
              "prefill/decode scheduling"),
    "control": ("bpe_transformer_tpu_torch.serving.controller",
                "self-healing fleet control loop over the fleet aggregator and the router"),
    "fleet": ("bpe_transformer_tpu_torch.telemetry.fleet",
              "fleet aggregator over serve replicas and the router: fleet/slo/alert "
              "telemetry, fleet /statusz and /metrics"),
    "incident": ("bpe_transformer_tpu_torch.telemetry.incident",
                 "postmortem bundler: sweep the router's and replicas' flight recorders "
                 "into one JSONL bundle"),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.training.cli",
        description="PyTorch + CUDA port of the bpe-tpu command line (one device)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    special = dict(action="append", default=None, help='repeatable; default: ["<|endoftext|>"]')
    device = dict(default="cuda", help='"cuda" (default) or "cpu"')

    p = sub.add_parser("train-tokenizer", help="train a BPE tokenizer")
    p.add_argument("--input", required=True)
    p.add_argument("--vocab-size", type=int, required=True)
    p.add_argument("--special-token", **special)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--workers", type=int, default=None)
    p.set_defaults(fn=cmd_train_tokenizer)

    p = sub.add_parser("tokenize", help="encode a corpus to a binary token file")
    p.add_argument("--input", required=True)
    p.add_argument("--tokenizer-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dtype", default="uint16", choices=["uint16", "uint32"])
    p.add_argument("--special-token", **special)
    p.set_defaults(fn=cmd_tokenize)

    p = sub.add_parser("eval", help="evaluate a checkpoint's loss")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--dtype", default="uint16", choices=["uint16", "uint32"])
    # default None: prefer the config stored inside the checkpoint.
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--model-config", default=None)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", **device)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("generate", help="sample text from a checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer-dir", required=True)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--model-config", default=None)
    p.add_argument("--prompt", default="")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: keep the smallest prefix of probability mass >= p")
    p.add_argument("--special-token", **special)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decode-attention", choices=["xla", "pallas"], default=None,
                   help="decode-step cache attention: pallas = the flash-decoding kernel; "
                   "default: the checkpoint config's")
    p.add_argument("--print-ids", action="store_true",
                   help='print {"text", "token_ids"} as one JSON line instead of the text')
    p.add_argument("--device", **device)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("serve", help="continuous-batching inference: HTTP JSON endpoint, or "
                       "offline batch mode with --prompts-file/--output")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer-dir", required=True)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--model-config", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="HTTP port (0: ephemeral)")
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent in-flight generations (KV-cache pool capacity)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission queue capacity; beyond it requests get 503")
    p.add_argument("--max-wait", type=float, default=0.0,
                   help="seconds an idle engine may hold admissions to batch prefills")
    p.add_argument("--max-new-tokens", type=int, default=128,
                   help="default per-request generation budget")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompts-file", default=None,
                   help="offline batch mode: one prompt per line in, completions JSONL out "
                   "(--output); no HTTP server")
    p.add_argument("--output", default=None, help="JSONL results path for --prompts-file")
    p.add_argument("--metrics-jsonl", default=None,
                   help="append serving telemetry (request spans, engine records) to this file")
    p.add_argument("--metrics-max-bytes", type=int, default=None, metavar="BYTES",
                   help="size-based JSONL rotation (see telemetry/sinks.py)")
    p.add_argument("--flightrecorder-capacity", type=int, default=256, metavar="EVENTS",
                   help="flight-recorder ring size: the last N scheduling decisions kept "
                   "for GET /debug/flightrecorder and kind=blackbox dumps")
    p.add_argument("--drain-timeout", type=float, default=30.0, metavar="SECONDS",
                   help="on Ctrl-C/SIGTERM: stop accepting, then wait up to this long for "
                   "queued and in-flight requests before cancelling stragglers")
    p.add_argument("--paged", action="store_true",
                   help="paged KV memory: block pool with radix prefix sharing and chunked "
                   "prefill")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV block size in tokens (with --paged)")
    p.add_argument("--num-kv-blocks", type=int, default=None,
                   help="KV pool capacity in blocks (with --paged)")
    p.add_argument("--prefill-chunk", type=int, default=None, metavar="TOKENS",
                   help="chunked prefill chunk size (with --paged)")
    p.add_argument("--prefill-budget", type=int, default=None, metavar="TOKENS",
                   help="max prefill tokens between consecutive decode ticks (with --paged)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the radix prefix cache (with --paged)")
    p.add_argument("--kv-dtype", choices=("act", "int8"), default="act",
                   help="KV block storage width (with --paged)")
    p.add_argument("--decode-attention", choices=("xla", "pallas", "paged"), default=None,
                   help="decode-step attention: 'paged' (with --paged) reads through the "
                   "block table; 'pallas' is flash decode over the gathered cache; default: "
                   "the checkpoint config's")
    p.add_argument("--weight-dtype", choices=("act", "int8"), default="act",
                   help="serving weight storage width: 'int8' quantizes the matmul weights "
                   "per output channel")
    p.add_argument("--fused-sampling", action="store_true",
                   help="end each decode tick with the fused head + filter + sample kernel")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="speculative decoding (with --paged + --draft-config)")
    p.add_argument("--draft-config", default=None, metavar="JSON",
                   help="DraftSpec JSON for --speculate")
    p.add_argument("--role", choices=("prefill", "decode", "both"), default="both",
                   help="fleet role (with --paged): 'prefill' runs the chunk machine and hands "
                   "finished prefixes out over POST /kv/export; 'decode' grafts them from POST "
                   "/kv/import; 'both' (default) serves everything; pair with route "
                   "--prefill-threshold")
    p.add_argument("--evacuate-to", action="append", default=None, metavar="HOST:PORT",
                   help="peer replica base URL for drain evacuation (repeatable, with "
                   "--paged): on Ctrl-C/SIGTERM in-flight sessions relay to a peer's "
                   "/kv/import and queued requests replay on its /generate")
    p.add_argument("--special-token", **special)
    p.add_argument("--device", **device)
    p.set_defaults(fn=cmd_serve)

    for name, (_, text) in FLEET_COMMANDS.items():
        # Its flags are the module's: ``main`` hands them over unparsed.
        sub.add_parser(name, help=f"{text}; torch-free", add_help=False)

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
    import importlib

    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if args.command in FLEET_COMMANDS:
        module = importlib.import_module(FLEET_COMMANDS[args.command][0])
        return module.main(rest)
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
