"""The port's command line: ``python -m bpe_transformer_tpu_torch.training.cli
{train,train-tokenizer,tokenize,eval,generate,serve,warmup,profile,route,control,
fleet,incident,report,monitor,verify-checkpoint} [...]``.

``train`` takes the JAX package's ``bpe-tpu train`` flags that the
single-device loop supports (see :func:`build_parser`): data, model,
schedule and cadence flags, the MFU knobs (``--remat-policy``,
``--scan-layers``, ``--grads-dtype``), the telemetry stream and its taps
(``--metrics-jsonl``, ``--wandb-project``, ``--health-stats``,
``--dynamics-every``, ``--attribution-every``), the watchdog and NaN
rollback (``--watchdog*``, ``--max-rollbacks``, ``--recovery-min-progress``),
``--supervise`` with ``--max-restarts`` and ``--restart-backoff``,
``--profile-trace``, ``--inner-steps``, ``--prefetch``,
``--async-checkpoint``, ``--grad-accum-steps`` and ``--compile-cache``; plus
``--resume``, ``--device`` (default ``cuda``) and the kernel knobs
``--attention-impl`` / ``--ffn-impl``.  It prints the summary as one JSON
line and exits with ``EXIT_PREEMPTED`` (75) after a SIGTERM/SIGINT stop.
``--supervise`` turns the process into the torch-free parent of
``resilience/supervisor.py``, which re-enters this command without
``--supervise`` in a child and respawns it with ``--resume`` on a crash or a
preemption.

``profile`` is the JAX package's performance attribution without a training
job: the analytic roofline of the train step (and, with ``--serve``, of the
serving prefill ladder and decode tick), with the card's verdicts from the
``utils/flops.py`` peak table, and the measured compute / host-gap split
(``--measure N``).  ``warmup`` builds the CUDA sources that the given
serving flags (or ``--train``) launch into ``--compile-cache DIR``, where
``train --compile-cache`` and ``serve --compile-cache`` then find them
(``utils/compile_cache.py``: the port's compiled artifacts are its ``nvcc``
builds, not XLA programs); it prints the JAX package's JSON keys, with
``programs_compiled`` the sources built now and ``cache_hits`` those found
built.

``train-tokenizer``, ``tokenize``, ``eval``, ``generate`` and ``serve`` take
the JAX package's flags and exit codes (2 on a flag combination it refuses
before loading anything), plus ``--device`` on the three that run the model.
Differences from the JAX package:

* a checkpoint's stored config keeps its kernel knobs (``attention_impl``,
  ``ffn_impl``, ``decode_attention_impl``): every port kernel runs on the
  card and its plain version on the CPU, so none of them can fail to
  lower; only the training knobs (remat, scan) are reset, as JAX does;
* ``generate --print-ids`` prints ``{"text", "token_ids"}`` as one JSON line;
* ``serve`` and ``warmup`` have no TPU block-size check;
* ``warmup`` and ``profile`` take ``--device``: on the CPU the plain
  versions run and no kernel is built.

``route``, ``control``, ``fleet``, ``incident``, ``report``, ``monitor`` and
``verify-checkpoint`` hand the rest of the command line to the ``main`` of
a torch-free module (``serving/router.py``, ``serving/controller.py``,
``telemetry/fleet.py``, ``telemetry/incident.py``, ``telemetry/report.py``,
``telemetry/monitor.py``, ``resilience/integrity.py``), whose parser
defines the command's flags; they run on a host without a card.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _add_mfu_knob_flags(p) -> None:
    """The training execution knobs that ``train``, ``warmup --train`` and
    ``profile`` share (the JAX package's flags)."""
    p.add_argument("--remat-policy", default=None,
                   choices=["none", "full", "dots_saveable", "save_attn"],
                   help="activation rematerialization in the backward; default: the model "
                   "config's")
    p.add_argument("--scan-layers", action="store_true",
                   help="run the layer stack as one loop over stacked block params")
    p.add_argument("--grads-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="gradient width at the reduction boundary")


def _apply_mfu_knobs(model_config: ModelConfig, args) -> ModelConfig:
    """Fold ``--remat-policy`` / ``--scan-layers`` into the config, with the
    JAX package's note for a config still using the deprecated ``remat``."""
    if model_config.remat and not args.remat_policy:
        print('note: ModelConfig.remat is deprecated — treating remat=true as '
              'remat_policy="full"; set remat_policy (or --remat-policy) explicitly',
              file=sys.stderr)
    overrides = {}
    if args.remat_policy:
        overrides.update(remat_policy=args.remat_policy, remat=False)
    if args.scan_layers:
        overrides["scan_layers"] = True
    return dataclasses.replace(model_config, **overrides) if overrides else model_config


def cmd_train(args) -> int:
    if args.supervise:
        # This process becomes the torch-free parent; the child owns the card.
        from bpe_transformer_tpu_torch.resilience.supervisor import supervise

        if not args.checkpoint_dir:
            print("train --supervise needs --checkpoint-dir (restart-with-resume is the "
                  "whole point)", file=sys.stderr)
            return 2
        return supervise(getattr(args, "_argv", None) or ["train"], args.checkpoint_dir,
                         max_restarts=args.max_restarts, backoff_s=args.restart_backoff)

    from bpe_transformer_tpu_torch.data import load_token_file
    from bpe_transformer_tpu_torch.resilience.signals import EXIT_PREEMPTED
    from bpe_transformer_tpu_torch.telemetry.timing import profile_trace
    from bpe_transformer_tpu_torch.training.loop import LoopConfig, train
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams

    if args.compile_cache:
        from bpe_transformer_tpu_torch.utils.compile_cache import enable_compile_cache

        enable_compile_cache(args.compile_cache)
    model_config = _apply_mfu_knobs(_model_config(args), args)
    hparams = TrainHParams(
        max_learning_rate=args.lr,
        min_learning_rate=args.min_lr if args.min_lr is not None else args.lr / 10,
        warmup_iters=args.warmup,
        cosine_cycle_iters=args.lr_cycle if args.lr_cycle else args.steps,
        weight_decay=args.weight_decay,
        grad_clip_norm=args.grad_clip,
        grads_dtype=args.grads_dtype,
    )
    loop = LoopConfig(
        steps=args.steps,
        batch_size=args.batch_size,
        log_every=args.log_every,
        eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        metrics_jsonl=args.metrics_jsonl,
        wandb_project=args.wandb_project,
        health_stats=args.health_stats,
        dynamics_every=args.dynamics_every,
        attribution_every=args.attribution_every,
        watchdog=args.watchdog,
        watchdog_factor=args.watchdog_factor,
        watchdog_policy=args.watchdog_policy,
        max_rollbacks=args.max_rollbacks,
        recovery_min_progress=args.recovery_min_progress,
        keep_checkpoints=args.keep_checkpoints,
        seed=args.seed,
        inner_steps=args.inner_steps,
        prefetch=args.prefetch,
        grad_accum_steps=args.grad_accum_steps,
        async_checkpoint=args.async_checkpoint,
    )
    train_data = load_token_file(args.data, args.dtype)
    val_data = load_token_file(args.val_data, args.dtype) if args.val_data else None
    trace = (profile_trace(args.profile_trace, args.device) if args.profile_trace
             else contextlib.nullcontext())
    with trace:
        summary = train(
            model_config, hparams, loop, train_data, val_data,
            resume_from=args.resume, device=args.device,
        )
    print(json.dumps({k: v for k, v in summary.items() if k != "history"}))
    # A SIGTERM/SIGINT stop (emergency checkpoint written) exits with its own
    # code, so a supervisor respawns with --resume.
    return EXIT_PREEMPTED if summary.get("preempted") else 0


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
    if args.compile_cache:
        from bpe_transformer_tpu_torch.utils.compile_cache import enable_compile_cache

        enable_compile_cache(args.compile_cache)
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


def _warmup_flag_error(args) -> str | None:
    """The flag combinations ``warmup`` refuses (the JAX package's)."""
    if args.train:
        if args.speculate or args.paged or args.role != "both":
            return ("--train warms the training-step programs; it composes with serving "
                    "flags in separate invocations, not one")
        if args.grad_accum_steps > 1 and args.inner_steps > 1:
            return "--grad-accum-steps and --inner-steps are mutually exclusive (as in train)"
        if args.grad_accum_steps > 1 and args.batch_size % args.grad_accum_steps:
            return (f"--batch-size {args.batch_size} must be a multiple of "
                    f"--grad-accum-steps {args.grad_accum_steps}")
        return None
    if args.role != "both" and not args.paged:
        return f"--role {args.role} needs --paged"
    if args.role == "prefill" and args.speculate:
        return ("--role prefill never ticks; speculation lives on decode replicas (warm "
                "them with --role decode)")
    if args.speculate:
        if not args.paged:
            return "--speculate needs --paged"
        if not args.draft_config:
            return "--speculate needs --draft-config"
    elif args.draft_config:
        return "--draft-config needs --speculate K"
    return None


def cmd_warmup(args) -> int:
    """Build the CUDA sources that ``serve`` with the same flags (or, with
    ``--train``, ``train``) launches into the ``--compile-cache`` directory,
    so a restarted replica or a respawned trainer loads them instead of
    compiling; prints one JSON line with the JAX package's keys."""
    from bpe_transformer_tpu_torch.device import resolve_device
    from bpe_transformer_tpu_torch.serving.engine import default_prefill_buckets
    from bpe_transformer_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
        kernel_sources,
    )

    error = _warmup_flag_error(args)
    draft_spec = None
    if error is None and args.speculate:
        from bpe_transformer_tpu_torch.serving.spec import DraftSpec

        try:
            draft_spec = DraftSpec.from_json(args.draft_config)
        except (OSError, ValueError, TypeError) as exc:
            error = f"bad --draft-config: {exc}"
    if error is not None:
        print(f"warmup: {error}", file=sys.stderr)
        return 2
    stored = None
    if args.checkpoint:
        from bpe_transformer_tpu_torch.checkpointing import load_checkpoint

        stored = load_checkpoint(args.checkpoint).get("extra", {}).get("model_config")
    model_config = _load_model_config(args, stored=stored)
    if args.train:
        model_config = _apply_mfu_knobs(model_config, args)
    elif args.decode_attention:
        model_config = dataclasses.replace(model_config,
                                           decode_attention_impl=args.decode_attention)
    widths = {"act": [None], "int8": ["int8"], "both": [None, "int8"]}
    weight_dtypes = widths[args.weight_dtype]
    if not args.train:
        if args.weight_dtype in ("int8", "both") and model_config.ffn_type == "moe":
            print("warmup: --weight-dtype int8 does not cover MoE expert stacks",
                  file=sys.stderr)
            return 2
        if draft_spec is not None:
            try:
                draft_spec.validate_against(model_config)
            except ValueError as exc:
                print(f"warmup: {exc}", file=sys.stderr)
                return 2

    device = resolve_device(args.device)
    cache_dir = enable_compile_cache(args.compile_cache)
    needed = set()
    if device.type == "cuda":
        # On the CPU the plain versions run: there is nothing to build.
        needed = kernel_sources(model_config, train=args.train, paged=args.paged,
                                weight_dtypes=weight_dtypes,
                                fused_sampling=args.fused_sampling, role=args.role)
    from bpe_transformer_tpu_torch.kernels import _build

    out = _build.build_dir()
    found = sorted(n for n in needed if (out / f"lib{n}.so").exists())
    built = sorted(_build.build_all(needed)) if needed else []
    common = {
        "programs_compiled": len(built),
        "sources": sorted(needed),
        "cache_dir": str(cache_dir),
        "cache_hits": len(found),
    }
    if args.train:
        print(json.dumps({
            "mode": "train",
            **common,
            "batch_size": args.batch_size,
            "grad_accum_steps": args.grad_accum_steps,
            "inner_steps": args.inner_steps,
            "health_stats": args.health_stats,
            "remat_policy": model_config.resolved_remat_policy,
            "scan_layers": model_config.scan_layers,
            "grads_dtype": args.grads_dtype,
        }))
        return 0
    ctx = model_config.context_length
    buckets = list(default_prefill_buckets(ctx))
    if args.paged:
        chunk = min(args.prefill_chunk or ctx, ctx)
        buckets = [b for b in buckets if b < chunk] + [chunk]
    kv_dtypes = widths[args.kv_dtype]
    print(json.dumps({
        **common,
        "buckets": buckets,
        "role": args.role,
        "engine": "spec" if args.speculate else "paged" if args.paged else "dense",
        "speculate": args.speculate or None,
        "decode_attention": model_config.decode_attention_impl,
        "kv_dtypes": [d or "act" for d in kv_dtypes] if args.paged else None,
        "weight_dtypes": [d or "act" for d in weight_dtypes],
        "fused_sampling": args.fused_sampling,
    }))
    return 0


def cmd_profile(args) -> int:
    """Performance attribution without a training job: the analytic
    roofline of the train step (and, with ``--serve``, of the serving
    prefill ladder and decode tick) and, with ``--measure N > 0``, the
    measured compute / host-gap split; printed, and with
    ``--metrics-jsonl`` written as a ``kind="attribution"`` stream that
    ``report`` renders.  On the CPU the verdicts read ``unknown``."""
    import torch

    from bpe_transformer_tpu_torch.device import resolve_device
    from bpe_transformer_tpu_torch.models.transformer import init_params, params_from_jax
    from bpe_transformer_tpu_torch.optim import adamw_init
    from bpe_transformer_tpu_torch.telemetry import MetricsLogger, Telemetry, run_manifest
    from bpe_transformer_tpu_torch.telemetry.attribution import (
        StepProbe,
        device_kind_of,
        serving_program_costs,
    )
    from bpe_transformer_tpu_torch.training.train_step import TrainHParams
    from bpe_transformer_tpu_torch.utils.flops import peak_flops_per_chip, peak_hbm_bytes_per_sec

    device = resolve_device(args.device)
    if args.checkpoint:
        payload, model_config, _ = _load_inference_state(args, need_tokenizer=False)
        params = params_from_jax(payload["params"], device)
    else:
        model_config = _load_model_config(args)
        params = init_params(model_config, torch.Generator(device=device).manual_seed(args.seed),
                             device=device)
    model_config = _apply_mfu_knobs(model_config, args)
    opt_state = adamw_init(params)
    kind = device_kind_of(device)

    probe = StepProbe(model_config, TrainHParams(grads_dtype=args.grads_dtype),
                      batch_size=args.batch, iters=max(args.measure, 1), seed=args.seed,
                      device=device)
    rows = list(probe.program_costs(params, opt_state))
    if args.serve:
        rows += serving_program_costs(params, model_config, slots=args.slots)

    peak_f = peak_flops_per_chip(kind)
    peak_bw = peak_hbm_bytes_per_sec(kind)
    header = f"== cost model ({kind or device.type}"
    if peak_f and peak_bw:
        header += (f", peak {peak_f / 1e12:,.0f} TF/s / {peak_bw / 1e9:,.0f} GB/s"
                   f", ridge {peak_f / peak_bw:,.1f} flops/B")
    print(header + ") ==")
    print(f"  {'program':<18s}{'GFLOPs':>10s}{'MB moved':>10s}{'AI f/B':>9s}  verdict")

    def fmt(value, width, scale=1.0, digits=2):
        if value is None:
            return f"{'-':>{width}s}"
        return f"{value / scale:>{width},.{digits}f}"

    for row in rows:
        print(f"  {row['name']:<18s}" + fmt(row["flops"], 10, 1e9)
              + fmt(row["bytes_accessed"], 10, 2**20, 1)
              + fmt(row["arithmetic_intensity"], 9, 1.0, 1) + f"  {row['bound']}")

    record = None
    if args.measure > 0:
        wall = probe.loop_wall_step_s(params, opt_state, iters=args.measure)
        record = probe.attribution_record(params, opt_state, step=0, wall_step_s=wall, t=0.0,
                                          include_programs=True)
        record["programs"] = rows  # the serving ladder too, when costed
        print(f"== measured split ({args.measure} iters) ==")
        print(f"  wall {record['wall_step_s'] * 1e3:,.2f} ms/step  "
              f"device {record['device_step_s'] * 1e3:,.2f} ms "
              f"({record['device_time_from']}; probe fenced wall "
              f"{record['probe_wall_step_s'] * 1e3:,.2f} ms)  "
              f"compute {record['compute_frac']:.0%}  collective "
              f"{record['collective_frac']:.0%}  host gap {record['host_gap_frac']:.0%}")

    if args.metrics_jsonl:
        logger = MetricsLogger(jsonl_path=args.metrics_jsonl)
        try:
            telemetry = Telemetry(sink=logger.log)
            telemetry.emit(run_manifest(kind="profile", model_config=model_config,
                                        extra={"batch": args.batch, "measure": args.measure}))
            if record is not None:
                record["t"] = telemetry.now()
                telemetry.emit(record)
            telemetry.footer(clean=True)
        finally:
            logger.close()
        print(f"wrote attribution stream -> {args.metrics_jsonl}")

    if args.json:
        summary = {
            "metric": "attribution",
            "config": args.preset or "custom",
            "batch": args.batch,
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "device_kind": kind or "cpu",
            "programs": rows,
        }
        if record is not None:
            summary.update({k: record[k] for k in (
                "wall_step_s", "device_step_s", "compute_frac", "collective_frac",
                "host_gap_frac", "train_peak_hbm_bytes", "remat_policy", "grads_dtype",
                "scan_layers")})
        print(json.dumps(summary))
    return 0


#: Commands served by a torch-free module: the rest of the command line goes
#: to the module's ``main(argv)``, whose parser alone defines the command's
#: flags.
TORCH_FREE_COMMANDS = {
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
    "report": ("bpe_transformer_tpu_torch.telemetry.report",
               "summarize a telemetry metrics.jsonl; --compare/--baseline gate regressions "
               "with a nonzero exit, --trace writes a Chrome trace"),
    "monitor": ("bpe_transformer_tpu_torch.telemetry.monitor",
                "live view: tail a metrics.jsonl or poll a server's /metrics or a fleet's "
                "/statusz"),
    "verify-checkpoint": ("bpe_transformer_tpu_torch.resilience.integrity",
                          "verify a checkpoint against its CRC32 sidecar (exit 0 valid, "
                          "1 corrupt)"),
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
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build and load the CUDA kernels under DIR (fill it ahead with warmup)")
    p.add_argument("--special-token", **special)
    p.add_argument("--device", **device)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("warmup", help="build the CUDA sources that serve (or, with --train, "
                       "train) launches for these flags into a --compile-cache directory, so "
                       "a restart loads them instead of compiling")
    p.add_argument("--compile-cache", required=True, metavar="DIR",
                   help="kernel build directory (shared with serve/train --compile-cache)")
    p.add_argument("--checkpoint", default=None,
                   help="take the model config stored in this checkpoint")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--model-config", default=None, help="JSON config path")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--paged", action="store_true",
                   help="the paged engine's kernels instead of the dense engine's")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-kv-blocks", type=int, default=None)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--kv-dtype", choices=("act", "int8", "both"), default="both",
                   help="paged pool widths to warm (one kernel serves both)")
    p.add_argument("--decode-attention", choices=("xla", "pallas", "paged"), default=None)
    p.add_argument("--weight-dtype", choices=("act", "int8", "both"), default="act",
                   help="weight widths to warm: int8 adds the int8 matmul kernel")
    p.add_argument("--fused-sampling", action="store_true",
                   help="the fused head + sample tick tail")
    p.add_argument("--role", choices=("prefill", "decode", "both"), default="both",
                   help="warm only this role's kernels (with --paged): a prefill replica "
                   "never ticks")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="the speculative engine's kernels (with --paged + --draft-config)")
    p.add_argument("--draft-config", default=None, metavar="JSON")
    p.add_argument("--train", action="store_true",
                   help="the training step's kernels instead of a serving engine's")
    # The JAX package's --train flags: the schedule's and the cadences'
    # values change no kernel here, but its command lines run unchanged.
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--min-lr", type=float, default=None)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--lr-cycle", type=int, default=None)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--inner-steps", type=int, default=1)
    p.add_argument("--health-stats", action="store_true")
    p.add_argument("--dynamics-every", type=int, default=0)
    _add_mfu_knob_flags(p)
    p.add_argument("--device", **device)
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("profile", help="performance attribution without a training job: the "
                       "analytic roofline of the train step (and of the serving ladder with "
                       "--serve) and the measured compute/host-gap split")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--model-config", default=None, help="JSON config path")
    p.add_argument("--checkpoint", default=None,
                   help="profile a checkpoint's weights instead of a seeded init")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--measure", type=int, default=10, metavar="ITERS",
                   help="timed iterations for the measured split (0: the roofline only)")
    p.add_argument("--serve", action="store_true",
                   help="also cost the serving prefill ladder and the decode tick")
    p.add_argument("--slots", type=int, default=8, help="decode slots for --serve")
    p.add_argument("--metrics-jsonl", default=None,
                   help='write a manifest and a kind="attribution" record that report renders')
    p.add_argument("--json", action="store_true", help="print a JSON summary line")
    p.add_argument("--seed", type=int, default=0)
    _add_mfu_knob_flags(p)
    p.add_argument("--device", **device)
    p.set_defaults(fn=cmd_profile)

    for name, (_, text) in TORCH_FREE_COMMANDS.items():
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
    p.add_argument("--keep-checkpoints", type=int, default=None, metavar="N",
                   help="retention: keep the newest N step_*.ckpt snapshots (latest.ckpt's "
                   "target is never deleted, *.corrupt quarantines are kept)")
    p.add_argument("--metrics-jsonl", default=None,
                   help="write the telemetry stream (manifest, steps, spans, resources, "
                   "health/dynamics, footer) to this JSONL file; summarize with report")
    p.add_argument("--wandb-project", default=None,
                   help="log step metrics to this wandb project (requires wandb)")
    p.add_argument("--health-stats", action="store_true",
                   help="non-finite counts and per-layer-group grad/param norms in the step, "
                   "logged every --log-every")
    p.add_argument("--dynamics-every", type=int, default=0, metavar="N",
                   help='kind="dynamics" records every N steps (a multiple of --log-every): '
                   "per-layer norms, update ratios, activation stats, attention entropy, "
                   "NaN/Inf localization")
    p.add_argument("--attribution-every", type=int, default=0, metavar="N",
                   help='kind="attribution" records every N steps (a multiple of '
                   "--log-every): the measured compute / host-gap split of the step and, on "
                   "the first, the analytic roofline")
    p.add_argument("--watchdog", action="store_true",
                   help="flag hung steps and apply --watchdog-policy to a non-finite state "
                   "found at a log boundary")
    p.add_argument("--watchdog-factor", type=float, default=10.0)
    p.add_argument("--watchdog-policy", choices=["raise", "skip", "rollback"],
                   default="raise",
                   help='"raise": dump, then stop; "skip": record and go on; "rollback": '
                   "reload the last valid checkpoint and retry on other batches (needs "
                   "--checkpoint-dir)")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="abort after this many rollbacks without --recovery-min-progress "
                   "steps between them")
    p.add_argument("--recovery-min-progress", type=int, default=1, metavar="STEPS")
    p.add_argument("--supervise", action="store_true",
                   help="run under a torch-free parent that respawns a crashed or preempted "
                   "child with --resume from the newest valid checkpoint (needs "
                   "--checkpoint-dir)")
    p.add_argument("--max-restarts", type=int, default=5,
                   help="consecutive child failures without checkpoint progress before the "
                   "supervisor gives up")
    p.add_argument("--restart-backoff", type=float, default=1.0, metavar="SECONDS",
                   help="first restart delay, doubled per consecutive failure "
                   "(preemptions respawn at once)")
    p.add_argument("--profile-trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to DIR/trace.json")
    p.add_argument("--inner-steps", type=int, default=1,
                   help="optimizer updates a step call, with no host sync between them")
    p.add_argument("--prefetch", type=int, default=1, metavar="N",
                   help="batches sampled ahead on a worker thread (0: synchronous)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write checkpoints on a background thread after a synchronous copy "
                   "to the host")
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="microbatches per optimizer update (must divide --batch-size)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build and load the CUDA kernels under DIR (fill it ahead with "
                   "warmup --train)")
    _add_mfu_knob_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="checkpoint file, or a directory holding latest.ckpt")
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv: list[str] | None = None) -> int:
    import importlib

    raw_argv = list(argv) if argv is not None else sys.argv[1:]
    parser = build_parser()
    args, rest = parser.parse_known_args(raw_argv)
    if args.command in TORCH_FREE_COMMANDS:
        module = importlib.import_module(TORCH_FREE_COMMANDS[args.command][0])
        return module.main(rest)
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    # `train --supervise` respawns this exact command line as its child.
    args._argv = raw_argv
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
