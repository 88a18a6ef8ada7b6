"""Large-batch training on a memory budget on the port: gradient
accumulation under FSDP.

The port's counterpart of ``examples/7_grad_accum_fsdp.py``: one optimizer
update from 4 microbatches, each cut over the ``data`` axis, with every
parameter and moment sharded over that axis (``make_gspmd_train_step(...,
"fsdp", accum_steps=4)``: each rank holds 1/N of every leaf and gathers a
layer's weights when it runs it), checked against one full-batch step on a
single device.  The ranks are processes (``--world N``, one a card; gloo
ranks with ``--device cpu``); at ``--world 1`` (the default) the one rank
holds everything, and a wider world divides the state and each
microbatch's activations by N.  The config runs RoPE inside the flash
kernel (B5, backward B4) and the fused SwiGLU (B3).

Usage:
    python bpe_transformer_tpu_torch/examples/7_grad_accum_fsdp.py [--world N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from _common import add_device_args, rank0, report_launches, run_world

import numpy as np
import torch

from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG, init_params
from bpe_transformer_tpu_torch.models.transformer import abstract_params
from bpe_transformer_tpu_torch.optim import adamw_init
from bpe_transformer_tpu_torch.parallel import (
    make_gspmd_train_step,
    make_mesh,
    shard_batch,
    shard_params,
)
from bpe_transformer_tpu_torch.training import TrainHParams, make_train_step


def fsdp_update(args) -> int:
    config = dataclasses.replace(TS_TEST_CONFIG, vocab_size=512, context_length=32,
                                 attention_impl="flash_fused", flash_fused_min_seq=0,
                                 ffn_impl="pallas")
    hparams = TrainHParams(warmup_iters=2, cosine_cycle_iters=10)
    accum, micro = 4, 8  # effective batch 32, one microbatch's memory
    rng = np.random.default_rng(0)
    x = rng.integers(0, config.vocab_size, size=(accum * micro, 32), dtype=np.int64)
    y = np.roll(x, -1, axis=1)

    mesh = make_mesh({"data": args.world}, device=args.device)
    full = init_params(config, torch.Generator(device=mesh.device).manual_seed(0),
                       device=mesh.device)
    params = shard_params(full, mesh, "fsdp")
    opt_state = adamw_init(params)
    step = make_gspmd_train_step(config, hparams, mesh, "fsdp",
                                 example_params=abstract_params(config), accum_steps=accum)
    xs, ys = shard_batch((x.reshape(accum, micro, -1), y.reshape(accum, micro, -1)), mesh,
                         stacked=True)
    new_params, _, metrics = step(params, opt_state, xs, ys)
    lm_head = step.layout.gather(new_params)["lm_head"]
    if not rank0():
        return 0
    loss = float(metrics["loss"])
    print(f"fsdp + grad-accum update over {args.world} rank(s): loss {loss:.4f}, "
          f"effective batch {accum * micro} as {accum} microbatches of {micro}")

    # Oracle: the same update as ONE full-batch step on a single device.
    ref_params = init_params(config, torch.Generator(device=mesh.device).manual_seed(0),
                             device=mesh.device)
    ref_step = make_train_step(config, hparams)
    ref_new, _, ref_metrics = ref_step(ref_params, adamw_init(ref_params),
                                       torch.as_tensor(x, device=mesh.device),
                                       torch.as_tensor(y, device=mesh.device))
    ref_loss = float(ref_metrics["loss"])
    if abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
        raise SystemExit(f"loss {loss} != single-device {ref_loss}")
    err = float((lm_head - ref_new["lm_head"]).detach().abs().max())
    if err > 1e-5:
        raise SystemExit(f"lm_head differs from the single-device update by {err:.2e}")
    report_launches()
    print(f"matches the single-device full-batch update (atol 1e-5; max err {err:.1e})")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_device_args(parser, world=True)
    args = parser.parse_args()
    return run_world(lambda: fsdp_update(args), args.world)


if __name__ == "__main__":
    raise SystemExit(main())
