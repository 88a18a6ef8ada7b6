"""Pipeline parallelism on the port: GPipe stages over a (data, pp) mesh.

The port's counterpart of ``examples/9_pipeline_parallel.py``.  The layer
stack is cut into contiguous stages, one a rank along the ``pp`` axis;
microbatched activations flow rank to rank+1 and their gradients back,
the GPipe schedule written out over point-to-point sends
(``parallel/pp.py``: eager autograd cannot differentiate through JAX's
scan of ``ppermute``s, so the backward pipeline is written too).  The
update is checked against the single-device step, then a second update
accumulates gradients around the pipeline (each slice runs the whole
schedule).  The ranks are processes (``--world N``, one a card; gloo ranks
with ``--device cpu``): the mesh is ``{"data": N / pp, "pp": pp}`` with
``pp`` the largest divisor of N that divides the 4 layers.  At ``--world
1`` (the default) one rank runs every stage; a wider world holds 1/pp of
the layers a card.  The config runs B5, B4 and B3.

Usage:
    python bpe_transformer_tpu_torch/examples/9_pipeline_parallel.py [--world N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math

from _common import add_device_args, rank0, report_launches, run_world

import numpy as np
import torch

from bpe_transformer_tpu_torch.models import TS_TEST_CONFIG, init_params
from bpe_transformer_tpu_torch.optim import adamw_init
from bpe_transformer_tpu_torch.parallel import (
    PipelineLayout,
    init_pp_opt_state,
    make_mesh,
    make_pp_train_step,
    shard_batch,
    shard_pp_params,
    stack_pipeline_params,
)
from bpe_transformer_tpu_torch.training import TrainHParams, make_train_step

LAYERS = 4


def pipeline_update(args) -> int:
    pp = math.gcd(LAYERS, args.world)
    config = dataclasses.replace(TS_TEST_CONFIG, vocab_size=512, context_length=32,
                                 num_layers=LAYERS, attention_impl="flash_fused",
                                 flash_fused_min_seq=0, ffn_impl="pallas")
    hparams = TrainHParams(warmup_iters=2, cosine_cycle_iters=10)
    rng = np.random.default_rng(0)
    x = rng.integers(0, config.vocab_size, size=(16, 32), dtype=np.int64)
    y = np.roll(x, -1, axis=1)

    mesh = make_mesh({"data": args.world // pp, "pp": pp}, device=args.device)
    dev = mesh.device
    params = init_params(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    pp_params = shard_pp_params(stack_pipeline_params(params, pp), mesh)
    pp_opt = init_pp_opt_state(pp_params, mesh)
    step = make_pp_train_step(config, hparams, mesh, num_microbatches=4)
    xb, yb = shard_batch((x, y), mesh)
    new_pp, new_opt, metrics = step(pp_params, pp_opt, xb, yb)
    restored = PipelineLayout(config, mesh).dense(new_pp)
    loss = float(metrics["loss"])
    if rank0():
        print(f"GPipe update: {pp} stage(s) x {args.world // pp}-way dp, 4 microbatches, "
              f"loss {loss:.4f}")

        # Oracle: the same update as ONE single-device step.
        ref_params = init_params(config, torch.Generator(device=dev).manual_seed(0), device=dev)
        ref_new, _, ref_metrics = make_train_step(config, hparams)(
            ref_params, adamw_init(ref_params), torch.as_tensor(x, device=dev),
            torch.as_tensor(y, device=dev))
        ref_loss = float(ref_metrics["loss"])
        if abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
            raise SystemExit(f"loss {loss} != single-device {ref_loss}")
        err = float((restored["lm_head"] - ref_new["lm_head"]).detach().abs().max())
        if err > 2e-5:
            raise SystemExit(f"lm_head differs from the single-device update by {err:.2e}")
        print(f"matches the single-device update (atol 2e-5; max err {err:.1e})")

    # Gradient accumulation AROUND the pipeline: two slices, each running
    # the whole GPipe schedule, one optimizer update.
    accum_step = make_pp_train_step(config, hparams, mesh, num_microbatches=2, accum_steps=2)
    xs, ys = shard_batch((x.reshape(2, 8, -1), y.reshape(2, 8, -1)), mesh, stacked=True)
    _, _, metrics2 = accum_step(new_pp, new_opt, xs, ys)
    if rank0():
        print(f"pp + grad-accum update: loss {float(metrics2['loss']):.4f} "
              "(2 accumulation slices x full pipeline each)")
        report_launches()
        print("pipeline parallel OK")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_device_args(parser, world=True)
    args = parser.parse_args()
    return run_world(lambda: pipeline_update(args), args.world)


if __name__ == "__main__":
    raise SystemExit(main())
