"""KV-cached generation on the port: cache anatomy, the GQA shrink,
batched sampling through the kernels.

The port's counterpart of ``examples/8_kv_cache_decode.py``.  The
reference ships no sampler and no cache; this demo walks the port's decode
stack:

* a preallocated KV cache, written in place (one prefill of the batch,
  then one batched decode step a token: ``models/decode.py``
  ``generate_cached``);
* grouped-query attention shrinking the cache (and every token's cache
  read) by the query-group factor;
* the flash-decoding kernel (``decode_attention_impl="pallas"``, B1) each
  token, the flash prefill (``attention_impl="flash"``, B2) and the fused
  SwiGLU kernel (``ffn_impl="pallas"``, B3) in every FFN;
* temperature / top-k / top-p sampling with noise from a
  ``torch.Generator``.

A byte-level model (vocabulary 256) keeps the demo self-contained; the
weights are random, at 8 times the init scale so that the logits are of
order 1 and the greedy picks are clear.  The kernels' greedy ids must
equal the plain path's (every knob "xla").

Usage:
    python bpe_transformer_tpu_torch/examples/8_kv_cache_decode.py [--input PATH]
        [--new-tokens N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

from _common import add_device_args, add_input_arg, corpus, report_launches

import torch

from bpe_transformer_tpu_torch.models import ModelConfig, init_params
from bpe_transformer_tpu_torch.models.decode import generate_cached, init_kv_cache
from bpe_transformer_tpu_torch.tree import tree_map


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_input_arg(parser)
    add_device_args(parser)
    parser.add_argument("--new-tokens", type=int, default=32)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--out", type=Path, default=Path("decode_demo"))
    args = parser.parse_args()
    dev = torch.device(args.device)

    base = ModelConfig(vocab_size=256, context_length=128, d_model=128, num_layers=4,
                       num_heads=4, d_ff=256)
    gqa = dataclasses.replace(base, num_kv_heads=2)

    # --- cache anatomy --------------------------------------------------
    def cache_bytes(cfg, batch=1):
        return sum(t.numel() * t.element_size() for layer in init_kv_cache(cfg, batch, device=dev)
                   for t in layer.values())

    mha_b, gqa_b = cache_bytes(base), cache_bytes(gqa)
    print(f"KV cache @ ctx={base.context_length}: MHA {mha_b / 1024:.0f} KiB "
          f"-> GQA(kv={gqa.num_kv_heads}) {gqa_b / 1024:.0f} KiB "
          f"({mha_b / gqa_b:.0f}x smaller, and the same factor off every per-token cache read)")

    # --- batched generation through the kernels -------------------------
    text = corpus(args, args.out).read_bytes()
    plen = 64
    prompts = [list(text[i * plen:(i + 1) * plen]) for i in range(args.batch)]
    cfg = dataclasses.replace(gqa, attention_impl="flash", decode_attention_impl="pallas",
                              ffn_impl="pallas")
    params = tree_map(lambda t: t * 8 if t.ndim == 2 else t,
                      init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))

    def sample(seed, n=args.new_tokens, config=cfg, **knobs):
        knobs = knobs or dict(temperature=0.9, top_k=50, top_p=0.95)
        out = generate_cached(params, prompts, config=config, max_new_tokens=n,
                              generator=torch.Generator(device=dev).manual_seed(seed),
                              device=dev, **knobs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    sample(1)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = sample(2)
    t_run = time.perf_counter() - t0
    n_tok = args.batch * args.new_tokens
    print(f"generated {args.batch} x {args.new_tokens} tokens: first call {t_first:.2f}s "
          f"(the kernel libraries load in it), second {t_run:.3f}s ({n_tok / t_run:,.0f} tok/s on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}): one prefill, "
          f"then one batched decode step a token")
    if tuple(out.shape) != (args.batch, args.new_tokens):
        raise SystemExit(f"shape {tuple(out.shape)}")
    if not torch.equal(out, sample(2)):
        raise SystemExit("seeded sampling is not repeatable")

    # Greedy: deterministic, and the kernels agree with the plain path.
    greedy = sample(0, 8, temperature=0.0)
    if not torch.equal(greedy, sample(9, 8, temperature=0.0)):
        raise SystemExit("greedy must be deterministic")
    print(f"greedy continuation bytes: {greedy[0].tolist()}")
    plain = sample(3, 8, config=dataclasses.replace(gqa), temperature=0.0)
    if not torch.equal(greedy, plain):
        raise SystemExit(f"kernels {greedy.tolist()} != plain path {plain.tolist()}")
    report_launches()
    print("kernel and plain decode paths agree; decode demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
