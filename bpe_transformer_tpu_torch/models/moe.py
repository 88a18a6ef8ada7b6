"""Mixture-of-experts FFN: top-1 (Switch) and top-k (GShard) routing over
stacked SwiGLU experts (port of ``bpe_transformer_tpu/models/moe.py``).

Expert weights are stacked on a leading ``(n_experts, ...)`` dim and every
expert product is one batched matmul over all experts; the routing has
static shapes and reads nothing back to the host.  Two dispatch
formulations share one routing (``ModelConfig.moe_dispatch``):

* ``"einsum"``: the one-hot ``(n, e, cap)`` dispatch and combine tensors;
* ``"gather"``: slot indices, tokens gathered into their expert slots and
  expert rows gathered back (dropped assignments point at a sentinel slot
  past the ``e * cap`` real ones, which reads a zero row).

Semantics, as in the JAX package:

* each token routes to its ``router_top_k`` most probable experts; with
  k = 1 the gate is the raw softmax probability (Switch), with k > 1 the
  gates are renormalised over the chosen experts (GShard top-2);
* per-expert capacity ``ceil(capacity_factor * tokens / n_experts)``,
  filled rank-major (every token's first choice queues before any token's
  second choice); an assignment past capacity is dropped (its FFN output is
  zero, the residual carries the token through);
* the load-balance loss ``n_experts * sum_e f_e * P_e`` over the
  pre-capacity first choices (f: share of tokens whose first choice is e,
  P: mean router probability of e).

The router runs in float32 whatever the activation dtype; the experts run
in the compute dtype of ``x``.  ``groups`` routes equal consecutive slices
of the tokens as separate dispatch groups, each with its own capacity and
aux loss (the aux is their mean): the stacked sequence-parallel ring routes
each rank's tokens on their own, as every shard does under the JAX
package's ``shard_map``.  ``expert_axis`` runs the experts split over a mesh
axis (expert parallelism): every rank of the axis holds the same tokens,
gathers the router's rows, routes alike, runs its own experts on their
slots and gathers the experts' outputs for the combine.
"""

from __future__ import annotations

import math

import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.ops.core import silu
from bpe_transformer_tpu_torch.telemetry.spans import phase


def init_moe_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Router and stacked expert weights of one MoE FFN: ``router (e, d)``,
    ``w1``/``w3 (e, ff, d)``, ``w2 (e, d, ff)``, each truncated normal (std
    0.02, cut at 3 std) as the JAX package draws them.  Draws come from
    ``generator`` on its own device and are moved to ``device``."""
    e, d, ff = config.n_experts, config.d_model, config.d_ff

    def dense(shape, std=0.02):
        w = torch.empty(shape, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        return (w * std).to(device=device, dtype=dtype)

    return {
        "router": dense((e, d)),
        "w1": dense((e, ff, d)),
        "w2": dense((e, d, ff)),
        "w3": dense((e, ff, d)),
    }


def expert_capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


def route(tokens: torch.Tensor, router: torch.Tensor, top_k: int, cap: int) -> dict:
    """The routing of ``tokens (G, n, d)`` (G dispatch groups of n tokens)
    at capacity ``cap``, in float32:

    * ``probs (G, n, e)``: the router's softmax;
    * ``expert (G, k * n)`` and ``gates (G, k * n)``: each assignment's
      expert and gate, rank-major (row ``r * n + t`` is token t's rank-r
      choice);
    * ``pos (G, k * n)``: the assignment's 0-based queue position in its
      expert, ``kept (G, k * n)``: whether it is under capacity.
    """
    logits = torch.einsum("gnd,ed->gne", tokens.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)  # (G, n, k)
    if top_k == 1:
        gates = topk_probs
    else:
        gates = topk_probs / torch.sum(topk_probs, dim=-1, keepdim=True)
    e = router.shape[0]
    g, n = tokens.shape[:2]
    expert = topk_idx.transpose(1, 2).reshape(g, top_k * n)
    # Rank-major queueing over the flattened (k, n) assignments: each
    # assignment's 0-based position among the earlier ones of its expert (the
    # JAX package's one-hot cumsum).  The one-hots lie expert-major, (G, e,
    # k * n), and run through ONE scan of the flattened tensor (a device-wide
    # scan; a scan down the k * n axis of an (k * n, e) one-hot runs its 8
    # columns nearly serially), each row's count before it subtracted.
    hit = (expert[:, None, :] == torch.arange(e, device=expert.device)[:, None]).int()
    running = torch.cumsum(hit.reshape(-1), dim=0, dtype=torch.int32).reshape(hit.shape)
    pos = torch.sum((running - running[..., :1] + hit[..., :1] - 1) * hit, dim=1)
    return {
        "probs": probs,
        "expert": expert,
        "gates": gates.transpose(1, 2).reshape(g, top_k * n),
        "pos": pos,
        "kept": pos < cap,
    }


def dispatch(tokens: torch.Tensor, r: dict, n_experts: int, cap: int, mode: str):
    """Tokens ``(G, n, d)`` into their expert slots under routing ``r``:
    returns ``(expert_in (e, G * cap, d), plan)``, where ``plan`` is what
    :func:`combine` needs (the gather dispatch's slot of each assignment,
    the einsum dispatch's ``(G, n, e, cap)`` combine tensor).  Empty slots
    hold zero rows."""
    g, n, d = tokens.shape
    e, dev = n_experts, tokens.device
    kn = r["expert"].shape[1]
    if mode == "gather":
        slot = r["expert"] * cap + r["pos"].long()
        # slot -> source token.  Kept assignments have distinct slots (the
        # cumsum queueing); each dropped one writes the sentinel source n
        # into a trash slot of its own past the real e * cap, so no index is
        # written twice and the scatter is deterministic on any device.  The
        # trash slots are cut off before use.
        trash = e * cap + torch.arange(kn, device=dev)
        slot_src = torch.full((g, e * cap + kn), n, dtype=torch.long, device=dev)
        slot_src.scatter_(1, torch.where(r["kept"], slot, trash),
                          (torch.arange(kn, device=dev) % n).expand(g, kn))
        # Empty slots hold n and read the zero row appended to each group.
        padded = torch.cat([tokens, tokens.new_zeros(g, 1, d)], dim=1)
        rows = slot_src[:, : e * cap] + torch.arange(g, device=dev)[:, None] * (n + 1)
        expert_in = padded.reshape(-1, d).index_select(0, rows.reshape(-1))
        # Dropped assignments read the sentinel slot e * cap: a zero row.
        dest = torch.where(r["kept"], slot, torch.full_like(slot, e * cap))
        return _by_expert(expert_in.reshape(g, e * cap, d), e), dest
    # (G, k * n, e, cap) one-hots of each kept assignment's slot; a token
    # holds at most one slot per expert, so summing the ranks is exact.
    top_k = kn // n
    hit = ((torch.nn.functional.one_hot(r["expert"], e).bool() & r["kept"][..., None])[..., None]
           & (r["pos"].long()[..., None, None] == torch.arange(cap, device=dev))).float()
    dispatch_t = torch.sum(hit.reshape(g, top_k, n, e, cap), dim=1)
    combine_t = torch.sum((hit * r["gates"][..., None, None]).reshape(g, top_k, n, e, cap), dim=1)
    expert_in = torch.einsum("gnec,gnd->gecd", dispatch_t.to(tokens.dtype), tokens)
    return _by_expert(expert_in.reshape(g, e * cap, d), e), combine_t


def experts(expert_in: torch.Tensor, moe_params: dict) -> torch.Tensor:
    """The SwiGLU experts on ``expert_in (e, rows, d)``, batched over the
    expert dim: ``(silu(x w1^T) * x w3^T) w2^T`` -> ``(e, rows, d)``."""
    up = torch.matmul(expert_in, moe_params["w1"].transpose(1, 2))
    lin = torch.matmul(expert_in, moe_params["w3"].transpose(1, 2))
    return torch.matmul(silu(up) * lin, moe_params["w2"].transpose(1, 2))


def combine(expert_out: torch.Tensor, r: dict, plan: torch.Tensor, groups: int, mode: str):
    """Expert rows ``(e, G * cap, d)`` back to tokens ``(G, n, d)``, each
    token's kept assignments weighted by their gates (``plan`` from
    :func:`dispatch`)."""
    e, _, d = expert_out.shape
    out = _by_group(expert_out, groups)  # (G, e * cap, d)
    if mode == "gather":
        g, slots, _ = out.shape
        kn = plan.shape[1]
        out_pad = torch.cat([out, out.new_zeros(g, 1, d)], dim=1)
        rows = plan + torch.arange(g, device=out.device)[:, None] * (slots + 1)
        out_rows = out_pad.reshape(-1, d).index_select(0, rows.reshape(-1))
        gates = (r["gates"] * r["kept"]).to(out.dtype).reshape(-1, 1)
        n = r["probs"].shape[1]
        return torch.sum((out_rows * gates).reshape(g, kn // n, n, d), dim=1)
    return torch.einsum("gnec,gecd->gnd", plan.to(out.dtype), out.reshape(groups, e, -1, d))


def _by_expert(t: torch.Tensor, e: int) -> torch.Tensor:
    """``(G, e * cap, d)`` -> ``(e, G * cap, d)`` (a view when G is 1)."""
    g, slots, d = t.shape
    t = t.reshape(g, e, slots // e, d)
    return t[0] if g == 1 else t.transpose(0, 1).reshape(e, -1, d)


def _by_group(t: torch.Tensor, g: int) -> torch.Tensor:
    """The inverse of :func:`_by_expert`: ``(e, G * cap, d)`` -> ``(G, e *
    cap, d)``."""
    e, rows, d = t.shape
    if g == 1:
        return t.reshape(1, e * rows, d)
    return t.reshape(e, g, rows // g, d).transpose(0, 1).reshape(g, e * rows // g, d)


def switch_ffn(
    x: torch.Tensor,
    moe_params: dict,
    config: ModelConfig,
    capacity: int | None = None,
    groups: int = 1,
    expert_axis=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts on ``x (..., d_model)``; returns
    ``(output, aux_loss)``.  All leading dims flatten into one token axis,
    cut into ``groups`` equal dispatch groups.  ``capacity`` overrides the
    per-group default ``expert_capacity`` (the KV-cached decode path passes
    one derived from ``context_length``, so a few-token call cannot drop a
    token the full forward would keep).  The four stages, :func:`route`,
    :func:`dispatch`, :func:`experts` and :func:`combine`, are looked up at
    each call, each under its :func:`telemetry.spans.phase` range
    (``bpt.moe.route``, ...).

    ``expert_axis`` (a ``parallel.mesh.MeshAxis``): ``moe_params`` hold
    this rank's ``e / size`` experts (the router's rows too).  The router is
    gathered whole (its gradient's block kept), every rank dispatches alike,
    runs its experts on its block of the slots (the slots' gradient
    all-gathered) and gathers the outputs (their gradient's block kept)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    total = math.prod(orig_shape[:-1])
    if total % groups:
        raise ValueError(f"{total} tokens do not split into {groups} dispatch groups")
    n = total // groups
    tokens = x.reshape(groups, n, d)
    e, mode = config.n_experts, config.moe_dispatch
    cap = capacity if capacity is not None else expert_capacity(n, e, config.capacity_factor)
    with phase("moe.route"):
        router = moe_params["router"]
        if expert_axis is not None:
            router = expert_axis.gather_replicated(router, 0)
        r = route(tokens, router, config.router_top_k, cap)
    with phase("moe.dispatch"):
        expert_in, plan = dispatch(tokens, r, e, cap, mode)
    with phase("moe.experts"):
        if expert_axis is None:
            expert_out = experts(expert_in, moe_params)
        else:
            expert_out = expert_axis.gather_replicated(
                experts(expert_axis.split(expert_in, 0), moe_params), 0)
    with phase("moe.combine"):
        out = combine(expert_out, r, plan, groups, mode)

    # Load balance over the pre-capacity first choices, per group, averaged.
    first = torch.nn.functional.one_hot(r["expert"][:, :n], e).float()
    frac_tokens = torch.mean(first, dim=1)
    frac_probs = torch.mean(r["probs"], dim=1)
    aux = torch.mean(e * torch.sum(frac_tokens * frac_probs, dim=-1))
    return out.reshape(orig_shape), aux
