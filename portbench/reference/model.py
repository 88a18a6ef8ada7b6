"""The plain reference: the transformer's forward, loss, gradients and AdamW
in float32 PyTorch, with no kernel, no cache and no batching tricks.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the same seeded weights and tokens it hands the
program.  It follows the architecture the configurations state: pre-norm
blocks with RMSNorm (eps 1e-5, float32), causal multi-head attention with
interleaved-pair RoPE on q and k, SwiGLU FFNs (``w2 (silu(w1 x) * w3 x)``)
or top-k routed SwiGLU experts (softmax router in float32, gates
renormalised over the chosen experts for k > 1, capacity ``ceil(factor *
tokens / experts)`` filled rank-major, assignments past it dropped, the
load-balance loss ``e * sum f_e P_e`` over the first choices, weighted by
``router_aux_weight``), a final norm, an untied LM head and the mean
cross-entropy; AdamW in torch's decoupled form after global-norm clipping
(``max_norm / (norm + 1e-6)``, capped at 1) with a linear warmup and
cosine schedule.

``precision`` selects how every matrix product is computed: ``"fp32"``
(TF32 off: the reference), or one of the controls a lower precision gives:
``"tf32"``, ``"bf16"`` (operands rounded to bfloat16, float32
accumulation) and ``"fp8"`` (operands scaled per tensor into float8 e4m3,
gradients into e5m2, float32 accumulation).

This module is also the architecture of every configuration whose file
names no ``architecture`` (``spec.architecture``).  An architecture module
gives the parameter layout (:func:`layout`), the float32 :func:`train` and
:func:`logits`, whether the reference takes a step's batch whole
(:func:`whole_batch`) and the model FLOPs of a training step, a prefill and
a decode tick (here ``portbench/counts.py``'s).  Another architecture is a
file beside this one that gives the same names; it may build on the pieces
here, and hands its own loss to :func:`train` as ``objective``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from portbench.counts import decode_tick_flops, prefill_flops, train_step_flops  # noqa: F401

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on only for ``"tf32"``; restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _scaled_cast(x: torch.Tensor, dtype, max_value: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = max_value / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Forward: the operand through float8 e4m3; backward: the gradient
    through float8 e5m2 (per-tensor scales)."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_cast(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_cast(g, torch.float8_e5m2, 57344.0)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 at the given precision."""
    if precision == "bf16":
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()
    if precision == "fp8":
        return torch.matmul(_Fp8.apply(a), _Fp8.apply(b))
    return torch.matmul(a, b)


def rmsnorm(x, weight, eps: float = 1e-5):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * weight


def rope_tables(d_head: int, seq: int, theta: float, device):
    inv_freq = theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head)
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Rotate each adjacent feature pair of ``x (..., S, D)``."""
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1).reshape(x.shape)


def attention(x, p: dict, cfg: dict, cos, sin, precision: str):
    b, s, d = x.shape
    h = cfg["num_heads"]
    kv = cfg.get("num_kv_heads") or h
    dh = d // h

    def heads(w, n):
        return mm(x, w.t(), precision).reshape(b, s, n, dh).transpose(1, 2)

    q = apply_rope(heads(p["q_proj"], h), cos, sin)
    k = apply_rope(heads(p["k_proj"], kv), cos, sin)
    v = heads(p["v_proj"], kv)
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=1)
        v = v.repeat_interleave(h // kv, dim=1)
    scores = mm(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    out = mm(probs, v, precision).transpose(1, 2).reshape(b, s, d)
    return mm(out, p["output_proj"].t(), precision)


def swiglu(x, w1, w2, w3, precision: str):
    up = mm(x, w1.transpose(-1, -2), precision)
    gate = mm(x, w3.transpose(-1, -2), precision)
    return mm(up * torch.sigmoid(up) * gate, w2.transpose(-1, -2), precision)


def moe(x, p: dict, cfg: dict, precision: str):
    """Routed experts over every token of ``x`` as one dispatch group;
    returns ``(output, aux)``."""
    shape = x.shape
    t = x.reshape(-1, shape[-1])
    n, e, k = t.shape[0], cfg["n_experts"], cfg["router_top_k"]
    cap = max(1, math.ceil(cfg["capacity_factor"] * n / e))
    probs = torch.softmax(mm(t, p["router"].t(), precision), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    gates = top_p if k == 1 else top_p / top_p.sum(-1, keepdim=True)
    expert = top_i.t().reshape(-1)                 # rank-major assignments
    gate = gates.t().reshape(-1)
    token = torch.arange(n, device=x.device).repeat(k)
    onehot = torch.nn.functional.one_hot(expert, e)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, expert[:, None])[:, 0]
    kept = pos < cap
    out = torch.zeros_like(t)
    for j in range(e):
        sel = kept & (expert == j)
        rows = token[sel]
        y = swiglu(t[rows], p["w1"][j], p["w2"][j], p["w3"][j], precision)
        out = out.index_add(0, rows, y * gate[sel][:, None])
    first = torch.nn.functional.one_hot(top_i[:, 0], e).float()
    aux = e * torch.sum(first.mean(0) * probs.mean(0))
    return out.reshape(shape), aux


def forward_hidden(params: dict, ids: torch.Tensor, cfg: dict, precision: str = "fp32"):
    """Final-norm hidden states ``(B, S, d)`` and the summed aux loss."""
    s = ids.shape[-1]
    cos, sin = rope_tables(cfg["d_model"] // cfg["num_heads"], s, cfg.get("rope_theta", 1e4),
                           ids.device)
    x = params["token_embeddings"].float()[ids]
    aux = x.new_zeros(())
    for layer in params["layers"]:
        layer = _f32(layer)
        x = x + attention(rmsnorm(x, layer["ln1"]), layer["attn"], cfg, cos, sin, precision)
        f = rmsnorm(x, layer["ln2"])
        if cfg.get("ffn_type") == "moe":
            y, a = moe(f, layer["ffn"], cfg, precision)
            aux = aux + a
        else:
            ffn = layer["ffn"]
            y = swiglu(f, ffn["w1"], ffn["w2"], ffn["w3"], precision)
        x = x + y
    return rmsnorm(x, params["ln_final"].float()), aux


def logits(params: dict, ids: torch.Tensor, cfg: dict, precision: str = "fp32"):
    """Float32 logits ``(B, S, V)``."""
    hidden, _ = forward_hidden(params, ids, cfg, precision)
    return mm(hidden, params["lm_head"].float().t(), precision)


def loss(params: dict, x: torch.Tensor, y: torch.Tensor, cfg: dict, precision: str = "fp32"):
    """Mean cross-entropy, plus the weighted aux loss of an MoE model."""
    hidden, aux = forward_hidden(params, x, cfg, precision)
    lg = mm(hidden, params["lm_head"].float().t(), precision)
    ce = torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]), y.reshape(-1))
    if cfg.get("ffn_type") == "moe":
        ce = ce + cfg.get("router_aux_weight", 0.01) * aux
    return ce


def layout(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    """``(path, shape, init)`` of every leaf of the parameter tree the
    program takes and this reference reads (``(d_out, d_in)`` matrices),
    matrices first, then norm gains.  ``init`` is the leaf's law in
    ``weights.make_params``: ``"matrix"`` (truncated normal), ``"gain"``
    (``1 + 0.1 z``) or ``"zeros"``.

        {"token_embeddings": (V, d), "lm_head": (V, d), "ln_final": (d,),
         "layers": [{"attn": {"q_proj", "k_proj", "v_proj", "output_proj"},
                     "ln1": (d,), "ln2": (d,),
                     "ffn": {"w1": (ff, d), "w2": (d, ff), "w3": (ff, d)}
                        or {"router": (e, d), "w1": (e, ff, d),
                            "w2": (e, d, ff), "w3": (e, ff, d)}}, ...]}
    """
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    d_kv = (cfg.get("num_kv_heads") or cfg["num_heads"]) * (d // cfg["num_heads"])
    mats = [(("token_embeddings",), (v, d)), (("lm_head",), (v, d))]
    norms = [(("ln_final",), (d,))]
    for i in range(cfg["num_layers"]):
        mats += [(("layers", i, "attn", "q_proj"), (d, d)),
                 (("layers", i, "attn", "k_proj"), (d_kv, d)),
                 (("layers", i, "attn", "v_proj"), (d_kv, d)),
                 (("layers", i, "attn", "output_proj"), (d, d))]
        if cfg.get("ffn_type") == "moe":
            e = cfg["n_experts"]
            mats += [(("layers", i, "ffn", "router"), (e, d)),
                     (("layers", i, "ffn", "w1"), (e, ff, d)),
                     (("layers", i, "ffn", "w2"), (e, d, ff)),
                     (("layers", i, "ffn", "w3"), (e, ff, d))]
        else:
            mats += [(("layers", i, "ffn", "w1"), (ff, d)),
                     (("layers", i, "ffn", "w2"), (d, ff)),
                     (("layers", i, "ffn", "w3"), (ff, d))]
        norms += [(("layers", i, "ln1"), (d,)), (("layers", i, "ln2"), (d,))]
    return [(p, s, "matrix") for p, s in mats] + [(p, s, "gain") for p, s in norms]


def whole_batch(cfg: dict) -> bool:
    """Whether the reference takes a step's batch whole: the experts'
    capacity is the whole batch's, so blocks of rows would route
    otherwise."""
    return cfg.get("ffn_type") == "moe"


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, list):
        return [_rebuild(item, it) for item in tree]
    return next(it)


def loss_and_grads(params: dict, x, y, cfg: dict, precision: str, block_rows: int | None,
                   objective=None):
    """The mean loss and its gradients (float32, in :func:`_leaves` order).
    ``block_rows`` splits the batch into equal blocks of rows whose
    gradients are averaged (a dense model only: the experts' capacity is
    the whole batch's).  ``objective(params, x, y, cfg, precision)`` is the
    loss (this module's :func:`loss` when None)."""
    objective = objective or loss
    leaves = [p.detach().float().requires_grad_(True) for p in _leaves(params)]
    tree = _rebuild(params, iter(leaves))
    rows = x.shape[0]
    step = block_rows or rows
    if rows % step:
        raise ValueError(f"{rows} rows do not split into blocks of {step}")
    total, grads = 0.0, None
    for i in range(0, rows, step):
        part = objective(tree, x[i:i + step], y[i:i + step], cfg, precision)
        g = torch.autograd.grad(part, leaves)
        total = total + part.detach()
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
    n = rows // step
    return total / n, [g / n for g in grads]


def cosine_lr(it: int, hp: dict) -> float:
    if it < hp["warmup"]:
        return it / hp["warmup"] * hp["lr"]
    if it <= hp["cosine_cycle"]:
        progress = (it - hp["warmup"]) / (hp["cosine_cycle"] - hp["warmup"])
        return hp["min_lr"] + 0.5 * (1.0 + math.cos(math.pi * progress)) * (hp["lr"] - hp["min_lr"])
    return hp["min_lr"]


def train(params: dict, batches: list, cfg: dict, hp: dict, precision: str = "fp32",
          block_rows: int | None = None, objective=None) -> dict:
    """AdamW steps on ``batches`` ((x, y) pairs) from ``params`` (left as
    they are) on the loss ``objective`` (:func:`loss_and_grads`).  Returns
    each step's loss, the per-leaf norms of the first step's clipped
    gradient, and of each leaf's change after the last step (float64 host
    values, in :func:`_leaves` order)."""
    b1, b2 = hp.get("betas", (0.9, 0.999))
    eps, wd, clip = hp.get("eps", 1e-8), hp.get("weight_decay", 0.01), hp.get("clip", 1.0)
    start = [p.detach().float().clone() for p in _leaves(params)]
    cur = [p.clone() for p in start]
    m = [torch.zeros_like(p) for p in cur]
    v = [torch.zeros_like(p) for p in cur]
    losses, first_grad = [], None
    with matmul_precision(precision):
        for it, (x, y) in enumerate(batches):
            value, grads = loss_and_grads(_rebuild(params, iter(cur)), x, y, cfg, precision,
                                          block_rows, objective)
            losses.append(float(value))
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
                grads = [g * scale for g in grads]
                if first_grad is None:
                    first_grad = [float(torch.linalg.vector_norm(g)) for g in grads]
                lr = cosine_lr(it, hp)
                bias1, bias2 = 1.0 - b1 ** (it + 1), 1.0 - b2 ** (it + 1)
                for p, g, mi, vi in zip(cur, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1.0 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    update = (mi / bias1) / (torch.sqrt(vi / bias2) + eps)
                    p.copy_(p * (1.0 - lr * wd) - lr * update)
    change = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(cur, start)]
    return {"losses": losses, "first_grad": first_grad, "change": change}
