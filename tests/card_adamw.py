"""The clip + AdamW kernels (``kernels/adamw.py``, ``csrc/adamw.cu``) held
against their plain per-leaf loop on an NVIDIA card.

    python -m pytest -m card tests/card_adamw.py -q

Every case needs the card and skips without one.  The file is not named
``test_*.py``, so a run over ``tests/`` (the CPU tier) does not collect it;
give its path, as above.  ``chip_smoke.py`` phase 22 runs it.  No JAX here:
the plain loop is the reference on the card, and the CPU tests hold that
loop against the JAX package's clip and AdamW.

Trees: GPT2_SMALL_32K's (111 leaves, 134.1M parameters) and
TINYSTORIES_MOE's (about 224M), float32 parameters and gradients; the
GPT-2 tree with bfloat16 parameters and bfloat16 or float32 gradients; the
MoE tree and the bf16 GPT-2 tree with every matrix's gradient transposed,
as autograd hands back the MoE experts and router (the update reads them in
place, through shared memory); a small tree of ragged leaves: an empty
one, one of 3 elements, one a few chunks and a tail long, one narrowed on
its last dim (not contiguous: the wrapper's copy and write-back) and one
starting an odd element into its storage (no vector loads); and 700 small
leaves, three launches of each kernel (``kernels/adamw.py``
``MAX_LEAVES``).  Each runs 5 steps of new
seeded gradients (std 1e-3, so the norm at the big trees is 10-15 and the
clip engages at ``max_norm`` 1; one case clips at 1e4 and never engages)
on two copies of one tree, the kernel on one and the plain loop
(:func:`clip_plain` then :func:`adamw_plain`, eager CUDA ops) on the
other, compared after steps 1 and 5.

Tolerances, and why:

* ``grad_norm`` to 1e-5 relative: the kernel sums in chunks of 65,536 and
  across them in double, eager PyTorch leaf by leaf in float32.
* m and v to 1e-5 relative plus 1e-6 of the leaf's largest magnitude: the
  clip's scale inherits the norm's rounding (1e-6 and below), and eager
  CUDA divides by a scalar as a multiply by its reciprocal and fuses
  ``add_(alpha=...)`` into an FMA where the kernel rounds each step; a few
  float32 ulps a step, and m can cancel toward 0 (hence the absolute part).
  With bfloat16 gradients under an engaged clip, ``g * scale`` rounds to
  bf16 on each side from scales an ulp apart, so a gradient may land one
  bf16 ulp (2^-8) off: m to 2^-7 and v to 2^-6, relative and of the leaf's
  largest (a wrong formula is off by (1 - b1) or more).
* float32 parameters to 2e-6 relative plus ``lr`` times 1e-5: an update of
  ``lr`` times at most a few, off by its few ulps, then rounded.
* bfloat16 parameters to one bfloat16 ulp (2^-7 of the value bounds it)
  plus ``lr`` times 2^-6, a step: both round float32 values an ulp (or,
  from a bf16 gradient one ulp off, ``lr`` times 2^-8) apart, so where they
  lie by a rounding boundary the two land one bf16 ulp apart, and the next
  step carries that on; an update of ``lr`` 1e-3 against values of about
  0.02 is 13 such ulps, so a wrong update still shows.
* ``delta_norms`` to 2e-4 relative in float32 (a norm weight of 1 an ulp,
  1.2e-7, off against a delta of about ``lr``); in bfloat16 to 5e-2: one
  element a bf16 ulp off in a 768-element norm-weight leaf (values 1, so an
  ulp of 2^-8 against a delta of 1e-3) moves that leaf's norm by about 3%.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from bpe_transformer_tpu_torch.kernels import _build
from bpe_transformer_tpu_torch.kernels import adamw as K

LR, BETAS, EPS, WD = 1e-3, (0.9, 0.999), 1e-8, 0.01
STEPS = 5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only there")
    return torch.device("cuda")


def _tree(name: str, device):
    from bpe_transformer_tpu_torch.models import GPT2_SMALL_32K, TINYSTORIES_MOE
    from bpe_transformer_tpu_torch.models.transformer import init_params
    from bpe_transformer_tpu_torch.tree import tree_leaves

    if name == "many":
        sizes = torch.randint(1, 5000, (700,), generator=torch.Generator().manual_seed(2))
        return [torch.randn(int(n), device=device) for n in sizes]
    if name == "ragged":
        base = torch.randn(70_000, generator=torch.Generator().manual_seed(1)).to(device)
        wide = torch.randn(5, 40_003, device=device)
        return [torch.empty(0, device=device), torch.randn(3, device=device),
                torch.randn(3 * K.CHUNK + 123, device=device), wide.narrow(1, 2, 40_000),
                base[1:60_001]]
    cfg = GPT2_SMALL_32K if name == "gpt2_small_32k" else TINYSTORIES_MOE
    gen = torch.Generator(device=device).manual_seed(0)
    return tree_leaves(init_params(dataclasses.replace(cfg), gen, device=device))


def _grads(leaves, step: int, dtype, transposed: bool = False):
    """Seeded gradients of std 1e-3; ``transposed``, every matrix's laid out
    as autograd hands back a weight the forward read as ``w^T`` (the MoE
    experts and router)."""
    gen = torch.Generator(device=leaves[0].device).manual_seed(100 + step)
    out = []
    for p in leaves:
        if transposed and p.dim() >= 2:
            shape = p.shape[:-2] + p.shape[:-3:-1]
            g = torch.randn(shape, generator=gen, device=p.device).transpose(-1, -2)
        else:
            g = torch.randn(p.shape, generator=gen, device=p.device)
        out.append((g * 1e-3).to(dtype))
    return out


def _launches_a_call(params, grads, deltas: bool) -> dict:
    """The kernels' launches one call takes: a launch of each pass for each
    group of leaves with chunks, and a fold for each update group."""
    norm = K.chunk_groups([K.leaf_chunks(g.shape) for g in grads])
    update = K.chunk_groups([K.leaf_chunks(g.shape, K.transposed(g)) for g in grads])
    return {"adamw_sumsq": sum(1 for g in norm if g.chunks),
            "adamw_update": sum(1 for g in update if g.chunks),
            "adamw_fold": len(update) if deltas else 0}


def _close(got, want, rtol, atol, what):
    err = (got.float() - want.float()).abs()
    bound = rtol * want.float().abs() + atol
    worst = int(torch.argmax((err - bound).flatten())) if err.numel() else 0
    assert bool((err <= bound).all()), (
        f"{what}: {int((err > bound).sum())} of {err.numel()} elements off; worst "
        f"{float(err.flatten()[worst]):.3e} against {float(bound.flatten()[worst]):.3e}")


CASES = [
    # tree, parameter dtype, gradient dtype, max_norm, delta_norms, transposed
    ("gpt2_small_32k", torch.float32, torch.float32, 1.0, True, False),
    ("tinystories_moe", torch.float32, torch.float32, 1.0, False, False),
    ("tinystories_moe", torch.float32, torch.float32, 1.0, True, True),
    ("gpt2_small_32k", torch.bfloat16, torch.bfloat16, 1.0, True, False),
    ("gpt2_small_32k", torch.bfloat16, torch.float32, 1e4, False, True),
    ("ragged", torch.float32, torch.float32, 1.0, True, False),
    ("many", torch.float32, torch.float32, 1.0, True, False),
]


@pytest.mark.card
@pytest.mark.parametrize("tree,p_dtype,g_dtype,max_norm,deltas,transposed", CASES)
def test_clip_adamw_kernel_matches_the_plain_loop(tree, p_dtype, g_dtype, max_norm, deltas,
                                                  transposed):
    device = _card()
    base = [p.to(p_dtype) for p in _tree(tree, device)]
    # Same values on both sides; the kernel's side keeps the views (a
    # narrowed or offset leaf stays one).
    kern = base if tree == "ragged" else [p.clone() for p in base]
    plain = [p.clone() for p in base]
    km = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in base]
    kv = [torch.zeros_like(m) for m in km]
    pm = [torch.zeros_like(m) for m in km]
    pv = [torch.zeros_like(m) for m in km]
    # (rtol, atol as a share of the leaf's largest magnitude) of m and v:
    # a clipped bf16 gradient may round to the next bf16 value on one side.
    mv_tol = ({"m": (2.0**-7, 2.0**-7), "v": (2.0**-6, 2.0**-6)}
              if g_dtype == torch.bfloat16 and max_norm < 1e4
              else {"m": (1e-5, 1e-6), "v": (1e-5, 1e-6)})
    per_call = _launches_a_call(base, _grads(base, 1, g_dtype, transposed), deltas)
    for step in range(1, STEPS + 1):
        grads = _grads(base, step, g_dtype, transposed)
        kd = [] if deltas else None
        pd = [] if deltas else None
        before = _build.read_launches(["adamw_sumsq", "adamw_update", "adamw_fold"])
        k_norm = K.clip_adamw(kern, grads, km, kv, step=step, lr=LR, max_norm=max_norm,
                              betas=BETAS, eps=EPS, weight_decay=WD, delta_norms=kd)
        after = _build.read_launches(["adamw_sumsq", "adamw_update", "adamw_fold"])
        assert {k: after[k] - before[k] for k in after} == per_call
        clipped, p_norm = K.clip_plain(grads, max_norm)
        K.adamw_plain(plain, clipped, pm, pv, step=step, lr=LR, betas=BETAS, eps=EPS,
                      weight_decay=WD, delta_norms=pd)
        torch.cuda.synchronize()
        if step not in (1, STEPS):
            continue
        what = f"{tree} {p_dtype} / {g_dtype} step {step}"
        _close(k_norm, p_norm, 1e-5, 0.0, f"{what} grad_norm")
        # The norm alone (ops/grad.py global_norm on the card): the same
        # sums in the same order as the update's.
        assert float(K.global_norm(grads)) == float(k_norm), what
        if max_norm >= 1e4:
            assert float(p_norm) < max_norm, "the clip was meant not to engage"
        elif tree != "ragged":
            assert float(p_norm) > max_norm, "the clip was meant to engage"
        p_tol = ((2e-6, LR * 1e-5) if p_dtype == torch.float32
                 else (2.0**-7 * step, LR * 2.0**-6 * step))
        for i, (a, b) in enumerate(zip(kern, plain)):
            _close(a, b, *p_tol, f"{what} p[{i}]")
        for name, ks, ps in (("m", km, pm), ("v", kv, pv)):
            rtol, share = mv_tol[name]
            for i, (a, b) in enumerate(zip(ks, ps)):
                scale = float(b.abs().max()) if b.numel() else 0.0
                _close(a, b, rtol, share * scale, f"{what} {name}[{i}]")
        if deltas:
            assert len(kd) == len(pd) == len(base)
            d_tol = 2e-4 if p_dtype == torch.float32 else 5e-2
            for i, (a, b) in enumerate(zip(kd, pd)):
                _close(a, b, d_tol, 1e-12, f"{what} delta_norms[{i}]")


@pytest.mark.card
@pytest.mark.parametrize("tree,transposed", [("gpt2_small_32k", False),
                                             ("tinystories_moe", True)])
def test_clip_adamw_is_two_kernels_on_the_card(tree, transposed):
    """Whatever the leaf count, the clip and the update are two kernels on
    the card (three with the update norms), and nothing else runs there:
    no copy of a transposed gradient either."""
    from torch.profiler import ProfilerActivity, profile

    device = _card()
    params = _tree(tree, device)
    grads = _grads(params, 1, torch.float32, transposed)
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    K.clip_adamw(params, grads, ms, vs, step=1, lr=LR, max_norm=1.0)  # loads the library
    torch.cuda.synchronize()
    for deltas, want in ((None, 2), ([], 3)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            K.clip_adamw(params, grads, ms, vs, step=2, lr=LR, max_norm=1.0, delta_norms=deltas)
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e.name for e in prof.events() if e.device_type == cuda]
        assert len(kernels) == want, (len(params), kernels)
