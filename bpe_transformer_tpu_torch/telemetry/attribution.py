"""Performance attribution: an analytic roofline and the measured split of a
training step (the port's rewrite of
``bpe_transformer_tpu/telemetry/attribution.py``).

It answers "where does the step go" in two ways, both riding the telemetry
stream as ``kind="attribution"`` records:

1. **Roofline.**  The JAX package reads XLA's ``cost_analysis()`` of each
   compiled program.  The port has no compiled programs, so
   :func:`program_cost` counts analytically: FLOPs from ``utils/flops.py``
   and bytes from the weights, the optimizer state and the attention
   kernels' own reads and writes (the terms of ``PERF.md``'s bound
   column).  The count leaves out the activations that pass between the
   other kernels (matmul inputs and outputs, norms, the FFN intermediates,
   the logits), so its bytes are a lower bound and its arithmetic
   intensity an upper one.  :func:`roofline` classifies a row against the
   card's ridge point (``utils/flops.py`` peaks; ``"unknown"`` on any
   device without a row, the CPU included).

2. **Measured split.**  :class:`StepProbe` runs a copy of the training
   update.  Its device time is the card's busy time over one call: the
   union of the kernel and copy intervals of a ``torch.profiler`` trace
   (CUPTI) of that call, which the host's launch rate does not inflate.
   Then ``iters`` back-to-back calls between two fences
   (``torch.cuda.synchronize``) give the probe's own wall time, kept as a
   separate field: on a host-bound step the host's dispatch sets it, not
   the card.  The host gap is the loop's wall time per step minus the
   device time; on one device there is no collective, so
   ``collective_frac`` is 0.  Where no device trace can be taken (the CPU,
   or another ``torch.profiler`` already recording) the device time is the
   fenced wall time, and the record says so (``device_time_from``).

The port's AdamW writes its state in place, so the probe runs on a clone of
the parameters and the optimizer state, made at each measure and dropped
after it: one transient extra copy of the state, as the JAX package's
non-donating probe pays, and the live tensors are never touched.  The probe
is opt-in and runs at attribution boundaries only, adding
:data:`StepProbe.FETCHES_PER_MEASURE` host syncs there and none elsewhere.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.optim.adamw import AdamWState
from bpe_transformer_tpu_torch.telemetry.resources import reset_device_peak
from bpe_transformer_tpu_torch.tree import tree_leaves, tree_map
from bpe_transformer_tpu_torch.utils.flops import (
    decode_tick_flops,
    matmul_param_count,
    peak_flops_per_chip,
    peak_hbm_bytes_per_sec,
    prefill_flops,
    train_step_flops,
)

__all__ = [
    "StepProbe",
    "decode_tick_roofline",
    "kernel_busy_s",
    "program_cost",
    "program_memory",
    "roofline",
    "serving_program_costs",
    "time_call",
]


# ----------------------------------------------------------- measurement

def _device_of(tree) -> torch.device | None:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _fence(device: torch.device | None) -> None:
    """One host sync with the card (nothing on the CPU, where every op has
    finished when it returns)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_busy_s(fn: Callable, *args) -> float | None:
    """Seconds the card was busy during one call of ``fn(*args)``: the union
    of the device intervals (kernels, copies, fills) of a ``torch.profiler``
    trace of the call, closed by one fence inside the trace.  Reading the
    trace builds the profiler's event list, which takes seconds at a few
    thousand launches.  The call runs either way; None off the card, while
    another profiler is recording, or when the trace holds no device
    events."""
    device = _device_of(args)
    if device is None or device.type != "cuda" or torch.autograd._profiler_enabled():
        fn(*args)
        _fence(device)
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        _fence(device)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e6 if spans else None


def time_call(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean wall milliseconds per call of ``fn(*args)``: ``warmup`` calls
    and one fence, then ``iters`` back-to-back calls and one fence, so two
    host syncs in all whatever ``iters`` is."""
    device = _device_of(args)
    for _ in range(max(warmup, 1)):
        fn(*args)
    _fence(device)
    start = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _fence(device)
    return (time.perf_counter() - start) / max(iters, 1) * 1e3


# -------------------------------------------------------- analytic costs

def _act_bytes(config: ModelConfig) -> int:
    return 2 if config.activation_dtype == "bfloat16" else 4


def _param_count(config: ModelConfig) -> int:
    """Every parameter the optimizer updates: the projections, every
    expert of an MoE FFN and its router, the third FFN matrix that the
    two-matrix FFNs keep unread, the norms, the embedding and an untied
    head."""
    d, ff = config.d_model, config.d_ff
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head
    attn = 2 * d * d + 2 * d * d_kv
    if config.ffn_type == "moe":
        ffn = config.n_experts * 3 * d * ff + d * config.n_experts
    else:
        ffn = 3 * d * ff
    layers = config.num_layers * (attn + ffn + 2 * d)
    head = 0 if config.tie_embeddings else config.vocab_size * d
    return layers + d + config.vocab_size * d + head


def _attention_bytes(config: ModelConfig, batch: int, seq: int, backward: bool) -> float:
    """Bytes the attention kernels move over all layers: the forward reads
    Q, K and V and writes O and the row statistics; the backward reads Q,
    K, V, O, dO and the statistics and writes dQ, dK and dV."""
    act = _act_bytes(config)
    rows = batch * config.num_heads * seq
    qkvo = rows * config.d_head * act
    stats = rows * 4
    fwd = 4 * qkvo + stats
    bwd = 8 * qkvo + 2 * stats if backward else 0
    return config.num_layers * (fwd + bwd)


def program_cost(config: ModelConfig, batch: int, seq: int | None = None, *,
                 kind: str = "train_step") -> dict:
    """``{"flops", "bytes_accessed"}`` of one unit of work, counted
    analytically (module docstring: the bytes between the non-attention
    kernels are left out).

    ``kind="train_step"``: one optimizer update of ``batch`` sequences of
    ``seq`` tokens, FLOPs from :func:`train_step_flops`; bytes: the float32
    master weights read by the forward and by the backward, the gradients
    written once and read by the clip and the update, AdamW's reads and
    writes of the weights and both moments, the token batch, and the
    attention kernels' forward and backward bytes.

    ``kind="prefill"``: one prefill of ``seq`` tokens (``batch`` 1), FLOPs
    from :func:`prefill_flops`; bytes: the weights once at the activation
    width, the K/V rows written to the cache, the attention forward's
    bytes and the last position's float32 logits."""
    S = seq or config.context_length
    act = _act_bytes(config)
    n_params = _param_count(config)
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head
    if kind == "train_step":
        weights = 2 * 4 * n_params
        grads = 3 * 4 * n_params
        adamw = 6 * 4 * n_params
        tokens = 2 * batch * S * 8
        return {
            "flops": train_step_flops(config, batch, S),
            "bytes_accessed": float(weights + grads + adamw + tokens
                                    + _attention_bytes(config, batch, S, backward=True)),
        }
    if kind == "prefill":
        kv = config.num_layers * 2 * S * d_kv * act
        logits = config.vocab_size * 4
        return {
            "flops": prefill_flops(config, S),
            "bytes_accessed": float(n_params * act + kv + logits
                                    + _attention_bytes(config, 1, S, backward=False)),
        }
    raise ValueError(f"unknown kind {kind!r}: 'train_step' or 'prefill'")


def _memory_record(device: torch.device, before: int, args) -> dict:
    """The allocator's peak since the last reset, as :func:`program_memory`
    reports it, for a call that began with ``before`` bytes allocated."""
    peak = int(torch.cuda.max_memory_allocated(device))
    return {
        "peak_hbm_bytes": peak,
        "temp_bytes": peak - before,
        "argument_bytes": int(sum(t.numel() * t.element_size() for t in tree_leaves(args)
                                  if isinstance(t, torch.Tensor))),
        "output_bytes": None,
    }


def program_memory(fn: Callable, *args) -> dict:
    """Peak device memory of one call of ``fn(*args)``: the allocator's peak
    reset before it (``telemetry/resources.py`` :func:`reset_device_peak`,
    which keeps the run's peak for the ``resources`` records) and
    ``max_memory_allocated`` after a fence.  ``peak_hbm_bytes`` is the
    allocator's peak over the call
    (everything resident on the card counts), ``temp_bytes`` that peak less
    what was allocated before the call, ``argument_bytes`` the bytes of the
    call's tensor arguments; ``output_bytes`` is None (the port's update
    writes its outputs into its arguments).  Every value is None on the CPU,
    which keeps no such counters."""
    device = _device_of(args)
    if device is None or device.type != "cuda":
        return {"peak_hbm_bytes": None, "temp_bytes": None, "argument_bytes": None,
                "output_bytes": None}
    reset_device_peak(device)
    before = torch.cuda.memory_allocated(device)
    fn(*args)
    _fence(device)
    return _memory_record(device, before, args)


def roofline(
    flops: float | None,
    bytes_accessed: float | None,
    device_kind: str | None,
    name: str = "program",
) -> dict:
    """Classify one unit of work against the device roofline: the raw
    counters, the arithmetic intensity (FLOPs/byte), the ridge point (peak
    FLOP/s over peak bytes/s) and a ``bound`` verdict, ``"compute-bound"``
    / ``"memory-bound"`` / ``"unknown"`` (no counters, or no peak-table row
    for the device)."""
    intensity = None
    if flops and bytes_accessed:
        intensity = flops / bytes_accessed
    peak_f = peak_flops_per_chip(device_kind)
    peak_bw = peak_hbm_bytes_per_sec(device_kind)
    ridge = peak_f / peak_bw if peak_f and peak_bw else None
    bound = "unknown"
    if intensity is not None and ridge is not None:
        bound = "compute-bound" if intensity >= ridge else "memory-bound"
    return {
        "name": name,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": round(intensity, 3) if intensity is not None else None,
        "ridge_flops_per_byte": round(ridge, 3) if ridge is not None else None,
        "bound": bound,
        "peak_flops_per_sec": peak_f,
        "peak_hbm_bytes_per_sec": peak_bw,
    }


def decode_tick_roofline(
    *,
    flops: float,
    weight_bytes: float,
    kv_bytes: float,
    act_bytes: float,
    device_kind: str | None,
    name: str = "decode_tick",
) -> dict:
    """The serving decode tick's analytic roofline: its byte stream split
    into **weights** (the per-tick sweep of the matmul weights), **KV** (the
    live attention read stream) and **activations** (estimated), against
    the card's ridge point.  ``projected_tick_s`` (total bytes over peak
    bandwidth) is the memory-bound floor of one tick."""
    total = float(weight_bytes) + float(kv_bytes) + float(act_bytes)
    row = roofline(flops if flops else None, total if total else None, device_kind, name=name)
    peak_bw = row["peak_hbm_bytes_per_sec"]
    row.update(
        {
            "weight_bytes": int(weight_bytes),
            "kv_bytes": int(kv_bytes),
            "act_bytes": int(act_bytes),
            "weight_frac": round(weight_bytes / total, 4) if total else None,
            "projected_tick_s": round(total / peak_bw, 9) if peak_bw and total else None,
        }
    )
    return row


def device_kind_of(device) -> str | None:
    """The CUDA device name that keys the peak tables, or None off the card."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else None


# ------------------------------------------------------------ step probe

def _clone_state(params, opt_state: AdamWState):
    """Copies of the live state that share no storage with it."""
    clone = lambda t: t.detach().clone()  # noqa: E731
    return tree_map(clone, params), AdamWState(
        step=opt_state.step.clone(), m=tree_map(clone, opt_state.m),
        v=tree_map(clone, opt_state.v),
    )


class StepProbe:
    """A copy of the loop's training update, timed to attribute step time
    and costed for the roofline.

    Built once per run (lazily, at the first attribution boundary) with the
    loop's own step construction: the plain single-device step, or the
    grad-accum / inner-steps step, on a synthetic batch of the real shape.
    Its calls launch exactly the kernels one loop step launches.  Each
    measure runs on a fresh clone of the state (module docstring).
    """

    #: Host syncs (``torch.cuda.synchronize``) per timed variant per
    #: :meth:`measure`, one closing the traced call and one the timed calls:
    #: the constant the sync-count check pins.
    FETCHES_PER_MEASURE = 2

    def __init__(
        self,
        model_config: ModelConfig,
        hparams,
        *,
        batch_size: int,
        mesh=None,
        parallel: str | None = None,
        accum_steps: int = 1,
        inner_steps: int = 1,
        iters: int = 3,
        seed: int = 0,
        opt_sharding: str | None = None,
        device: str | torch.device = "cuda",
    ):
        if mesh is not None or parallel is not None or opt_sharding is not None:
            raise NotImplementedError(
                "attribution across devices (mesh, parallel, opt_sharding) comes with the "
                "multi-GPU training slice (ROADMAP slice 10); the port probes one device"
            )
        self.config = model_config
        self.hparams = hparams
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        self.inner_steps = inner_steps
        self.iters = iters
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self._step = None
        self._batch = None
        self._costs: list[dict] | None = None
        self._memory: dict | None = None

    @property
    def calls_per_measure(self) -> int:
        """Step calls one :meth:`measure` makes (the warmup call and the
        timed ones): the probe launches this many loop steps' kernels."""
        return 1 + self.iters

    # -- internal set-up ----------------------------------------------------

    def _synth_batch(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Random token ids at the loop's exact batch layout (stacked for
        grad-accum / inner-steps), int64 as the loop feeds them: a dense
        step's time does not depend on the ids, and synthetic data keeps
        the probe off the loop's batch stream."""
        S, B = self.config.context_length, self.batch_size
        ids = self._rng.integers(0, self.config.vocab_size, size=(B, S))
        y = np.roll(ids, -1, axis=1)
        x = ids
        if self.accum_steps > 1:
            x = x.reshape(self.accum_steps, B // self.accum_steps, S)
            y = y.reshape(self.accum_steps, B // self.accum_steps, S)
        elif self.inner_steps > 1:
            x = np.broadcast_to(x, (self.inner_steps, B, S)).copy()
            y = np.broadcast_to(y, (self.inner_steps, B, S)).copy()
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return to(x), to(y)

    def _build(self) -> None:
        from bpe_transformer_tpu_torch.training.train_step import (
            make_grad_accum_train_step,
            make_scanned_train_step,
            make_train_step,
        )

        if self.inner_steps > 1:
            self._step = make_scanned_train_step(self.config, self.hparams, self.inner_steps)
        elif self.accum_steps > 1:
            self._step = make_grad_accum_train_step(self.config, self.hparams,
                                                    self.accum_steps)
        else:
            self._step = make_train_step(self.config, self.hparams)
        self._batch = self._synth_batch()
        cost = program_cost(self.config, self.batch_size * max(self.inner_steps, 1))
        self._costs = [roofline(cost["flops"], cost["bytes_accessed"],
                                device_kind_of(self.device), name="train_step")]

    # -- public API --------------------------------------------------------

    def program_costs(self, params=None, opt_state=None) -> list[dict]:
        """Roofline rows (one per probe program: ``train_step``), counted
        for one step call (all its inner steps)."""
        if self._costs is None:
            self._build()
        return self._costs

    def memory_stats(self, params=None, opt_state=None) -> dict:
        """The probe step's :func:`program_memory` record, as read at the
        first :meth:`measure` on the card (empty before it and on the
        CPU)."""
        return dict(self._memory or {})

    def measure(self, params, opt_state) -> dict:
        """Device time and fenced wall time of the probe step on a clone of
        the state, in seconds per optimizer update (inner steps divided back
        out): ``{"device_step_s", "compute_s", "collective_s",
        "probe_wall_step_s", "device_time_from"}``.  One traced call gives
        the device time (:func:`kernel_busy_s`; ``device_time_from`` is
        ``"kernels"``), then ``iters`` calls between two fences the wall
        time, which stands in for the device time where no trace can be
        taken (``"fenced_wall"``).  The collective is 0.0 on one device.
        The first measure also reads the step's peak device memory over the
        timed calls, from the allocator, with no extra sync."""
        if self._costs is None:
            self._build()
        read_memory = self._memory is None and self.device.type == "cuda"
        p, o = _clone_state(params, opt_state)
        x, y = self._batch
        busy_s = kernel_busy_s(self._step, p, o, x, y)
        if read_memory:
            reset_device_peak(self.device)
            before = torch.cuda.memory_allocated(self.device)
        start = time.perf_counter()
        for _ in range(self.iters):
            self._step(p, o, x, y)
        _fence(self.device)
        wall_s = (time.perf_counter() - start) / max(self.iters, 1)
        if read_memory:
            self._memory = _memory_record(self.device, before, (p, o, x, y))
        del p, o
        updates = max(self.inner_steps, 1)
        device_step_s = (busy_s if busy_s is not None else wall_s) / updates
        return {"device_step_s": device_step_s, "compute_s": device_step_s,
                "collective_s": 0.0, "probe_wall_step_s": wall_s / updates,
                "device_time_from": "kernels" if busy_s is not None else "fenced_wall"}

    def loop_wall_step_s(self, params, opt_state, iters: int | None = None) -> float:
        """Wall seconds per optimizer update of a training-shaped mini loop
        on a clone of the state: each iteration samples a fresh host batch,
        copies it to the device and launches the step, with one fence at
        the end: the ``profile`` command's stand-in for a real loop's
        measured wall step time."""
        if self._costs is None:
            self._build()
        iters = iters if iters is not None else max(self.iters, 3)
        p, o = _clone_state(params, opt_state)
        self._step(p, o, *self._batch)
        _fence(self.device)
        start = time.perf_counter()
        for _ in range(iters):
            p, o, _ = self._step(p, o, *self._synth_batch())
        _fence(self.device)
        return (time.perf_counter() - start) / max(iters, 1) / max(self.inner_steps, 1)

    @property
    def fetches_per_measure(self) -> int:
        """Host syncs one :meth:`measure` makes (one variant on one device)."""
        return self.FETCHES_PER_MEASURE

    def attribution_record(
        self,
        params,
        opt_state,
        *,
        step: int,
        wall_step_s: float,
        t: float,
        include_programs: bool | None = None,
    ) -> dict:
        """One ``kind="attribution"`` record: the measured compute /
        collective / host-gap split of ``wall_step_s`` (fractions sum to
        1), the probe's own fenced wall time and where its device time came
        from (:meth:`measure`), the probe step's peak device memory and the
        knobs that set it (``remat_policy``, ``grads_dtype``,
        ``scan_layers``), and the roofline rows on the first record of the
        run (``include_programs`` overrides).  The keys are the JAX
        package's plus ``probe_wall_step_s`` and ``device_time_from``."""
        first = self._costs is None
        measured = self.measure(params, opt_state)
        device_s = measured["device_step_s"]
        collective_s = measured["collective_s"]
        compute_s = measured["compute_s"]
        host_gap_s = max(wall_step_s - device_s, 0.0)
        denom = max(wall_step_s, device_s, 1e-12)
        memory = self._memory or {}
        record = {
            "kind": "attribution",
            "t": round(t, 6),
            "step": step,
            "wall_step_s": round(wall_step_s, 6),
            "device_step_s": round(device_s, 6),
            "probe_wall_step_s": round(measured["probe_wall_step_s"], 6),
            "device_time_from": measured["device_time_from"],
            "compute_frac": round(compute_s / denom, 4),
            "collective_frac": round(collective_s / denom, 4),
            "host_gap_frac": round(host_gap_s / denom, 4),
            "probe_iters": self.iters,
            "train_peak_hbm_bytes": memory.get("peak_hbm_bytes"),
            "train_temp_hbm_bytes": memory.get("temp_bytes"),
            "remat_policy": self.config.resolved_remat_policy,
            "grads_dtype": getattr(self.hparams, "grads_dtype", "float32"),
            "scan_layers": self.config.scan_layers,
        }
        if include_programs if include_programs is not None else first:
            record["programs"] = self._costs
        return record


# -------------------------------------------------- serving cost model

def serving_program_costs(
    params,
    config: ModelConfig,
    *,
    slots: int = 8,
    prefill_buckets: tuple[int, ...] | None = None,
    device_kind: str | None = None,
) -> list[dict]:
    """Roofline rows for the serving engine's work: one ``prefill[bucket]``
    row per bucket of the dense engine's ladder (:func:`program_cost`,
    ``kind="prefill"``) and one ``decode_tick[slots]`` row
    (:func:`decode_tick_roofline`: ``slots`` single-token forwards over a
    full cache of ``context_length`` positions each, the weights swept once
    at the activation width, the K/V cache read once, the float32 logits
    written).  ``params`` is read for its device (``device_kind``
    overrides it); the counts are analytic, nothing runs."""
    from bpe_transformer_tpu_torch.serving.engine import default_prefill_buckets

    if device_kind is None and params is not None:
        device = _device_of(params)
        device_kind = device_kind_of(device) if device is not None else None
    if prefill_buckets is None:
        prefill_buckets = default_prefill_buckets(config.context_length)
    rows = []
    for bucket in prefill_buckets:
        cost = program_cost(config, 1, bucket, kind="prefill")
        rows.append(roofline(cost["flops"], cost["bytes_accessed"], device_kind,
                             name=f"prefill[{bucket}]"))
    act = _act_bytes(config)
    ctx = config.context_length
    d_kv = (config.num_kv_heads or config.num_heads) * config.d_head
    rows.append(decode_tick_roofline(
        flops=decode_tick_flops(config, slots, slots * ctx),
        weight_bytes=matmul_param_count(config) * act,
        kv_bytes=slots * ctx * config.num_layers * 2 * d_kv * act,
        act_bytes=slots * config.vocab_size * 4,
        device_kind=device_kind,
        name=f"decode_tick[{slots}]",
    ))
    return rows
