"""Slot-pool continuous-batching engine (port of
``bpe_transformer_tpu/serving/engine.py``).

The KV cache is one batched tensor per layer, ``slots x context_length``;
every :meth:`SlotPoolEngine.tick` runs one :func:`decode_step` across all
slots at their own positions, and prefill pads each prompt up to a
power-of-two bucket and refills the slot's whole cache row.  Per-slot
sampling knobs are runtime values.

``weight_dtype="int8"`` serves per-channel int8 matmul weights
(:func:`prepare_serving_weights`); every linear and the head then run the
int8 matmul kernel.  ``fused_sampling=True`` ends each tick with the fused
head + filter + sample kernel (``kernels/sample.py``) on the decode step's
final hidden state, with the same noise the unfused sampler would draw.

Sampling draws gumbel noise from a per-slot ``torch.Generator`` seeded from
the request's ``seed`` and takes the argmax of filtered logits plus noise
(the same law as ``jax.random.categorical``; the bits differ from JAX's).
The same request with the same seed replays the same tokens; greedy
(temperature 0) is the raw argmax.

An MoE model serves at the activation width (its expert stacks are cast
with the other weights and counted in the weight bytes; int8 weights are
refused).  All slots' tokens of a tick route together, as in the JAX
package, with the decode capacity (``models/decode.py`` ``_ffn_decode``),
which drops none.

The engine is single-threaded: one caller (the serving worker loop) calls
:meth:`admit` / :meth:`tick` / :meth:`release`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.decode import decode_step, init_kv_cache, prefill
from bpe_transformer_tpu_torch.models.transformer import lm_head_weight
from bpe_transformer_tpu_torch.ops.quant import quantize_params, quantize_weight, tree_bytes
from bpe_transformer_tpu_torch.tree import tree_map

#: Runtime encodings for "knob disabled" (as in the JAX package).
TOP_K_DISABLED = 0
TOP_P_DISABLED = 2.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def activation_dtype(config: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[config.activation_dtype]
    except KeyError:
        raise ValueError(
            f"activation_dtype={config.activation_dtype!r} is not ported "
            f"({sorted(_DTYPES)})"
        ) from None


def prepare_serving_weights(params, config: ModelConfig, weight_dtype, device):
    """The weight pipeline every serving engine runs at build time, in the
    JAX package's order: cast the tree and the LM head to the activation
    dtype on ``device``, then, under ``weight_dtype="int8"``, quantize the
    matmul weights per output channel (``ops/quant.py``) and the head.

    Returns ``(params, lm_head, label, params_bytes, tick_weight_bytes)`` as
    the JAX package does: ``label`` names the weight width ("int8" or the
    activation dtype), ``params_bytes`` the resident bytes of the tree and
    the head copy, and ``tick_weight_bytes`` what one decode tick streams
    (block stack, final norm and head; int8 dicts count their int8 values
    and float32 scales).  Both count the whole tree, as the JAX package's
    do: a two-matrix FFN's unread ``w3`` (a third of its FFN bytes) too.
    """
    if weight_dtype not in (None, "int8"):
        raise ValueError(
            f'weight_dtype={weight_dtype!r} must be None (activation width) or "int8"'
        )
    act = activation_dtype(config)
    lm_head = lm_head_weight(params, config).to(device=device, dtype=act)
    params = tree_map(lambda p: p.to(device=device, dtype=act), params)
    if weight_dtype == "int8":
        params = quantize_params(params, config)
        lm_head = quantize_weight(lm_head)
    label = "int8" if weight_dtype == "int8" else str(act).removeprefix("torch.")
    params_bytes = tree_bytes(params) + tree_bytes(lm_head)
    tick_weight_bytes = (
        tree_bytes(params["layers"]) + tree_bytes(params["ln_final"]) + tree_bytes(lm_head)
    )
    return params, lm_head, label, params_bytes, tick_weight_bytes


def default_prefill_buckets(context_length: int, min_bucket: int = 16) -> tuple[int, ...]:
    """Power-of-two prompt-length buckets up to (and always including) the
    context length."""
    buckets: list[int] = []
    b = min_bucket
    while b < context_length:
        buckets.append(b)
        b *= 2
    buckets.append(context_length)
    return tuple(buckets)


def filter_logits(logits, temps, top_ks, top_ps):
    """Temperature-scale and top-k/top-p mask ``(batch, vocab)`` logits with
    runtime ``(batch,)`` knobs: top-k keeps everything >= the k-th largest
    (ties kept; k <= 0 disables), then top-p keeps the smallest prefix of the
    sorted survivors whose mass before each token is below p (the argmax
    always survives).  Masked entries are ``-inf``."""
    vocab = logits.shape[-1]
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.where(top_ks > 0, torch.clamp(top_ks, 1, vocab), vocab) - 1
    kth = torch.gather(sorted_desc, -1, k_idx[:, None].long())
    masked = torch.where(scaled < kth, float("-inf"), scaled)

    sorted_m = torch.sort(masked, dim=-1, descending=True).values
    probs = torch.softmax(sorted_m, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    keep[:, 0] = True
    cutoff = torch.where(keep, sorted_m, float("inf")).min(dim=-1).values
    return torch.where(masked < cutoff[:, None], float("-inf"), masked)


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard gumbel noise of ``shape`` (one row: the vocabulary size)
    from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, gumbel, temps, top_ks, top_ps):
    """Per-row sampling with runtime knobs: ``temps`` (0 = greedy), ``top_ks``
    (0 = disabled), ``top_ps`` (>= 1 disabled).  ``gumbel`` (rows, vocab)
    is the caller's noise; sampled rows take ``argmax(filtered + gumbel)``,
    greedy rows the raw ``argmax(logits)`` (first index on ties)."""
    greedy = torch.argmax(logits, dim=-1)
    masked = filter_logits(logits, temps, top_ks, top_ps)
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


@dataclasses.dataclass
class SlotInfo:
    """Host-side bookkeeping for one occupied slot."""

    prompt_len: int
    bucket: int
    max_new_tokens: int  # effective: clamped to the context window
    stop_id: int | None
    generated: int = 0  # includes the prefill-sampled first token
    request_id: str | None = None


@dataclasses.dataclass(frozen=True)
class TickEvent:
    """One slot's output from a tick (or admission): the sampled token and,
    when the slot retired, why (``"stop"`` | ``"length"``)."""

    slot: int
    token: int
    finished: str | None = None


class SlotPoolEngine:
    """Fixed-capacity continuous-batching engine over a batched KV cache."""

    def __init__(
        self,
        params,
        config: ModelConfig,
        *,
        slots: int = 8,
        prefill_buckets: tuple[int, ...] | None = None,
        min_bucket: int = 16,
        weight_dtype: str | None = None,
        fused_sampling: bool = False,
        device: str | torch.device = "cuda",
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = resolve_device(device)
        self.config = config
        self.n_slots = slots
        self.fused_sampling = bool(fused_sampling)
        #: The fused tail's float32 logit workspace, one row per slot.
        self._logits_ws = (
            torch.empty((slots, config.vocab_size), dtype=torch.float32, device=self.device)
            if self.fused_sampling else None
        )
        ctx = config.context_length
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(ctx, min_bucket)
        buckets = tuple(sorted(set(prefill_buckets)))
        if not buckets or buckets[-1] > ctx:
            raise ValueError(
                f"prefill buckets {buckets} must be non-empty and <= "
                f"context_length={ctx}"
            )
        if buckets[-1] < ctx:
            buckets = buckets + (ctx,)
        self.buckets = buckets

        (
            self._params, self._lm_head, self.weight_dtype,
            self.params_bytes, self.tick_weight_bytes,
        ) = prepare_serving_weights(params, config, weight_dtype, self.device)
        self._cache = init_kv_cache(
            config, slots, dtype=activation_dtype(config), device=self.device
        )
        kv_heads = config.num_kv_heads or config.num_heads
        #: KV bytes per token position across layers (k + v) at the cache
        #: width: the unit of the decode roofline's attention read stream.
        self.kv_bytes_per_token = (
            2 * config.num_layers * kv_heads * config.d_head * activation_dtype(config).itemsize
        )

        self._tokens = np.zeros(slots, np.int64)
        self._positions = np.zeros(slots, np.int64)
        self._active = np.zeros(slots, bool)
        self._temps = np.zeros(slots, np.float32)
        self._top_ks = np.full(slots, TOP_K_DISABLED, np.int64)
        self._top_ps = np.full(slots, TOP_P_DISABLED, np.float32)
        self._generators: list[torch.Generator | None] = [None] * slots
        self._slots: list[SlotInfo | None] = [None] * slots
        self.ticks = 0
        self.tokens_emitted = 0

    # ------------------------------------------------------------- queries

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def free_slots(self) -> int:
        return self.n_slots - self.active_count

    def slot_states(self) -> list[dict]:
        """Per-slot occupancy snapshot (host-side metadata only)."""
        states: list[dict] = []
        for slot in range(self.n_slots):
            info = self._slots[slot]
            if not self._active[slot] or info is None:
                states.append({"slot": slot, "active": False})
                continue
            states.append(
                {
                    "slot": slot,
                    "active": True,
                    "position": int(self._positions[slot]),
                    "prompt_len": info.prompt_len,
                    "bucket": info.bucket,
                    "generated": info.generated,
                    "max_new_tokens": info.max_new_tokens,
                    "request_id": info.request_id,
                }
            )
        return states

    def bucket_for(self, prompt_len: int) -> int:
        """The smallest bucket holding ``prompt_len``."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest bucket "
            f"{self.buckets[-1]}"
        )

    # ------------------------------------------------------------ lifecycle

    def _gumbel_rows(self, rows: list[int], live: list[int]):
        """The noise and knobs of one sampling call; row ``i`` belongs to
        slot ``rows[i]``.  Only ``live`` slots with a temperature draw a
        gumbel row (from their own generator); every other row gets zeros and
        temperature 0 (the raw argmax).  Returns ``(gumbel, temps, top_ks,
        top_ps)`` on the device, or None when no row samples."""
        sampled = [s for s in live if self._temps[s] > 0.0]
        if not sampled:
            return None
        dev, vocab = self.device, self.config.vocab_size
        temps = np.where(np.isin(rows, sampled), self._temps[rows], 0.0)
        gumbel = torch.zeros((len(rows), vocab), dtype=torch.float32, device=dev)
        for i, slot in enumerate(rows):
            if slot in sampled:
                gumbel[i] = gumbel_noise(self._generators[slot], vocab, dev)
        return (
            gumbel,
            torch.as_tensor(temps.astype(np.float32), device=dev),
            torch.as_tensor(self._top_ks[rows], device=dev),
            torch.as_tensor(self._top_ps[rows], device=dev),
        )

    def _sample(self, logits, rows: list[int], live: list[int]) -> torch.Tensor:
        """Sample one token per logits row (see :meth:`_gumbel_rows`)."""
        noise = self._gumbel_rows(rows, live)
        if noise is None:
            return torch.argmax(logits, dim=-1)
        gumbel, temps, top_ks, top_ps = noise
        return sample_tokens(logits, gumbel, temps, top_ks, top_ps)

    def _fused_sample(self, hidden, live: list[int]) -> torch.Tensor:
        """One token per slot from the final hidden states ``(slots, d)``
        through the fused head + sample kernel, with :meth:`_sample`'s noise
        and knobs (greedy rows: temperature 0, no noise)."""
        from bpe_transformer_tpu_torch.kernels.sample import fused_head_sample

        rows = list(range(self.n_slots))
        noise = self._gumbel_rows(rows, live)
        if noise is None:
            dev = self.device
            zeros = torch.zeros(len(rows), dtype=torch.float32, device=dev)
            noise = (torch.zeros((len(rows), self.config.vocab_size), dtype=torch.float32,
                                 device=dev), zeros, zeros.long(), zeros)
        gumbel, temps, top_ks, top_ps = noise
        return fused_head_sample(hidden, self._lm_head, temps, top_ks, top_ps, gumbel,
                                 logits_out=self._logits_ws)

    @torch.inference_mode()
    def admit(
        self,
        prompt_ids,
        *,
        max_new_tokens: int,
        temperature: float = 1.0,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int = 0,
        stop_id: int | None = None,
        request_id: str | None = None,
    ) -> TickEvent:
        """Prefill a free slot with ``prompt_ids`` and sample the first token.
        Raises ``RuntimeError`` when no slot is free and ``ValueError`` for
        prompts the context window cannot serve."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        plen = prompt.shape[0]
        ctx = self.config.context_length
        if plen < 1:
            raise ValueError("prompt must contain at least one token")
        if plen > ctx - 1:
            raise ValueError(
                f"prompt of {plen} tokens leaves no room to generate in a "
                f"context of {ctx}"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise RuntimeError("no free slot")
        slot = int(free[0])

        bucket = self.bucket_for(plen)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = prompt
        self._temps[slot] = temperature
        self._top_ks[slot] = TOP_K_DISABLED if top_k is None else top_k
        self._top_ps[slot] = TOP_P_DISABLED if top_p is None else top_p
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self._generators[slot] = gen

        # Replace the slot's ENTIRE cache row (zeros beyond the bucket): no
        # state of the previous occupant survives re-admission.
        row = []
        for layer in self._cache:
            layer["k"][slot].zero_()
            layer["v"][slot].zero_()
            row.append({"k": layer["k"][slot : slot + 1], "v": layer["v"][slot : slot + 1]})
        logits, _ = prefill(
            self._params,
            torch.as_tensor(padded, device=self.device),
            self.config,
            row,
            lm_head=self._lm_head,
            last_pos=torch.tensor([plen - 1], device=self.device),
        )
        token = int(self._sample(logits, [slot], [slot])[0])
        self._tokens[slot] = token
        self._positions[slot] = plen
        info = SlotInfo(
            prompt_len=plen,
            bucket=bucket,
            max_new_tokens=min(max_new_tokens, ctx - plen),
            stop_id=stop_id,
            generated=1,
            request_id=request_id,
        )
        self._slots[slot] = info
        self._active[slot] = True
        self.tokens_emitted += 1

        finished = self._finish_reason(info, token)
        if finished:
            self.release(slot)
        return TickEvent(slot=slot, token=token, finished=finished)

    @torch.inference_mode()
    def tick(self) -> list[TickEvent]:
        """One batched decode step across every occupied slot; returns each
        active slot's token, retiring slots that hit their stop id or token
        budget.  Inactive slots keep their cache rows and positions."""
        if not self._active.any():
            return []
        dev = self.device
        active = torch.as_tensor(self._active, device=dev)
        out, _ = decode_step(
            self._params,
            torch.as_tensor(self._tokens, device=dev),
            torch.as_tensor(self._positions, device=dev),
            self._cache,
            self.config,
            lm_head=self._lm_head,
            active=active,
            return_hidden=self.fused_sampling,
        )
        live = [int(s) for s in np.flatnonzero(self._active)]
        if self.fused_sampling:
            tokens = self._fused_sample(out, live).cpu().numpy()
        else:
            tokens = self._sample(out, list(range(self.n_slots)), live).cpu().numpy()
        self.ticks += 1

        events: list[TickEvent] = []
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            info = self._slots[slot]
            token = int(tokens[slot])
            self._tokens[slot] = token
            self._positions[slot] += 1
            info.generated += 1
            self.tokens_emitted += 1
            finished = self._finish_reason(info, token)
            if finished:
                self.release(slot)
            events.append(TickEvent(slot=slot, token=token, finished=finished))
        return events

    def release(self, slot: int) -> None:
        """Free a slot (retirement or cancellation).  The cache row stays as
        it is: the next admission's prefill overwrites it whole."""
        self._active[slot] = False
        self._slots[slot] = None
        self._generators[slot] = None

    @staticmethod
    def _finish_reason(info: SlotInfo, token: int) -> str | None:
        if info.stop_id is not None and token == info.stop_id:
            return "stop"
        if info.generated >= info.max_new_tokens:
            return "length"
        return None
