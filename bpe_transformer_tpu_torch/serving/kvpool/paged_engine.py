"""Paged continuous-batching engine (port of
``bpe_transformer_tpu/serving/kvpool/paged_engine.py``): the slot-pool
contract on block-pool KV memory, with radix prefix sharing and chunked
prefill.

A peer of :class:`~bpe_transformer_tpu_torch.serving.engine.SlotPoolEngine`
(the same admit/tick/release lifecycle and ``TickEvent``s), with:

* **paged KV**: the cache is a pool of ``block_size``-token blocks
  (:func:`models.decode.init_kv_pool`); each slot owns a chain of block ids
  in a block table that the decode tick and chunk prefill read and write
  through.  The pool's size (``num_blocks``) is a knob of its own;
* **radix prefix sharing**: a prompt's full blocks already in the
  :class:`RadixPrefixCache` are referenced into the slot's table and prefill
  starts after them (shared blocks are never written again);
* **int8 KV blocks** (``kv_dtype="int8"``): one byte per value and one
  float32 scale per (block, kv head);
* **chunked prefill**: :meth:`begin` reserves the slot and its worst-case
  block chain, each :meth:`prefill_step` runs one ``prefill_chunk``-token
  chunk, so the serving worker can interleave decode ticks between a long
  prompt's chunks (under :class:`serving.scheduler.PrefillBudget`);
* **rewind** (:meth:`rewind`, :meth:`extend_blocks`): the KV-memory
  primitives of speculative decoding (``serving/spec/``), which writes past
  a slot's frontier and rolls back what the target rejected.

Sampling is the dense engine's, shared (``fused_sampling`` too): one
``torch.Generator`` per slot seeded from the request's seed, drawn once for
the first token (on the final chunk only) and once per tick after that, so a
seeded request gives the same tokens on both engines.  Eager PyTorch
compiles no programs, so the JAX engine's ``compiled_programs`` has no
counterpart here.

**Migration** (:meth:`export_slot`, :meth:`validate_import_meta`,
:meth:`validate_import_payload`, :meth:`import_slot`): a slot leaves as a
payload of ``serving/kvpool/migrate.py`` (the JAX package's meta keys and
wire format) and is grafted into another engine's pool.  Only written blocks
travel, gathered with one indexed copy per pool array and scattered the same
way.  The port samples from a per-slot ``torch.Generator``, where JAX carries
a threefry key, so the payload holds both: ``torch_rng`` (the generator's
state and its device type), which a port importer on the same kind of device
restores, so a seeded sampled request continues token-identically; and
``key``, the threefry ``PRNGKey(seed)`` pair computed without jax, so the
JAX package's ``import_slot`` reads a port payload.  A JAX payload carries no
generator state, and the port then seeds the slot's generator from
``meta["seed"]`` as an admission does.  Migration between the two packages
is therefore exact for greedy rows only; a sampled row continues with the
importer's own random stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.decode import (
    init_kv_pool,
    paged_chunk_prefill,
    paged_decode_step,
)
from bpe_transformer_tpu_torch.serving.engine import (
    TOP_K_DISABLED,
    TOP_P_DISABLED,
    SlotPoolEngine,
    TickEvent,
    activation_dtype,
    default_prefill_buckets,
    prepare_serving_weights,
)
from bpe_transformer_tpu_torch.serving.kvpool.blocks import BlockAllocator, NoFreeBlocksError
from bpe_transformer_tpu_torch.serving.kvpool.migrate import BF16, bf16_bits, wire_dtype
from bpe_transformer_tpu_torch.serving.kvpool.radix import RadixPrefixCache

__all__ = ["PagedEngine", "PagedSlotInfo", "NoFreeBlocksError"]


def threefry_key(seed: int) -> list[int]:
    """``jax.random.PRNGKey(seed)`` as the two uint32 words JAX's payloads
    carry under ``"key"`` (32-bit seeds: the high word is 0)."""
    seed = int(seed)
    return [(seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0, seed & 0xFFFFFFFF]


def generator_state(gen: torch.Generator) -> dict:
    """A generator's state as a JSON-able payload field."""
    return {"device_type": gen.device.type, "state": gen.get_state().numpy().tobytes().hex()}


def restore_generator(field: dict | None, seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` in the state ``field`` holds when it was
    taken on the same kind of device, else seeded from ``seed`` as an
    admission seeds it."""
    gen = torch.Generator(device=device)
    if field and field.get("device_type") == device.type:
        gen.set_state(torch.frombuffer(bytearray.fromhex(field["state"]), dtype=torch.uint8))
    else:
        gen.manual_seed(int(seed))
    return gen


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A host copy of a pool tensor as a payload array (bf16 as its bits)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return bf16_bits(t.view(torch.int16).numpy())
    return t.numpy()


def _from_wire(arr) -> torch.Tensor:
    """A payload array as a host tensor (bf16 bits reinterpreted)."""
    if wire_dtype(arr) == BF16:
        bits = np.require(np.asarray(arr).view(np.int16), requirements=["C", "W"])
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(np.asarray(arr), requirements=["C", "W"]))


@dataclasses.dataclass
class PagedSlotInfo:
    """Host-side bookkeeping for one occupied slot (prefill and decode)."""

    prompt: np.ndarray  # the prompt ids (an owned copy)
    prompt_len: int
    bucket: int  # the first computed chunk's bucket
    max_new_tokens: int  # effective: clamped to the context window
    stop_id: int | None
    seed: int
    temperature: float
    top_k: int
    top_p: float
    block_ids: list  # every block this slot holds a reference on
    shared_len: int  # prompt tokens reused from the prefix cache (block-aligned)
    next_pos: int  # prefill cursor: the first position not yet computed
    generated: int = 0
    request_id: str | None = None


class PagedEngine:
    """Paged-KV continuous-batching engine (see module docstring).

    Single-threaded like the dense engine: one caller drives
    :meth:`begin`/:meth:`prefill_step`/:meth:`tick`/:meth:`release`, or
    :meth:`admit`, which runs a whole prefill at once.
    """

    #: Optional flight recorder (``telemetry/flightrecorder.py``), attached
    #: by the serving front end: KV rewinds are logged as decisions.
    recorder = None

    # The dense engine's sampler and retirement rule, shared: they read
    # ``_temps``/``_top_ks``/``_top_ps``/``_generators``, which this engine
    # keeps under the same names.
    _gumbel_rows = SlotPoolEngine._gumbel_rows
    _sample = SlotPoolEngine._sample
    _fused_sample = SlotPoolEngine._fused_sample
    _finish_reason = staticmethod(SlotPoolEngine._finish_reason)

    def __init__(
        self,
        params,
        config: ModelConfig,
        *,
        slots: int = 8,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefill_buckets: tuple[int, ...] | None = None,
        min_bucket: int = 16,
        prefill_chunk: int | None = None,
        prefix_cache: bool = True,
        kv_dtype: str | None = None,
        weight_dtype: str | None = None,
        fused_sampling: bool = False,
        device: str | torch.device = "cuda",
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f'kv_dtype={kv_dtype!r} must be None (activation width) or "int8"')
        ctx = config.context_length
        if block_size < 1 or ctx % block_size:
            raise ValueError(f"block_size={block_size} must divide context_length={ctx}")
        self.device = resolve_device(device)
        self.config = config
        self.n_slots = slots
        self.fused_sampling = bool(fused_sampling)
        self._logits_ws = (
            torch.empty((slots, config.vocab_size), dtype=torch.float32, device=self.device)
            if self.fused_sampling else None
        )
        self.block_size = block_size
        self.blocks_per_slot = ctx // block_size
        if prefill_chunk is None:
            prefill_chunk = ctx
        if prefill_chunk < 1 or (prefill_chunk < ctx and prefill_chunk % block_size):
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a positive multiple of "
                f"block_size={block_size} (chunks after the first must start block-aligned)"
            )
        self.prefill_chunk = min(prefill_chunk, ctx)

        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(ctx, min_bucket)
        ladder = tuple(sorted(set(prefill_buckets)))
        if not ladder or ladder[-1] > ctx:
            raise ValueError(
                f"prefill buckets {ladder} must be non-empty and <= context_length={ctx}"
            )
        if ladder[-1] < ctx:
            ladder = ladder + (ctx,)
        # Chunk shapes: the bucket ladder capped at the chunk size.
        self.buckets = tuple(b for b in ladder if b < self.prefill_chunk) + (self.prefill_chunk,)

        # Pool capacity: by default the dense slot pool's (every slot can
        # hold a full context) plus the trash block.
        if num_blocks is None:
            num_blocks = slots * self.blocks_per_slot + 1
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.prefix_cache = RadixPrefixCache(self.allocator) if prefix_cache else None

        act = activation_dtype(config)
        (
            self._params, self._lm_head, self.weight_dtype,
            self.params_bytes, self.tick_weight_bytes,
        ) = prepare_serving_weights(params, config, weight_dtype, self.device)
        self._pool = init_kv_pool(
            config, num_blocks, block_size, act, kv_dtype=kv_dtype, device=self.device
        )
        #: "int8" for quantized pools, else the activation dtype's name.
        self.kv_dtype = kv_dtype or str(act).removeprefix("torch.")
        kv_heads = config.num_kv_heads or config.num_heads
        itemsize = 1 if kv_dtype == "int8" else act.itemsize
        #: Resident bytes of the whole pool, scale pools included.
        self.kv_pool_bytes = sum(
            t.numel() * t.element_size() for layer in self._pool for t in layer.values()
        )
        #: KV bytes per token position across all layers (k + v) at the
        #: pool's width: the unit of the attention read stream.
        self.kv_bytes_per_token = 2 * config.num_layers * kv_heads * config.d_head * itemsize

        self._tables = np.zeros((slots, self.blocks_per_slot), np.int32)
        self._tokens = np.zeros(slots, np.int64)
        self._positions = np.zeros(slots, np.int64)
        self._active = np.zeros(slots, bool)
        self._temps = np.zeros(slots, np.float32)
        self._top_ks = np.full(slots, TOP_K_DISABLED, np.int64)
        self._top_ps = np.full(slots, TOP_P_DISABLED, np.float32)
        self._generators: list[torch.Generator | None] = [None] * slots
        self._slots: list[PagedSlotInfo | None] = [None] * slots
        self._prefilling: list[int] = []  # slots mid-prefill, in begin order
        self.ticks = 0
        self.tokens_emitted = 0

    # ------------------------------------------------------------- queries

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    @property
    def free_slots(self) -> int:
        """Slots with no occupant (a slot mid-prefill is taken)."""
        return sum(1 for info in self._slots if info is None)

    def bucket_for(self, length: int) -> int:
        """The smallest chunk bucket holding ``length`` tokens (longer
        lengths run as several chunks of the largest)."""
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def slot_bucket(self, slot: int) -> int | None:
        info = self._slots[slot]
        return None if info is None else info.bucket

    def slot_shared_len(self, slot: int) -> int:
        """Prompt tokens the slot reused from the prefix cache."""
        info = self._slots[slot]
        return 0 if info is None else info.shared_len

    def pending_prefills(self) -> tuple[int, ...]:
        """Slots with prefill chunks still to run, in begin order."""
        return tuple(self._prefilling)

    def prefill_remaining(self, slot: int) -> int:
        info = self._slots[slot]
        return 0 if info is None else info.prompt_len - info.next_pos

    def next_chunk_tokens(self, slot: int) -> int:
        """The token cost of the next :meth:`prefill_step` on ``slot``."""
        return min(self.prefill_chunk, self.prefill_remaining(slot))

    def pending_prefill_tokens(self) -> int:
        return sum(self.prefill_remaining(s) for s in self._prefilling)

    def gauges(self) -> dict:
        """The kv pool's gauges: blocks, prefix cache, pending prefill, bytes."""
        out = self.allocator.gauges()
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.gauges())
        else:
            out.update(prefix_cache_hits=0, prefix_cache_misses=0, prefix_hit_rate=None,
                       prefix_cache_nodes=0)
        out["prefill_pending_tokens"] = self.pending_prefill_tokens()
        out["prefill_pending_slots"] = len(self._prefilling)
        out["kv_pool_bytes"] = self.kv_pool_bytes
        out["kv_bytes_per_token"] = self.kv_bytes_per_token
        return out

    def slot_states(self) -> list[dict]:
        """Per-slot occupancy snapshot with the paged facts: blocks held,
        shared-prefix tokens and prefill progress."""
        states: list[dict] = []
        for slot in range(self.n_slots):
            info = self._slots[slot]
            if info is None:
                states.append({"slot": slot, "active": False})
                continue
            states.append(
                {
                    "slot": slot,
                    "active": bool(self._active[slot]),
                    "position": int(self._positions[slot]),
                    "prompt_len": info.prompt_len,
                    "bucket": info.bucket,
                    "generated": info.generated,
                    "max_new_tokens": info.max_new_tokens,
                    "blocks": len(info.block_ids),
                    "shared_prefix_tokens": info.shared_len,
                    "prefill_pos": info.next_pos,
                    "request_id": info.request_id,
                }
            )
        return states

    # ------------------------------------------------------------ lifecycle

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case block reservation of one request (before any
        prefix-cache credit): every position it may ever write."""
        ctx = self.config.context_length
        eff = min(max_new_tokens, ctx - prompt_len)
        span = min(prompt_len + eff, ctx)
        return -(-span // self.block_size)

    def _alloc_blocks(self, n: int) -> list:
        """``n`` fresh blocks, evicting prefix-cache LRU leaves to cover a
        shortfall first; raises :class:`NoFreeBlocksError` when even that
        does not."""
        shortfall = n - self.allocator.free_count
        if shortfall > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(shortfall)
        return self.allocator.alloc(n)

    # ------------------------------------------------------------ migration

    def export_slot(self, slot: int, extra_meta: dict | None = None) -> dict:
        """Serialize ``slot`` into a migration payload: the slot's written
        pool rows (one gather per pool array; int8 pools ship their scale
        rows beside them) and everything another replica needs to continue
        the generation: the prompt, the prefill frontier (mid-prefill
        exports at a block-aligned frontier), and, for a finished prefix,
        the decode state with the sampling generator's state.

        Read-only: refcounts, the radix index and every pool row are
        untouched, so a radix-shared block is never written or released by
        exporting a slot that references it.  The caller releases the slot
        once the payload has landed.  ``extra_meta`` (serving-layer fields:
        emitted tokens, timings, the token history a speculative importer
        re-prefills its draft from) is merged into the meta."""
        info = self._slots[slot]
        if info is None:
            raise ValueError(f"slot {slot} is not occupied")
        decoding = bool(self._active[slot])
        if not decoding and slot not in self._prefilling:
            raise ValueError(f"slot {slot} has no exportable state")
        # Only WRITTEN blocks travel: the rest of the chain is the
        # admission's reservation, which the importer re-reserves.
        frontier = int(self._positions[slot]) if decoding else info.next_pos
        ids = info.block_ids[: -(-frontier // self.block_size)]
        index = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            layers = [
                {name: _to_wire(arr.index_select(0, index)) for name, arr in layer.items()}
                for layer in self._pool
            ]
        kv_heads = self.config.num_kv_heads or self.config.num_heads
        meta = {
            "format": 1,
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
            "num_layers": self.config.num_layers,
            "kv_heads": kv_heads,
            "d_head": self.config.d_head,
            "context_length": self.config.context_length,
            "n_blocks": len(ids),
            "prompt": [int(t) for t in info.prompt],
            "prompt_len": info.prompt_len,
            "next_pos": info.next_pos,
            "decoding": decoding,
            "generated": info.generated,
            "max_new_tokens": info.max_new_tokens,
            "stop_id": info.stop_id,
            "seed": info.seed,
            # float32-rounded, as the JAX engine keeps its knobs.
            "temperature": float(np.float32(info.temperature)),
            "top_k": int(info.top_k),
            "top_p": float(np.float32(info.top_p)),
            "token": int(self._tokens[slot]),
            "position": int(self._positions[slot]),
            "key": threefry_key(info.seed),
            "request_id": info.request_id,
        }
        gen = self._generators[slot]
        if decoding and gen is not None:
            meta["torch_rng"] = generator_state(gen)
        if extra_meta:
            meta.update(extra_meta)
        return {"meta": meta, "layers": layers}

    def validate_import_meta(self, meta: dict) -> None:
        """Refuse a payload this engine cannot graft: a geometry or pool
        dtype mismatch is a configuration error, caught before any block is
        allocated (HTTP 400, never a half-grafted slot)."""
        if meta.get("format") != 1:
            raise ValueError(f"unsupported payload format {meta.get('format')!r}")
        kv_heads = self.config.num_kv_heads or self.config.num_heads
        expect = {
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
            "num_layers": self.config.num_layers,
            "kv_heads": kv_heads,
            "d_head": self.config.d_head,
            "context_length": self.config.context_length,
        }
        for key, want in expect.items():
            got = meta.get(key)
            if got != want:
                raise ValueError(f"payload {key}={got!r} does not match this engine's {want!r}")
        if meta["n_blocks"] > self.blocks_per_slot:
            raise ValueError(
                f"payload carries {meta['n_blocks']} blocks; a slot here holds at most "
                f"{self.blocks_per_slot}"
            )
        need = max(meta["n_blocks"], self.blocks_needed(meta["prompt_len"], meta["max_new_tokens"]))
        if need > self.allocator.usable_blocks:
            # Could never land (parking it would deadlock the import queue).
            raise ValueError(
                f"grafting needs {need} KV blocks; the pool holds {self.allocator.usable_blocks}"
            )
        if not meta["decoding"] and meta["next_pos"] % self.block_size:
            raise ValueError(
                f"mid-prefill frontier {meta['next_pos']} is not block-aligned "
                f"(block_size={self.block_size})"
            )

    def validate_import_payload(self, payload: dict) -> None:
        """:meth:`validate_import_meta` plus a structural check of the
        shipped arrays against the meta (names, shapes, wire dtypes), so an
        inconsistent payload fails at the transport (HTTP 400) and never in
        the worker thread."""
        meta = payload["meta"]
        self.validate_import_meta(meta)
        layers = payload["layers"]
        if len(layers) != self.config.num_layers:
            raise ValueError(
                f"payload ships {len(layers)} layers; this engine has {self.config.num_layers}"
            )
        names = set(self._pool[0])
        n = int(meta["n_blocks"])
        for li, (layer, pool_layer) in enumerate(zip(layers, self._pool)):
            if set(layer) != names:
                raise ValueError(
                    f"payload layer {li} arrays {sorted(layer)} do not match the pool's "
                    f"{sorted(names)}"
                )
            for name, arr in layer.items():
                want_shape = (n,) + tuple(pool_layer[name].shape[1:])
                want_dtype = str(pool_layer[name].dtype).removeprefix("torch.")
                got_dtype = wire_dtype(arr)
                if tuple(arr.shape) != want_shape or got_dtype != want_dtype:
                    raise ValueError(
                        f"payload layer {li} array {name!r} is {got_dtype}{tuple(arr.shape)}; "
                        f"this pool wants {want_dtype}{want_shape}"
                    )

    def import_slot(self, payload: dict) -> int:
        """Graft a migration payload into this pool and return its slot:
        fresh blocks (prefix-cache LRU leaves evicted to cover a shortfall,
        :class:`NoFreeBlocksError` when the pool still cannot: the caller
        parks and retries), the rows scattered with one indexed copy per
        pool array, the rest of the admission's chain re-reserved, and the
        generation state restored so the next :meth:`tick` (or
        :meth:`prefill_step`, mid-prefill) continues where the exporter
        stopped.  A finished prefix's full prompt blocks are indexed into
        the radix cache."""
        meta = payload["meta"]
        self.validate_import_payload(payload)
        free = [s for s in range(self.n_slots) if self._slots[s] is None]
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        n = int(meta["n_blocks"])
        chain = max(n, self.blocks_needed(int(meta["prompt_len"]), int(meta["max_new_tokens"])))
        fresh = self._alloc_blocks(chain)
        self._tables[slot, :chain] = fresh
        self._tables[slot, chain:] = 0
        if n:
            index = torch.as_tensor(fresh[:n], dtype=torch.long, device=self.device)
            with torch.inference_mode():
                for layer, pool_layer in zip(payload["layers"], self._pool):
                    for name, arr in pool_layer.items():
                        arr.index_copy_(0, index, _from_wire(layer[name]).to(self.device))

        prompt = np.asarray(meta["prompt"], np.int64)
        plen = int(meta["prompt_len"])
        info = PagedSlotInfo(
            prompt=prompt,
            prompt_len=plen,
            bucket=self.bucket_for(min(plen, self.prefill_chunk)),
            max_new_tokens=int(meta["max_new_tokens"]),
            stop_id=meta["stop_id"],
            seed=int(meta["seed"]),
            temperature=float(meta["temperature"]),
            top_k=int(meta["top_k"]),
            top_p=float(meta["top_p"]),
            block_ids=fresh,
            shared_len=0,
            next_pos=int(meta["next_pos"]),
            generated=int(meta["generated"]),
            request_id=meta.get("request_id"),
        )
        self._slots[slot] = info
        if meta["decoding"]:
            self._tokens[slot] = int(meta["token"])
            self._positions[slot] = int(meta["position"])
            self._temps[slot] = info.temperature
            self._top_ks[slot] = info.top_k
            self._top_ps[slot] = info.top_p
            self._generators[slot] = restore_generator(meta.get("torch_rng"), info.seed,
                                                       self.device)
            self._active[slot] = True
            if self.prefix_cache is not None:
                full = plen // self.block_size
                if full:
                    self.prefix_cache.insert([int(t) for t in prompt[: full * self.block_size]],
                                             fresh[:full])
        else:
            self._prefilling.append(slot)
        return slot

    def begin(
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
    ) -> int:
        """Reserve a slot and its worst-case block chain (prefix-cache
        blocks reused by reference) and queue the prompt for chunked
        prefill; returns the slot.  Raises ``RuntimeError`` when no slot is
        free and :class:`NoFreeBlocksError` when the pool (after eviction)
        cannot cover the chain: the caller parks the admission and retries
        as retirements free blocks."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        ctx = self.config.context_length
        if plen < 1:
            raise ValueError("prompt must contain at least one token")
        if plen > ctx - 1:
            raise ValueError(
                f"prompt of {plen} tokens leaves no room to generate in a context of {ctx}"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        free = [s for s in range(self.n_slots) if self._slots[s] is None]
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]

        need = self.blocks_needed(plen, max_new_tokens)
        if need > self.allocator.usable_blocks:
            raise ValueError(
                f"request needs {need} KV blocks; the pool holds {self.allocator.usable_blocks}"
            )
        matched: list[int] = []
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match([int(t) for t in prompt])
        try:
            fresh = self._alloc_blocks(need - len(matched))
        except NoFreeBlocksError:
            if matched:
                self.allocator.deref(matched)
            raise
        block_ids = matched + fresh
        self._tables[slot, : len(block_ids)] = block_ids
        self._tables[slot, len(block_ids):] = 0

        shared_len = len(matched) * self.block_size
        if self.prefix_cache is not None:
            # Charged only now that the admission proceeds: a parked request
            # re-matches on every retry.
            self.prefix_cache.charge(plen, shared_len)
        self._slots[slot] = PagedSlotInfo(
            prompt=prompt,
            prompt_len=plen,
            bucket=self.bucket_for(min(plen - shared_len, self.prefill_chunk)),
            max_new_tokens=min(max_new_tokens, ctx - plen),
            stop_id=stop_id,
            seed=seed,
            temperature=temperature,
            top_k=TOP_K_DISABLED if top_k is None else top_k,
            top_p=TOP_P_DISABLED if top_p is None else top_p,
            block_ids=block_ids,
            shared_len=shared_len,
            next_pos=shared_len,
            request_id=request_id,
        )
        self._prefilling.append(slot)
        return slot

    @torch.inference_mode()
    def prefill_step(self, slot: int) -> TickEvent | None:
        """Run ONE prefill chunk of ``slot``.  Returns ``None`` while chunks
        remain; on the final chunk samples the first token, activates the
        slot for ticks, indexes the prompt's full blocks into the prefix
        cache and returns the admission's :class:`TickEvent`."""
        info = self._slots[slot]
        if info is None or slot not in self._prefilling:
            raise ValueError(f"slot {slot} has no pending prefill")
        plen = info.prompt_len
        chunk_len = min(self.prefill_chunk, plen - info.next_pos)
        padded = np.zeros((1, self.bucket_for(chunk_len)), np.int64)
        padded[0, :chunk_len] = info.prompt[info.next_pos : info.next_pos + chunk_len]
        dev = self.device
        logits, _ = paged_chunk_prefill(
            self._params, torch.as_tensor(padded, device=dev), info.next_pos, chunk_len,
            torch.as_tensor(self._tables[slot], device=dev), self._pool, self.config,
            lm_head=self._lm_head, block_size=self.block_size,
        )
        info.next_pos += chunk_len
        if info.next_pos < plen:
            return None

        self._prefilling.remove(slot)
        self._temps[slot] = info.temperature
        self._top_ks[slot] = info.top_k
        self._top_ps[slot] = info.top_p
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(info.seed))
        self._generators[slot] = gen
        token = int(self._sample(logits, [slot], [slot])[0])
        self._tokens[slot] = token
        self._positions[slot] = plen
        self._active[slot] = True
        info.generated = 1
        self.tokens_emitted += 1
        if self.prefix_cache is not None:
            full = plen // self.block_size
            if full:
                self.prefix_cache.insert(
                    [int(t) for t in info.prompt[: full * self.block_size]],
                    info.block_ids[:full],
                )
        finished = self._finish_reason(info, token)
        if finished:
            self.release(slot)
        return TickEvent(slot=slot, token=token, finished=finished)

    def admit(self, prompt_ids, **knobs) -> TickEvent:
        """The dense engine's admission: :meth:`begin` (same keyword
        arguments) and every prefill chunk back to back."""
        slot = self.begin(prompt_ids, **knobs)
        while True:
            event = self.prefill_step(slot)
            if event is not None:
                return event

    @torch.inference_mode()
    def tick(self) -> list[TickEvent]:
        """One batched decode step across every active slot, as the dense
        engine's tick: slots mid-prefill and free slots write only the trash
        block and keep their state."""
        if not self._active.any():
            return []
        dev = self.device
        out, _ = paged_decode_step(
            self._params,
            torch.as_tensor(self._tokens, device=dev),
            torch.as_tensor(self._positions, device=dev),
            self._pool,
            torch.as_tensor(self._tables, device=dev),
            self.config,
            lm_head=self._lm_head,
            active=torch.as_tensor(self._active, device=dev),
            return_hidden=self.fused_sampling,
            block_size=self.block_size,
        )
        live = [int(s) for s in np.flatnonzero(self._active)]
        if self.fused_sampling:
            tokens = self._fused_sample(out, live).cpu().numpy()
        else:
            tokens = self._sample(out, list(range(self.n_slots)), live).cpu().numpy()
        self.ticks += 1

        events: list[TickEvent] = []
        for slot in live:
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

    def extend_blocks(self, slot: int, upto_len: int) -> None:
        """Grow ``slot``'s block chain to cover ``upto_len`` positions
        (speculative scratch: the verify pass writes a few positions past
        the admission's reservation, and :meth:`rewind` returns what the
        acceptance did not keep).  Raises :class:`NoFreeBlocksError` when
        the pool is dry: the caller shrinks its speculation window instead
        of parking."""
        info = self._slots[slot]
        if info is None:
            raise ValueError(f"slot {slot} is not occupied")
        need = -(-min(upto_len, self.config.context_length) // self.block_size)
        extra = need - len(info.block_ids)
        if extra <= 0:
            return
        fresh = self._alloc_blocks(extra)
        start = len(info.block_ids)
        info.block_ids.extend(fresh)
        self._tables[slot, start : start + len(fresh)] = fresh

    @torch.inference_mode()
    def rewind(self, slot: int, new_len: int, *, keep_blocks: int | None = None) -> dict:
        """Roll ``slot``'s written-KV frontier back to ``new_len`` tokens:
        positions ``0..new_len-1`` stay valid, everything past them is
        abandoned (a speculative rejection).

        * Within a block this is bookkeeping: abandoned rows stay in the pool
          but every reader masks keys by the slot's position.
        * Chain blocks wholly past the frontier are dereferenced (returned to
          the pool on their last reference); ``keep_blocks`` floors the chain
          length, so a caller mid-generation keeps its admission's
          reservation and only speculative scratch is released.
        * Copy-on-write: when the block the next write lands in is shared
          (radix-indexed, or held by another slot) it is replaced by a fresh
          copy of all its rows (and, in an int8 pool, its scale rows); the
          shared block is never written.  The copy may evict prefix-cache
          leaves and raises :class:`NoFreeBlocksError` when the pool cannot
          supply the block.
        * int8 pools: a block's scale only grows within one occupancy, so a
          rewound row's magnitude stays in its block's scale until the block
          is vacated; later writes quantize against that scale.

        Returns ``{"released": n_blocks, "cow": bool}``; the caller owns the
        position and sampling state."""
        info = self._slots[slot]
        if info is None:
            raise ValueError(f"slot {slot} is not occupied")
        if slot in self._prefilling:
            raise ValueError(f"slot {slot} is mid-prefill; cannot rewind")
        ctx = self.config.context_length
        if new_len < 0 or new_len > ctx:
            raise ValueError(f"new_len={new_len} outside [0, {ctx}]")
        bs = self.block_size
        floor = max(-(-new_len // bs), keep_blocks or 0)
        released = 0
        if floor < len(info.block_ids):
            dropped = info.block_ids[floor:]
            info.block_ids = info.block_ids[:floor]
            self.allocator.deref(dropped)
            released = len(dropped)
            self._tables[slot, floor:] = 0
        cow = False
        idx = new_len // bs
        if idx < len(info.block_ids):
            shared = info.block_ids[idx]
            if self.allocator.refcount(shared) > 1:
                fresh = self._alloc_blocks(1)[0]
                for layer in self._pool:
                    for arr in layer.values():
                        arr[fresh] = arr[shared]
                self.allocator.deref([shared])
                info.block_ids[idx] = fresh
                self._tables[slot, idx] = fresh
                cow = True
        info.shared_len = min(info.shared_len, new_len)
        if self.recorder is not None:
            # Coalesced per slot: spec verify passes rewind every tick.
            self.recorder.record(
                "rewind", coalesce=True, request_id=info.request_id, slot=slot,
                new_len=new_len, released=released or None, cow=cow or None,
            )
        return {"released": released, "cow": cow}

    def release(self, slot: int) -> None:
        """Free a slot: drop its block references (blocks the prefix cache
        indexes survive for later hits) and clear its table row."""
        info = self._slots[slot]
        self._active[slot] = False
        self._slots[slot] = None
        self._generators[slot] = None
        if slot in self._prefilling:
            self._prefilling.remove(slot)
        if info is not None and info.block_ids:
            self.allocator.deref(info.block_ids)
        self._tables[slot, :] = 0
