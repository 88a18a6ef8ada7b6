"""Speculative decoding on the paged engine (port of
``bpe_transformer_tpu/serving/spec/engine.py``): draft propose, one batched
target verify, Leviathan rejection sampling, KV rewind.

Each tick a :class:`~bpe_transformer_tpu_torch.serving.spec.draft.DraftModel`
guesses K tokens per slot over its own dense cache, one target pass scores
all K+1 positions through the paged pool
(:func:`~bpe_transformer_tpu_torch.models.decode.paged_verify_step`), and
the acceptance rule keeps a per-slot prefix: a tick emits 1 to K+1 tokens
per slot.

**The law** (Leviathan et al.): with target distribution ``p`` and draft
distribution ``q``, both after the slot's temperature/top-k/top-p filter,
draft token ``d ~ q`` is accepted iff ``u q(d) < p(d)`` with ``u ~ U[0,
1)``; on a rejection the emitted token is drawn from ``normalize(max(p - q,
0))``, and after a fully accepted window from ``p``.  The emitted tokens
follow ``p`` exactly.  Greedy slots make both sides exact one-hots: accept
while the target argmax agrees, then emit it, so greedy speculative output
is token-identical to the paged engine's.

**KV**: verify writes K/V for every scored position; the engine rolls each
slot back to its last emitted token with :meth:`PagedEngine.rewind`,
releasing the scratch blocks that :meth:`PagedEngine.extend_blocks` took
past the admission's reservation.

**Noise**: ``u`` ``(S, K)`` and the bonus gumbel rows ``(S, K+1, V)`` come
from each sampled slot's own ``torch.Generator`` (the law is JAX's; the
bits differ, as the dense engine's sampling does); the draft draws from a
second generator per slot, seeded ``seed ^ 0x5BEC`` as in JAX.

``fused_sampling=True`` runs the verify tail (head projection, filter,
``p(d)``, residual sample) in the fused kernel
(``kernels/sample.py::fused_verify_head``) on the verify pass's hidden
states.

**Migration**: :meth:`SpecEngine.export_slot` adds the draft generator's
state (``torch_draft_rng``) and, for JAX readers, the threefry
``PRNGKey(seed ^ 0x5BEC)`` pair as ``draft_key``; :meth:`import_slot`
re-prefills the draft's dense cache from ``meta["history"]`` (the draft
cache does not travel), so greedy migration is token-identical either way.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bpe_transformer_tpu_torch.models.config import ModelConfig
from bpe_transformer_tpu_torch.models.decode import init_kv_cache, paged_verify_step
from bpe_transformer_tpu_torch.serving.engine import (
    TickEvent,
    activation_dtype,
    default_prefill_buckets,
    gumbel_noise,
)
from bpe_transformer_tpu_torch.serving.kvpool.blocks import NoFreeBlocksError
from bpe_transformer_tpu_torch.serving.kvpool.paged_engine import (
    PagedEngine,
    generator_state,
    restore_generator,
    threefry_key,
)
from bpe_transformer_tpu_torch.serving.spec.draft import (
    DraftModel,
    DraftSpec,
    draft_prefill,
    propose,
)

__all__ = ["SpecEngine", "spec_verify_tail"]


def spec_verify_tail(scores, lm_head, draft_tokens, draft_probs, rooms, active, base_tokens,
                     temps, top_ks, top_ps, u, gumbel, *, fused: bool, logits_out=None):
    """The verify tail as a function from noise to tokens.

    ``scores`` are the verify pass's logits ``(S, K+1, V)``, or its hidden
    states ``(S, K+1, d)`` under ``fused`` (then ``lm_head`` projects them in
    the fused kernel); ``draft_tokens`` ``(S, K)`` and ``draft_probs`` ``(S,
    K, V)`` the draft's tokens and the distributions they were drawn from;
    ``rooms`` ``(S,)`` how many proposals each slot may judge; knobs ``(S,)``;
    ``u`` ``(S, K)`` uniforms; ``gumbel`` ``(S, K+1, V)``.  Row ``j`` of the
    scores is the target distribution of the position after ``tokens[j]``:
    rows ``0..K-1`` judge ``d_1..d_K`` and row ``n_acc`` (the accepted count)
    supplies the bonus token, a sample of the residual ``max(p - q, 0)``, or
    of ``p`` when every judged row was accepted (``q`` is zeroed from row
    ``min(rooms, K)`` on).  Both modes sample the residual of every row
    (:func:`kernels.sample.verify_rows`, or the fused kernel) and select row
    ``n_acc``.  Returns ``(out_tokens (S, K+1), n_emit (S,))``: each active
    slot emits ``out_tokens[:n_emit]``; inactive slots emit nothing."""
    from bpe_transformer_tpu_torch.kernels.sample import fused_verify_head, verify_rows

    s, k = draft_tokens.shape
    k1, vocab = k + 1, draft_probs.shape[-1]
    dev = draft_tokens.device
    iota = torch.arange(k1, device=dev)[None, :]
    judged = iota[:, :k] < rooms[:, None]
    q_d = torch.gather(draft_probs, 2, draft_tokens[..., None])[..., 0]
    q_pad = torch.cat([draft_probs, torch.zeros((s, 1, vocab), device=dev)], dim=1)
    q_pad = torch.where((iota < rooms.clamp(max=k)[:, None])[..., None], q_pad, 0.0)
    judge = torch.cat([draft_tokens, torch.zeros((s, 1), dtype=draft_tokens.dtype, device=dev)],
                      dim=1)
    rows = (temps.repeat_interleave(k1), top_ks.repeat_interleave(k1),
            top_ps.repeat_interleave(k1), judge.reshape(-1), q_pad.reshape(s * k1, vocab),
            gumbel.reshape(s * k1, vocab))
    if fused:
        greedy, p_d, bonus_rows = fused_verify_head(scores.reshape(s * k1, -1), lm_head, *rows,
                                                    logits_out=logits_out)
    else:
        greedy, p_d, bonus_rows = verify_rows(scores.reshape(s * k1, vocab), *rows)
    p_d = p_d.reshape(s, k1)[:, :k]
    accept = (u * q_d < p_d) & judged
    n_acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    bonus = torch.gather(bonus_rows.reshape(s, k1), 1, n_acc[:, None])[:, 0]
    d_pad = torch.cat([draft_tokens, draft_tokens[:, -1:]], dim=1)
    out = torch.where(iota < n_acc[:, None], d_pad, bonus[:, None])
    out = torch.where(active[:, None], out, base_tokens[:, None])
    n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    return out, n_emit


class SpecEngine(PagedEngine):
    """The paged engine where one :meth:`tick` may emit several tokens per
    slot: events for one slot come in emission order, ``finished`` on the
    last.  ``draft`` is a :class:`DraftSpec` (resolved against the target
    here, over the engine's serving weights) or a built
    :class:`DraftModel`; ``speculate_k`` is the window K."""

    def __init__(self, params, config: ModelConfig, *, draft, speculate_k: int,
                 min_bucket: int = 16, **paged_kwargs):
        if speculate_k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {speculate_k}")
        super().__init__(params, config, min_bucket=min_bucket, **paged_kwargs)
        if isinstance(draft, DraftSpec):
            # Over the serving weights: a truncated view then shares the very
            # tensors the target runs on.
            draft = DraftModel(self._params, config, draft, device=self.device)
        if draft.config.vocab_size != config.vocab_size:
            raise ValueError(
                f"draft vocab_size={draft.config.vocab_size} != target {config.vocab_size}"
            )
        if draft.config.context_length != config.context_length:
            raise ValueError(
                f"draft context_length={draft.config.context_length} != target "
                f"{config.context_length}"
            )
        self.draft = draft
        self.k = speculate_k
        self._draft_cache = init_kv_cache(draft.config, self.n_slots,
                                          dtype=activation_dtype(draft.config), device=self.device)
        self._draft_generators: list[torch.Generator | None] = [None] * self.n_slots
        #: The draft prefills whole prompts (its dense cache shares no
        #: prefix), so its ladder runs to the full context.
        self._draft_buckets = default_prefill_buckets(config.context_length, min_bucket)
        self._verify_ws = (
            torch.empty((self.n_slots * (speculate_k + 1), config.vocab_size),
                        dtype=torch.float32, device=self.device)
            if self.fused_sampling else None
        )
        self.spec_proposed = 0  # draft tokens judged (<= K a slot a tick)
        self.spec_accepted = 0  # judged tokens the target kept
        self.spec_emitted = 0  # tokens emitted by spec ticks
        #: One per active slot per tick: a plain engine would have paid one
        #: tick per unit, so emitted / target_steps is the ticks-saved ratio
        #: (1 = no gain, K+1 the ceiling), whatever the batch.
        self.spec_target_steps = 0
        self.spec_rewound = 0  # written positions rolled back
        self.draft_time_s = 0.0  # host clock inside the draft's propose
        self.tick_time_s = 0.0  # host clock of whole spec ticks

    # ------------------------------------------------------------- queries

    def spec_gauges(self) -> dict:
        """Acceptance rate, emitted tokens per target verify, and the
        draft's share of the tick."""
        proposed, accepted = self.spec_proposed, self.spec_accepted
        return {
            "spec_k": self.k,
            "spec_proposed_tokens": proposed,
            "spec_accepted_tokens": accepted,
            "spec_emitted_tokens": self.spec_emitted,
            "spec_target_steps": self.spec_target_steps,
            "spec_accept_rate": round(accepted / proposed, 6) if proposed else None,
            "spec_tokens_per_target_step": (
                round(self.spec_emitted / self.spec_target_steps, 6)
                if self.spec_target_steps else None
            ),
            "spec_rewound_tokens": self.spec_rewound,
            "spec_draft_time_s": round(self.draft_time_s, 6),
            "spec_tick_time_s": round(self.tick_time_s, 6),
            "spec_draft_frac": (
                round(self.draft_time_s / self.tick_time_s, 6) if self.tick_time_s > 0 else None
            ),
        }

    def gauges(self) -> dict:
        out = super().gauges()
        out.update(self.spec_gauges())
        return out

    # ------------------------------------------------------------ migration

    def export_slot(self, slot: int, extra_meta: dict | None = None) -> dict:
        """The paged payload plus the slot's draft sampling state, so a
        speculative importer's proposal chain continues where this one's
        left off (greedy migration is exact regardless: the emitted chain is
        the target's argmax chain)."""
        extra = dict(extra_meta or {})
        if self._active[slot]:
            extra.setdefault("draft_key", threefry_key(int(self._slots[slot].seed) ^ 0x5BEC))
            gen = self._draft_generators[slot]
            if gen is not None:
                extra.setdefault("torch_draft_rng", generator_state(gen))
        return super().export_slot(slot, extra)

    def import_slot(self, payload: dict) -> int:
        """Graft, then bring the draft up: its dense cache does not travel,
        so it re-prefills from the grafted prefix's token history
        (``meta["history"]``: the prompt and every emitted token), the
        catch-up a fresh admission's final chunk performs.  A decoding
        payload without a history is refused."""
        meta = payload["meta"]
        if meta.get("decoding") and meta.get("history") is None:
            raise ValueError(
                "speculative import needs meta['history'] (prompt + emitted tokens) to "
                "re-prefill the draft cache"
            )
        slot = super().import_slot(payload)
        if meta["decoding"]:
            pos = int(meta["position"])
            history = np.asarray([int(t) for t in meta["history"]][:pos], np.int64)
            with torch.inference_mode():
                draft_prefill(self.draft, self._draft_cache, history, slot,
                              self._draft_bucket_for(pos))
            self._draft_generators[slot] = restore_generator(
                meta.get("torch_draft_rng"), int(meta["seed"]) ^ 0x5BEC, self.device)
        return slot

    # ------------------------------------------------------------ lifecycle

    def _draft_bucket_for(self, length: int) -> int:
        for b in self._draft_buckets:
            if length <= b:
                return b
        return self._draft_buckets[-1]

    def prefill_step(self, slot: int) -> TickEvent | None:
        event = super().prefill_step(slot)
        if event is None or event.finished:
            return event
        # The final chunk landed and the slot decodes on: bring the draft's
        # cache to the same history and seed its own sampling chain.
        info = self._slots[slot]
        draft_prefill(self.draft, self._draft_cache, info.prompt, slot,
                      self._draft_bucket_for(info.prompt_len))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(info.seed) ^ 0x5BEC)
        self._draft_generators[slot] = gen
        return event

    def release(self, slot: int) -> None:
        super().release(slot)
        self._draft_generators[slot] = None

    def _verify_noise(self):
        """``u (S, K)`` and ``gumbel (S, K+1, V)``: drawn from each active
        sampled slot's generator, in that order; zeros elsewhere."""
        n, k, vocab, dev = self.n_slots, self.k, self.config.vocab_size, self.device
        u = torch.zeros((n, k), dtype=torch.float32, device=dev)
        gumbel = torch.zeros((n, k + 1, vocab), dtype=torch.float32, device=dev)
        for slot in np.flatnonzero(self._active & (self._temps > 0.0)):
            gen = self._generators[int(slot)]
            u[slot] = torch.rand(k, generator=gen, device=dev)
            gumbel[slot] = gumbel_noise(gen, (k + 1, vocab), dev)
        return u, gumbel

    @torch.inference_mode()
    def tick(self) -> list[TickEvent]:
        """One speculative tick: propose K, verify K+1, accept and resample,
        emit 1..K+1 tokens per slot, rewind the rejected tail."""
        if not self._active.any():
            return []
        t0 = time.perf_counter()
        d_toks, d_probs = propose(
            self.draft, self._draft_cache, self._tokens, self._positions, self._active,
            self._temps, self._top_ks, self._top_ps, self._draft_generators, self.k,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_draft = time.perf_counter()

        # Per-slot headroom: the context edge, then whatever scratch blocks
        # the pool can spare past the admission's reservation (a starved
        # slot shrinks its window; the reservation always backs room >= 1).
        ctx = self.config.context_length
        rooms = np.zeros(self.n_slots, np.int64)
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            info = self._slots[slot]
            p = int(self._positions[slot])
            room = min(self.k, ctx - 1 - p)
            try:
                self.extend_blocks(slot, p + room + 1)
            except NoFreeBlocksError:
                room = min(room, len(info.block_ids) * self.block_size - 1 - p)
            rooms[slot] = room

        dev = self.device
        base = torch.as_tensor(self._tokens, device=dev)
        rooms_t = torch.as_tensor(rooms, device=dev)
        active = torch.as_tensor(self._active, device=dev)
        scores, _ = paged_verify_step(
            self._params, torch.cat([base[:, None], d_toks], dim=1),
            torch.as_tensor(self._positions, device=dev), rooms_t, self._pool,
            torch.as_tensor(self._tables, device=dev), self.config, lm_head=self._lm_head,
            active=active, return_hidden=self.fused_sampling, block_size=self.block_size,
        )
        u, gumbel = self._verify_noise()
        out, n_emit = spec_verify_tail(
            scores, self._lm_head, d_toks, d_probs, rooms_t, active, base,
            torch.as_tensor(self._temps, device=dev), torch.as_tensor(self._top_ks, device=dev),
            torch.as_tensor(self._top_ps, device=dev), u, gumbel, fused=self.fused_sampling,
            logits_out=self._verify_ws,
        )
        out, n_emit = out.cpu().numpy(), n_emit.cpu().numpy()
        self.ticks += 1

        events: list[TickEvent] = []
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            info = self._slots[slot]
            p, room, emit = int(self._positions[slot]), int(rooms[slot]), int(n_emit[slot])
            self.spec_proposed += room
            self.spec_accepted += emit - 1
            self.spec_target_steps += 1
            emitted, finished = 0, None
            for j in range(emit):
                token = int(out[slot, j])
                info.generated += 1
                self.tokens_emitted += 1
                self.spec_emitted += 1
                emitted += 1
                finished = self._finish_reason(info, token)
                events.append(TickEvent(slot=slot, token=token, finished=finished))
                if finished:
                    break
            new_p = p + emitted
            self._tokens[slot] = int(out[slot, emitted - 1])
            self._positions[slot] = new_p
            if finished:
                self.release(slot)
            else:
                # Valid KV ends at the last emitted token; what verify wrote
                # past it rolls back, and scratch blocks past the admission's
                # reservation return to the pool.
                self.spec_rewound += max(0, p + room + 1 - new_p)
                self.rewind(slot, new_p,
                            keep_blocks=self.blocks_needed(info.prompt_len, info.max_new_tokens))
        now = time.perf_counter()
        self.draft_time_s += t_draft - t0
        self.tick_time_s += now - t0
        return events
