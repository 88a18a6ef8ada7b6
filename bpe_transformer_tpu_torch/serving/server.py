"""In-process serving front end (port of the dense and paged engines'
subset of ``bpe_transformer_tpu/serving/server.py``): ``Request``/``Result``
types and the blocking + streaming :class:`ServingEngine`.

Layering (one thread owns the card):

* callers (``generate``, ``stream``, ``run_batch``) only touch the
  :class:`FifoScheduler` and per-request completion events;
* ONE worker thread runs the engine loop: admit queued requests into free
  slots, run prefill (the dense engine's whole prompt at admission, or the
  paged engine's chunks under a per-tick token budget), a decode tick
  across every occupied slot, deliver tokens to the per-request streams,
  retire finished slots;
* backpressure surfaces at submit time as :class:`QueueFullError`.

With ``paged=True`` the engine is the paged
:class:`~bpe_transformer_tpu_torch.serving.kvpool.PagedEngine`: an
admission the block pool cannot cover yet is PARKED and retried first,
strictly in FIFO order, as retirements free blocks (newer requests wait
behind it), and parked requests still expire at their deadline and can be
cancelled.  ``speculate_k`` with a ``draft_spec`` (and ``paged=True``)
serves through the speculative
:class:`~bpe_transformer_tpu_torch.serving.spec.SpecEngine`, whose tick may
deliver several tokens of one request; ``fused_sampling=True`` ends every
tick with the fused head + sample kernel.

KV migration, roles, telemetry, alerts, the flight recorder and the HTTP
transport are not ported yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import uuid
from typing import Iterator

import torch

from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine, TickEvent
from bpe_transformer_tpu_torch.serving.kvpool import NoFreeBlocksError, PagedEngine
from bpe_transformer_tpu_torch.serving.scheduler import (
    FifoScheduler,
    PrefillBudget,
    QueueFullError,
)
from bpe_transformer_tpu_torch.serving.spec import SpecEngine

__all__ = ["Request", "Result", "RequestHandle", "ServingEngine", "QueueFullError"]

_STREAM_END = object()


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (token ids; transports tokenize)."""

    prompt_ids: tuple[int, ...]
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int = 0
    stop_id: int | None = None
    #: Seconds the request may wait IN THE QUEUE before it fails fast with
    #: ``finish_reason="deadline"`` (None: wait indefinitely).
    deadline_s: float | None = None
    request_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)


@dataclasses.dataclass(frozen=True)
class Result:
    """A finished request: generated ids, why it stopped, phase timings."""

    request_id: str
    token_ids: tuple[int, ...]
    finish_reason: str  # stop | length | deadline | cancelled | error
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0


class _Entry:
    """Worker-side state for one submitted request."""

    __slots__ = (
        "request", "tokens", "stream", "done", "result", "slot", "t_submit",
        "t_decode_start", "queue_wait_s", "prefill_s", "cancel_requested",
    )

    def __init__(self, request: Request, t_submit: float):
        self.request = request
        self.tokens: list[int] = []
        self.stream: queue.Queue = queue.Queue()
        self.done = threading.Event()
        self.result: Result | None = None
        self.slot: int | None = None
        self.t_submit = t_submit
        self.t_decode_start = t_submit
        self.queue_wait_s = 0.0
        self.prefill_s = 0.0
        self.cancel_requested = False


class RequestHandle:
    """Caller-side view of an in-flight request."""

    def __init__(self, serving: "ServingEngine", entry: _Entry):
        self._serving = serving
        self._entry = entry

    @property
    def request_id(self) -> str:
        return self._entry.request.request_id

    def result(self, timeout: float | None = None) -> Result:
        """Block until the request finishes; raises TimeoutError."""
        if not self._entry.done.wait(timeout):
            raise TimeoutError(f"request {self.request_id} not done within {timeout}s")
        return self._entry.result

    def tokens(self) -> Iterator[int]:
        """Stream token ids as the engine emits them (ends at completion)."""
        while True:
            item = self._entry.stream.get()
            if item is _STREAM_END:
                return
            yield item

    def cancel(self) -> None:
        self._serving.cancel(self.request_id)


class ServingEngine:
    """Continuous-batching serving: scheduler + slot pool + worker thread.

    Use as a context manager (or call :meth:`start`/:meth:`close`)::

        with ServingEngine(params, config, slots=8) as serving:
            result = serving.generate([1, 2, 3], max_new_tokens=16)
    """

    def __init__(
        self,
        params,
        config,
        *,
        slots: int = 8,
        max_queue: int = 64,
        max_wait_s: float = 0.0,
        prefill_buckets: tuple[int, ...] | None = None,
        min_bucket: int = 16,
        default_stop_id: int | None = None,
        default_max_new_tokens: int = 128,
        idle_poll_s: float = 0.02,
        clock=time.monotonic,
        weight_dtype: str | None = None,
        paged: bool = False,
        block_size: int = 16,
        num_kv_blocks: int | None = None,
        prefill_chunk: int | None = None,
        prefill_token_budget: int | None = None,
        prefix_cache: bool = True,
        kv_dtype: str | None = None,
        fused_sampling: bool = False,
        speculate_k: int = 0,
        draft_spec=None,
        device: str | torch.device = "cuda",
    ):
        if kv_dtype is not None and not paged:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} needs paged=True (the int8 KV blocks live in the "
                "block pool)"
            )
        if speculate_k and not paged:
            raise ValueError(
                "speculate_k needs paged=True (the verify pass scores through the paged "
                "scatter; the KV rewind lives in the block pool)"
            )
        if speculate_k and draft_spec is None:
            raise ValueError("speculate_k needs a draft_spec (DraftSpec or a built DraftModel)")
        if paged:
            kwargs = dict(
                slots=slots, block_size=block_size, num_blocks=num_kv_blocks,
                prefill_buckets=prefill_buckets, min_bucket=min_bucket,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache, kv_dtype=kv_dtype,
                weight_dtype=weight_dtype, fused_sampling=fused_sampling, device=device,
            )
            if speculate_k:
                self.engine = SpecEngine(params, config, draft=draft_spec,
                                         speculate_k=speculate_k, **kwargs)
            else:
                self.engine = PagedEngine(params, config, **kwargs)
        else:
            self.engine = SlotPoolEngine(
                params, config, slots=slots, prefill_buckets=prefill_buckets,
                min_bucket=min_bucket, weight_dtype=weight_dtype,
                fused_sampling=fused_sampling, device=device,
            )
        self.paged = paged
        #: Speculative decoding is on (the engine is a SpecEngine).
        self.spec = bool(speculate_k)
        #: Prefill tokens allowed between consecutive decode ticks (paged
        #: only; None runs each prefill to completion, the dense schedule).
        self._prefill_budget = PrefillBudget(prefill_token_budget if paged else None)
        #: Admissions parked on KV-block exhaustion (paged), retried in FIFO
        #: order before any newer queue pop.
        self._admit_backlog: list[_Entry] = []
        #: Slots mid-chunked-prefill -> their entries (paged).
        self._prefill_entries: dict[int, _Entry] = {}
        self.scheduler = FifoScheduler(max_queue=max_queue, max_wait_s=max_wait_s, clock=clock)
        self.default_stop_id = default_stop_id
        self.default_max_new_tokens = default_max_new_tokens
        self._idle_poll_s = idle_poll_s
        self._clock = clock
        self._entries: dict[str, _Entry] = {}
        self._entries_lock = threading.Lock()
        self._slot_entries: dict[int, _Entry] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        self._worker_error: BaseException | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the worker; in-flight and queued requests finish as
        ``cancelled``."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        drain = self.scheduler.pop_ready(self.scheduler.max_queue)
        for qe in drain.admit + drain.expired + drain.cancelled:
            self._finish(qe.item, "cancelled")
        self._release_all("cancelled")

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- caller side

    def submit(self, request: Request) -> RequestHandle:
        """Validate and enqueue; raises :class:`QueueFullError`
        (backpressure) or ``ValueError`` (a prompt the context window cannot
        serve)."""
        if self._worker_error is not None:
            raise RuntimeError("serving engine worker died") from self._worker_error
        if not self._running:
            raise RuntimeError("serving engine is not running (use start())")
        plen = len(request.prompt_ids)
        ctx = self.engine.config.context_length
        if plen < 1:
            raise ValueError("prompt must contain at least one token")
        if plen > ctx - 1:
            raise ValueError(
                f"prompt of {plen} tokens leaves no room to generate in a context of {ctx}"
            )
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        if self.paged:
            # A request whose worst-case chain exceeds the whole pool could
            # never be admitted: fail now instead of blocking the backlog.
            need = self.engine.blocks_needed(plen, request.max_new_tokens)
            if need > self.engine.allocator.usable_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks; the pool holds "
                    f"{self.engine.allocator.usable_blocks}"
                )
        entry = _Entry(request, self._clock())
        with self._entries_lock:
            if request.request_id in self._entries:
                raise ValueError(f"request id {request.request_id!r} is already in flight")
            self._entries[request.request_id] = entry
        try:
            self.scheduler.submit(
                entry, request_id=request.request_id, deadline_s=request.deadline_s
            )
        except BaseException:
            with self._entries_lock:
                self._entries.pop(request.request_id, None)
            raise
        return RequestHandle(self, entry)

    def generate(
        self,
        prompt_ids,
        *,
        max_new_tokens: int | None = None,
        temperature: float = 1.0,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int = 0,
        stop_id: int | None = None,
        deadline_s: float | None = None,
        request_id: str | None = None,
        timeout: float | None = None,
    ) -> Result:
        """Blocking one-call generation."""
        kwargs = {} if request_id is None else {"request_id": request_id}
        handle = self.submit(
            Request(
                prompt_ids=tuple(int(t) for t in prompt_ids),
                max_new_tokens=(
                    self.default_max_new_tokens if max_new_tokens is None else max_new_tokens
                ),
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                seed=seed,
                stop_id=self.default_stop_id if stop_id is None else stop_id,
                deadline_s=deadline_s,
                **kwargs,
            )
        )
        return handle.result(timeout)

    def stream(self, request: Request) -> Iterator[int]:
        """Submit and yield token ids as they are generated."""
        return self.submit(request).tokens()

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or in-flight request."""
        if self.scheduler.cancel(request_id):
            return True
        with self._entries_lock:
            entry = self._entries.get(request_id)
        if entry is not None and not entry.done.is_set():
            entry.cancel_requested = True
            return True
        return False

    def run_batch(self, prompts: list, **knobs) -> list[Result]:
        """Offline batch: submit every prompt (waiting out backpressure
        instead of failing) and return results in input order."""
        handles: list[RequestHandle] = []
        for prompt in prompts:
            request = Request(
                prompt_ids=tuple(int(t) for t in prompt),
                **{
                    "max_new_tokens": self.default_max_new_tokens,
                    "stop_id": self.default_stop_id,
                    **knobs,
                },
            )
            while True:
                try:
                    handles.append(self.submit(request))
                    break
                except QueueFullError:
                    time.sleep(0.005)  # the worker is draining the queue
        return [h.result() for h in handles]

    # ---------------------------------------------------------- worker loop

    def _run(self) -> None:
        try:
            while self._running:
                if not self._step():
                    self.scheduler.wait_for_work(self._idle_poll_s)
        except BaseException as exc:  # noqa: BLE001 -- fail loudly, unblock callers
            self._worker_error = exc
            self._running = False
            self._release_all("error")
            drain = self.scheduler.pop_ready(self.scheduler.max_queue)
            for qe in drain.admit + drain.expired + drain.cancelled:
                self._finish(qe.item, "error")
            with self._entries_lock:
                leftover = list(self._entries.values())
            for entry in leftover:
                self._finish(entry, "error")

    def _release_all(self, reason: str) -> None:
        """Finish every admitted or parked request with ``reason``, freeing
        its slot (close, or a dead worker)."""
        for entries in (self._slot_entries, self._prefill_entries):
            for slot in list(entries):
                entry = entries.pop(slot)
                self.engine.release(slot)
                self._finish(entry, reason)
        for entry in self._admit_backlog:
            self._finish(entry, reason)
        self._admit_backlog = []

    def _step(self) -> bool:
        """One loop iteration: cancellations, admissions (parked ones
        first), prefill chunks under the per-tick budget (paged), then a
        decode tick.  Returns whether any work happened."""
        worked = False
        # In-flight cancellations retire their slots before the next tick:
        # decoding slots, slots mid-prefill and parked admissions alike.
        for entries in (self._slot_entries, self._prefill_entries):
            for slot, entry in list(entries.items()):
                if entry.cancel_requested:
                    del entries[slot]
                    self.engine.release(slot)
                    self._finish(entry, "cancelled")
                    worked = True
        if self._admit_backlog:
            now = self._clock()
            kept = []
            for entry in self._admit_backlog:
                deadline = entry.request.deadline_s
                if entry.cancel_requested:
                    self._finish(entry, "cancelled")
                    worked = True
                elif deadline is not None and now >= entry.t_submit + deadline:
                    # The deadline follows a parked request out of the queue.
                    self._finish(entry, "deadline")
                    worked = True
                else:
                    kept.append(entry)
            self._admit_backlog = kept

        # Parked admissions retry first, strictly FIFO: while one is parked,
        # newer submissions stay queued.
        while self._admit_backlog and self.engine.free_slots:
            if not self._try_admit(self._admit_backlog[0]):
                break
            self._admit_backlog.pop(0)
            worked = True
        n_free = 0 if self._admit_backlog else self.engine.free_slots
        engine_idle = self.engine.active_count == 0 and not self._prefill_entries
        pop = self.scheduler.pop_ready(n_free, engine_idle=engine_idle)
        for qe in pop.cancelled:
            self._finish(qe.item, "cancelled")
            worked = True
        for qe in pop.expired:
            self._finish(qe.item, "deadline")
            worked = True
        for qe in pop.admit:
            # Past a parked admission everything popped behind it parks too:
            # admitting it would take the blocks the parked one waits for.
            if self._admit_backlog or not self._try_admit(qe.item):
                self._admit_backlog.append(qe.item)
            worked = True

        worked |= self._advance_prefills()
        if self.engine.active_count:
            self._deliver(self.engine.tick())
            worked = True
        return worked

    def _try_admit(self, entry: _Entry) -> bool:
        """Admit one entry.  Dense engine: the whole bucketed prefill, which
        always succeeds (the scheduler never pops more than the free
        slots).  Paged engine: reserve the slot and its block chain and
        queue the prompt's chunks; False when the pool is short of blocks,
        so that the caller parks the entry."""
        request = entry.request
        t0 = self._clock()
        knobs = dict(
            max_new_tokens=request.max_new_tokens,
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            seed=request.seed,
            stop_id=request.stop_id,
            request_id=request.request_id,
        )
        if self.paged:
            try:
                slot = self.engine.begin(request.prompt_ids, **knobs)
            except NoFreeBlocksError:
                return False
            entry.queue_wait_s = t0 - entry.t_submit
            entry.slot = slot
            entry.prefill_s = 0.0
            self._prefill_entries[slot] = entry
            return True
        entry.queue_wait_s = t0 - entry.t_submit
        event = self.engine.admit(request.prompt_ids, **knobs)
        entry.prefill_s = self._clock() - t0
        self._start_decode(entry, event)
        return True

    def _advance_prefills(self) -> bool:
        """Run pending prefill chunks (paged engine) under the per-tick
        token budget, oldest admission first; a finished prefill delivers
        its first token and joins the decode set."""
        if not self._prefill_entries:
            return False
        worked = False
        budget = self._prefill_budget
        budget.start_tick()
        for slot in self.engine.pending_prefills():
            entry = self._prefill_entries.get(slot)
            if entry is None:
                continue
            while True:
                chunk_tokens = self.engine.next_chunk_tokens(slot)
                if not budget.admits(chunk_tokens):
                    return worked  # budget spent: the decode tick runs next
                t0 = self._clock()
                event = self.engine.prefill_step(slot)
                entry.prefill_s += self._clock() - t0
                budget.spend(chunk_tokens)
                worked = True
                if event is not None:
                    del self._prefill_entries[slot]
                    self._start_decode(entry, event)
                    break
        return worked

    def _start_decode(self, entry: _Entry, event: TickEvent) -> None:
        """Deliver an admission's first token; the slot then decodes."""
        entry.t_decode_start = self._clock()
        entry.slot = event.slot
        entry.tokens.append(event.token)
        entry.stream.put(event.token)
        if event.finished:
            self._finish(entry, event.finished)
        else:
            self._slot_entries[event.slot] = entry

    def _deliver(self, events: list[TickEvent]) -> None:
        """Hand each event's token to its request, in order: a speculative
        tick may carry several events of one slot, ``finished`` on its
        last."""
        for event in events:
            entry = self._slot_entries.get(event.slot)
            if entry is None:
                continue  # released between admit and tick (cancellation)
            entry.tokens.append(event.token)
            entry.stream.put(event.token)
            if event.finished:
                del self._slot_entries[event.slot]
                self._finish(entry, event.finished)

    def _finish(self, entry: _Entry, reason: str) -> None:
        if entry.done.is_set():
            return
        now = self._clock()
        if entry.slot is not None:
            decode_s = now - entry.t_decode_start
        else:
            decode_s = 0.0
            if reason in ("deadline", "cancelled"):
                entry.queue_wait_s = now - entry.t_submit  # never admitted
        entry.result = Result(
            request_id=entry.request.request_id,
            token_ids=tuple(entry.tokens),
            finish_reason=reason,
            queue_wait_s=entry.queue_wait_s,
            prefill_s=entry.prefill_s,
            decode_s=decode_s,
        )
        with self._entries_lock:
            self._entries.pop(entry.request.request_id, None)
        entry.stream.put(_STREAM_END)
        entry.done.set()
