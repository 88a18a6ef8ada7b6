"""In-process serving front end (port of the dense-engine subset of
``bpe_transformer_tpu/serving/server.py``): ``Request``/``Result`` types and
the blocking + streaming :class:`ServingEngine`.

Layering (one thread owns the card):

* callers (``generate``, ``stream``, ``run_batch``) only touch the
  :class:`FifoScheduler` and per-request completion events;
* ONE worker thread runs the engine loop: admit queued requests into free
  slots (prefill), run a decode tick across every occupied slot, deliver
  tokens to the per-request streams, retire finished slots;
* backpressure surfaces at submit time as :class:`QueueFullError`.

Paged KV, speculation, KV migration, telemetry, alerts, the flight recorder
and the HTTP transport are not ported yet.
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
from bpe_transformer_tpu_torch.serving.scheduler import FifoScheduler, QueueFullError

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
        device: str | torch.device = "cuda",
    ):
        self.engine = SlotPoolEngine(
            params, config, slots=slots, prefill_buckets=prefill_buckets,
            min_bucket=min_bucket, weight_dtype=weight_dtype, device=device,
        )
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
        for slot in list(self._slot_entries):
            entry = self._slot_entries.pop(slot)
            self.engine.release(slot)
            self._finish(entry, "cancelled")

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
            for slot in list(self._slot_entries):
                entry = self._slot_entries.pop(slot)
                self.engine.release(slot)
                self._finish(entry, "error")
            drain = self.scheduler.pop_ready(self.scheduler.max_queue)
            for qe in drain.admit + drain.expired + drain.cancelled:
                self._finish(qe.item, "error")
            with self._entries_lock:
                leftover = list(self._entries.values())
            for entry in leftover:
                self._finish(entry, "error")

    def _step(self) -> bool:
        """One loop iteration: cancellations, admissions, then a decode tick.
        Returns whether any work happened."""
        worked = False
        for slot, entry in list(self._slot_entries.items()):
            if entry.cancel_requested:
                del self._slot_entries[slot]
                self.engine.release(slot)
                self._finish(entry, "cancelled")
                worked = True
        engine_idle = self.engine.active_count == 0
        pop = self.scheduler.pop_ready(self.engine.free_slots, engine_idle=engine_idle)
        for qe in pop.cancelled:
            self._finish(qe.item, "cancelled")
            worked = True
        for qe in pop.expired:
            self._finish(qe.item, "deadline")
            worked = True
        for qe in pop.admit:
            self._admit(qe.item)
            worked = True
        if self.engine.active_count:
            self._deliver(self.engine.tick())
            worked = True
        return worked

    def _admit(self, entry: _Entry) -> None:
        request = entry.request
        t0 = self._clock()
        entry.queue_wait_s = t0 - entry.t_submit
        event = self.engine.admit(
            request.prompt_ids,
            max_new_tokens=request.max_new_tokens,
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            seed=request.seed,
            stop_id=request.stop_id,
            request_id=request.request_id,
        )
        now = self._clock()
        entry.prefill_s = now - t0
        entry.t_decode_start = now
        entry.slot = event.slot
        entry.tokens.append(event.token)
        entry.stream.put(event.token)
        if event.finished:
            self._finish(entry, event.finished)
        else:
            self._slot_entries[event.slot] = entry

    def _deliver(self, events: list[TickEvent]) -> None:
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
