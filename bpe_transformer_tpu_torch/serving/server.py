"""Serving front end (the port of ``bpe_transformer_tpu/serving/server.py``'s
single-replica surface): ``Request``/``Result`` types, the blocking +
streaming :class:`ServingEngine`, an offline batch mode, and the stdlib HTTP
JSON endpoint behind the ``serve`` command.

Layering (one thread owns the card):

* transports (HTTP handler threads, ``generate()`` callers, the batch
  runner) only touch the :class:`FifoScheduler` and per-request completion
  events;
* ONE worker thread runs the engine loop: admit queued requests into free
  slots, run prefill (the dense engine's whole prompt at admission, or the
  paged engine's chunks under a per-tick token budget), a decode tick
  across every occupied slot, deliver tokens to the per-request streams,
  retire finished slots;
* backpressure surfaces at submit time as :class:`QueueFullError` (HTTP
  503), never blocking a transport.

With ``paged=True`` the engine is the paged
:class:`~bpe_transformer_tpu_torch.serving.kvpool.PagedEngine`: an
admission the block pool cannot cover yet is PARKED and retried first,
strictly in FIFO order, as retirements free blocks, and parked requests
still expire at their deadline and can be cancelled.  ``speculate_k`` with a
``draft_spec`` (and ``paged=True``) serves through the speculative
:class:`~bpe_transformer_tpu_torch.serving.spec.SpecEngine`;
``fused_sampling=True`` ends every tick with the fused head + sample kernel.

Telemetry is the JAX package's: per-request ``serve/queue_wait``,
``serve/prefill`` and ``serve/decode`` spans, periodic ``kind="engine"``,
``resources`` and ``roofline`` records (plus ``kvpool`` and ``spec`` on the
paged engines), alert transitions, black-box dumps and the footer, through
one ``telemetry.Telemetry``, so the JAX package's ``report`` and
``monitor`` read a port server's stream.  Every gauge a handler thread reads
is host-side (the engines keep numpy mirrors of their slot state), so
``stats()``/``statusz()``/``/metrics`` never synchronise the card.

The serving fleet: a paged replica has a ``role`` (``prefill`` replicas
run the chunk machine and hand each finished prefix out as a KV payload over
``POST /kv/export``; ``decode`` replicas graft payloads from
``POST /kv/import``; ``both`` serves everything).  ``drain(evacuate_to=...)``
moves every queued and in-flight session to in-process peers, and
``drain(evacuate_urls=...)`` (``serve --evacuate-to``) relays them to peer
replicas over HTTP under one ``X-Idempotency-Key`` per payload, so a retried
graft lands once.  ``POST /admin/evacuate`` moves sessions to a named peer
without draining (the controller's hot rebalancing), and ``BT_FAULTS``
(``resilience/faults.py``) injects the fleet's faults: a kill at decode tick
K, HTTP delays and blackholes by path, and a corrupted payload.  The payload
format is ``serving/kvpool/migrate.py``'s, the JAX package's byte for byte,
so port and JAX replicas serve in one fleet.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import queue
import threading
import time
import uuid
from pathlib import Path
from typing import Iterator

import torch

from bpe_transformer_tpu_torch.resilience.faults import FaultInjector
from bpe_transformer_tpu_torch.serving.engine import SlotPoolEngine, TickEvent, activation_dtype
from bpe_transformer_tpu_torch.serving.kvpool import NoFreeBlocksError, PagedEngine
from bpe_transformer_tpu_torch.serving.kvpool.migrate import (
    negotiate_codec,
    payload_from_bytes,
    payload_nbytes,
    payload_to_bytes,
    supported_codecs,
)
from bpe_transformer_tpu_torch.serving.metrics import ServingMetrics, render_prometheus
from bpe_transformer_tpu_torch.serving.scheduler import (
    FifoScheduler,
    PrefillBudget,
    QueueFullError,
)
from bpe_transformer_tpu_torch.serving.spec import SpecEngine
from bpe_transformer_tpu_torch.telemetry.alerts import AlertEngine, default_serving_rules
from bpe_transformer_tpu_torch.telemetry.attribution import decode_tick_roofline
from bpe_transformer_tpu_torch.telemetry.flightrecorder import FlightRecorder
from bpe_transformer_tpu_torch.telemetry.resources import (
    compile_events,
    kernel_launches,
    kernel_libraries_loaded,
    sample_resources,
)
from bpe_transformer_tpu_torch.utils.flops import decode_tick_flops

__all__ = [
    "Request",
    "Result",
    "RequestHandle",
    "ServingEngine",
    "QueueFullError",
    "DuplicateRequestError",
    "make_http_server",
]

_STREAM_END = object()


def _base_url(url: str) -> str:
    """A peer's base URL; a bare ``host:port`` (as ``serve --evacuate-to``
    and the router take it) gets ``http://``."""
    url = url.rstrip("/")
    return url if "://" in url else f"http://{url}"


class DuplicateRequestError(ValueError):
    """A request id already in flight on this replica.  Subclasses
    ValueError for direct ``submit()`` callers, but the HTTP layer maps it
    to a retryable 503, not a 400: the canonical producer is a client
    retrying with the same ``X-Request-Id`` while the original still runs,
    and a peer replica can serve that retry."""


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
    #: Optional session key (multi-turn conversations): request metadata a
    #: fleet router hashes to a sticky replica; the replica only carries it.
    session: str | None = None
    #: Disaggregated prefill: run the chunk machine, then export the
    #: finished prefix (first token sampled) as a KV payload
    #: (``Result.kv_payload``, finish_reason ``"migrated"``) instead of
    #: decoding here.  ``/kv/export`` sets it; needs a paged engine.
    migrate: bool = False
    #: ``migrate`` only: the importer's accepted wire codecs (the
    #: ``X-KV-Accept`` header); None means raw, for a peer that predates
    #: negotiation.
    kv_accept: str | None = None
    request_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)


@dataclasses.dataclass(frozen=True)
class Result:
    """A finished request: generated ids, why it stopped, phase timings."""

    request_id: str
    token_ids: tuple[int, ...]
    finish_reason: str  # stop | length | deadline | cancelled | error | migrated
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    #: ``finish_reason == "migrated"`` only: the serialized KV payload
    #: another replica's ``/kv/import`` (or ``submit_import``) continues
    #: the generation from.
    kv_payload: bytes | None = None

    def timings(self) -> dict:
        return {
            "queue_wait_s": round(self.queue_wait_s, 6),
            "prefill_s": round(self.prefill_s, 6),
            "decode_s": round(self.decode_s, 6),
        }


class _Entry:
    """Worker-side state for one submitted request."""

    __slots__ = (
        "request", "tokens", "stream", "done", "result", "slot", "t_submit",
        "t_decode_start", "queue_wait_s", "prefill_s", "cancel_requested", "bucket",
        "t_prefill_start", "compiles_before", "shared_tokens", "migrated_in",
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
        self.bucket: int | None = None  # prefill bucket, set at admission
        self.t_prefill_start = t_submit  # first chunk start (paged engine)
        self.compiles_before = 0  # kernel-library events at admission (paged)
        self.shared_tokens = 0  # prefix-cache-reused prompt tokens (paged)
        self.migrated_in = False  # arrived as a KV graft


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
        tokenizer=None,
        slots: int = 8,
        max_queue: int = 64,
        max_wait_s: float = 0.0,
        prefill_buckets: tuple[int, ...] | None = None,
        min_bucket: int = 16,
        default_stop_id: int | None = None,
        default_max_new_tokens: int = 128,
        telemetry=None,
        engine_record_every_s: float = 1.0,
        idle_poll_s: float = 0.02,
        clock=time.monotonic,
        manifest: dict | None = None,
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
        alert_rules=None,
        role: str = "both",
        flightrecorder_capacity: int = 256,
        device: str | torch.device = "cuda",
    ):
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f'role={role!r} must be "prefill", "decode", or "both"')
        if role != "both" and not paged:
            raise ValueError(
                f"role={role!r} needs paged=True (KV migration lives in the block pool)"
            )
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
        #: Fleet role: ``"prefill"`` replicas run the chunk machine and hand
        #: finished prefixes out over ``/kv/export`` (plain /generate
        #: refused); ``"decode"`` replicas also take grafts on
        #: ``/kv/import``; ``"both"`` serves everything.
        self.role = role
        #: Speculative decoding is on (the engine is a SpecEngine): the
        #: stats/statusz/metrics surfaces grow the acceptance gauges and the
        #: engine-record cadence emits kind="spec" records.
        self.spec = bool(speculate_k)
        dev = self.engine.device
        #: The card's name for the decode roofline's peak lookup ("cpu" on
        #: the CPU, which has no peak row).
        self.device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        #: Always-on decision ring: every admit/park/reject/deadline/finish,
        #: rewind, drain and worker-error decision lands here as host-side
        #: bookkeeping, flushed as a kind="blackbox" dump on alert, manual
        #: and worker-error triggers.
        self.flightrecorder = FlightRecorder("serve", capacity=flightrecorder_capacity,
                                             clock=clock)
        if paged:
            self.engine.recorder = self.flightrecorder
        #: Prefill tokens allowed between consecutive decode ticks (paged
        #: only; None runs each prefill to completion, the dense schedule).
        self._prefill_budget = PrefillBudget(
            prefill_token_budget if paged else None, recorder=self.flightrecorder
        )
        #: Admissions parked on KV-block exhaustion (paged), retried in FIFO
        #: order before any newer queue pop.
        self._admit_backlog: list[_Entry] = []
        #: Slots mid-chunked-prefill -> their entries (paged).
        self._prefill_entries: dict[int, _Entry] = {}
        #: Inbound KV grafts awaiting a slot or blocks, FIFO:
        #: ``(entry, payload, payload_nbytes, recv_unix)``; fed by
        #: submit_import / adopt_migration (transport threads), drained by
        #: the worker ahead of fresh admissions.
        self._import_queue: collections.deque = collections.deque()
        self._import_lock = threading.Lock()
        #: In-process drain-evacuation peers (round-robin).
        self._evacuate_peers: list = []
        self._evacuate_rr = 0
        #: Over-the-wire drain-evacuation peers (base URLs): queued requests
        #: replay as seeded ``/generate`` calls, in-flight sessions relay to
        #: a peer's ``/kv/import``.
        self._evacuate_urls: list[str] = []
        #: ``POST /admin/evacuate`` requests for the worker:
        #: ``(target_url, max_sessions, done_event, out_dict)``.
        self._rebalance_queue: collections.deque = collections.deque()
        self._relays_ok = 0
        self._relays_failed = 0
        self._rebalanced_out = 0
        #: One payload relay's retry policy: attempts, per-attempt HTTP
        #: timeout, exponential backoff between attempts.
        self.relay_attempts = 4
        self.relay_timeout_s = 600.0
        self.relay_backoff_s = 0.2
        #: The codecs migration exports offer (``negotiate_codec``); zlib is
        #: standard library, so every peer decodes it.
        self.export_codec = "zstd,zlib"
        #: This replica's ``BT_FAULTS`` plan (a no-op without the variable).
        self.faults = FaultInjector.from_env()
        self._decode_ticks = 0
        #: Idempotency keys of imports -> their entries (bounded LRU), so a
        #: retried ``/kv/import`` attaches to the original graft.
        self._idem_keys: collections.OrderedDict = collections.OrderedDict()
        self._idem_lock = threading.Lock()
        self.scheduler = FifoScheduler(max_queue=max_queue, max_wait_s=max_wait_s, clock=clock)
        self.tokenizer = tokenizer
        self.default_stop_id = default_stop_id
        self.default_max_new_tokens = default_max_new_tokens
        self.manifest = manifest
        #: Live counter/histogram aggregate behind /metrics and stats(), fed
        #: from the same measurements the serve/* spans carry.
        self.metrics = ServingMetrics(clock=clock)
        self._telemetry = telemetry
        self._record_every_s = engine_record_every_s
        self._idle_poll_s = idle_poll_s
        self._clock = clock
        self._t0 = clock()
        self._last_record_t = self._t0
        self._last_record_tokens = 0
        self._entries: dict[str, _Entry] = {}
        self._entries_lock = threading.Lock()
        self._slot_entries: dict[int, _Entry] = {}
        #: Finished requests' phase timelines (newest last) behind /statusz
        #: "recent_requests".
        self._recent: collections.deque = collections.deque(maxlen=32)
        #: Serving anomaly watchdog, fed on the engine-record cadence whether
        #: or not a telemetry sink exists (/statusz shows active alerts).
        self._alerts = AlertEngine(
            alert_rules if alert_rules is not None else default_serving_rules()
        )
        self._requests_finished = 0
        self._thread: threading.Thread | None = None
        self._running = False
        self._draining = False
        self._worker_error: BaseException | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._running = True
        self._t0 = self._clock()
        self._last_record_t = self._t0
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0, evacuate_to=None, evacuate_urls=None) -> bool:
        """Graceful shutdown, phase 1: stop ADMITTING (new submits raise
        ``RuntimeError``, HTTP 503) but keep the worker running until every
        queued and in-flight request finishes (the SIGTERM path of
        ``serve``).  Returns True when fully drained, False on timeout (the
        caller's ``close()`` then cancels the stragglers).

        ``evacuate_to`` (in-process peer ``ServingEngine``s) turns drain
        into evacuation: every queued and in-flight session moves to a
        peer (in-flight slots as KV payloads the peer grafts), which
        completes the original caller's handle with the same tokens.
        ``evacuate_urls`` is the cross-process form (peer base URLs):
        queued requests replay as seeded ``/generate`` calls and in-flight
        sessions relay to a peer's ``/kv/import`` under one idempotency key
        with bounded retries; the relay completes the caller's handle with
        the peer's tokens."""
        if evacuate_to:
            self._evacuate_peers = [p for p in evacuate_to if p.accepting_imports()]
        if evacuate_urls:
            self._evacuate_urls = [_base_url(u) for u in evacuate_urls]
        evacuating = bool(self._evacuate_peers or self._evacuate_urls)
        self._draining = True
        self.flightrecorder.record(
            "drain", queue_depth=self.scheduler.depth, active_slots=self.engine.active_count,
            evacuating=evacuating,
        )
        if self._telemetry is not None:
            self._telemetry.event(
                "serve_drain", queue_depth=self.scheduler.depth,
                active_slots=self.engine.active_count, evacuating=evacuating,
            )
        deadline = self._clock() + timeout_s
        while True:
            # The entries registry is the superset of unfinished work: a
            # request the worker has popped but not yet slotted is in
            # neither the queue depth nor the active count.
            with self._entries_lock:
                pending = len(self._entries)
            if not pending and not self.engine.active_count and not self.scheduler.depth:
                return True
            if self._worker_error is not None or not self._running or self._clock() >= deadline:
                return False
            time.sleep(min(self._idle_poll_s, 0.05))

    def close(self) -> None:
        """Stop the worker; in-flight and queued requests finish as
        ``cancelled``, and the telemetry stream gets its footer."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        drain = self.scheduler.pop_ready(self.scheduler.max_queue)
        for qe in drain.admit + drain.expired + drain.cancelled:
            self._finish(qe.item, "cancelled")
        self._release_all("cancelled")
        if self._telemetry is not None:
            self._telemetry.footer(
                clean=self._worker_error is None,
                requests=self._requests_finished,
                ticks=self.engine.ticks,
                tokens=self.engine.tokens_emitted,
            )

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- transport side

    def submit(self, request: Request) -> RequestHandle:
        """Validate and enqueue; raises :class:`QueueFullError`
        (backpressure), :class:`DuplicateRequestError` (its id is in
        flight), ``ValueError`` (a prompt the context window cannot serve)
        or ``RuntimeError`` (not running, draining, or the worker died)."""
        if self._worker_error is not None:
            raise RuntimeError("serving engine worker died") from self._worker_error
        if not self._running:
            raise RuntimeError("serving engine is not running (use start())")
        if self._draining:
            raise RuntimeError(
                "serving engine is draining (shutting down); not accepting new requests"
            )
        if request.migrate and not self.paged:
            raise ValueError(
                "migrate-at-prefill needs a paged engine (the KV payload is a block chain)"
            )
        if self.role == "prefill" and not request.migrate:
            # A prefill-role replica never ticks: 503 (RuntimeError), so a
            # misdirected client fails over.
            raise RuntimeError(
                "prefill-role replica serves /kv/export only (finished prefixes stream out "
                "as KV payloads; decode lives on decode-role replicas)"
            )
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
        self._register(entry)
        try:
            self.scheduler.submit(
                entry, request_id=request.request_id, deadline_s=request.deadline_s
            )
        except BaseException as exc:
            # Any enqueue failure must unregister the entry.
            with self._entries_lock:
                self._entries.pop(request.request_id, None)
            if isinstance(exc, QueueFullError):
                self.metrics.on_reject()
                self.flightrecorder.record(
                    "reject", request_id=request.request_id, queue_depth=self.scheduler.depth
                )
            raise
        self.metrics.on_submit()
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
        session: str | None = None,
        request_id: str | None = None,
        migrate: bool = False,
        kv_accept: str | None = None,
        timeout: float | None = None,
    ) -> Result:
        """Blocking one-call generation.  ``request_id`` adopts a
        caller-supplied trace id (``X-Request-Id``).  ``migrate=True`` is
        the ``/kv/export`` path: the result carries the finished prefix as
        a KV payload instead of a whole generation."""
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
                session=session,
                migrate=migrate,
                kv_accept=kv_accept,
                **kwargs,
            )
        )
        return handle.result(timeout)

    # ------------------------------------------------------- KV migration

    def accepting_imports(self) -> bool:
        """Whether this replica can graft KV payloads now (paged, not
        prefill-role, worker alive, not draining)."""
        return (
            self.paged and self.role != "prefill" and self._running and not self._draining
            and self._worker_error is None
        )

    def submit_import(self, payload_bytes: bytes, *, idempotency_key: str | None = None
                      ) -> RequestHandle:
        """Accept a serialized KV payload (the ``/kv/import`` body):
        validate it against this engine, register the request and queue the
        graft for the worker.  The handle resolves with the whole
        generation: the tokens emitted before the migration (carried in the
        payload) and everything decoded here.

        ``idempotency_key`` (``X-Idempotency-Key``) makes the graft
        exactly-once under retries: a repeated key, whether its graft is
        queued, decoding or finished, attaches to the original entry.

        Raises ``ValueError`` (bad payload or geometry: 400),
        :class:`QueueFullError` (503), :class:`DuplicateRequestError` or
        ``RuntimeError`` (not accepting: 503)."""
        if self._worker_error is not None:
            raise RuntimeError("serving engine worker died") from self._worker_error
        if not self._running:
            raise RuntimeError("serving engine is not running (use start())")
        if self._draining:
            raise RuntimeError("serving engine is draining; not accepting")
        if not self.paged:
            raise RuntimeError("KV import needs a paged engine")
        if self.role == "prefill":
            raise RuntimeError("prefill-role replica does not accept KV imports")
        if idempotency_key:
            with self._idem_lock:
                known = self._idem_keys.get(idempotency_key)
            if known is not None:
                return RequestHandle(self, known)
        payload = payload_from_bytes(payload_bytes)
        meta = payload["meta"]
        # Whole structural validation at the transport: a corrupt payload
        # answers 400 here and never reaches the worker.
        self.engine.validate_import_payload(payload)
        request = Request(
            prompt_ids=tuple(int(t) for t in meta["prompt"]),
            max_new_tokens=max(int(meta["max_new_tokens"]), 1),
            temperature=float(meta["temperature"]),
            seed=int(meta["seed"]),
            stop_id=meta["stop_id"],
            deadline_s=meta.get("deadline_s"),
            session=meta.get("session"),
            request_id=meta.get("request_id") or uuid.uuid4().hex,
        )
        entry = _Entry(request, self._clock())
        self._entry_from_meta(entry, meta)
        if idempotency_key:
            # Claim or attach under one lock: a concurrent duplicate attaches
            # to whichever entry claimed first.  The claim outlives the
            # entry (bounded LRU), so a retry after completion gets the
            # cached result.
            with self._idem_lock:
                known = self._idem_keys.get(idempotency_key)
                if known is not None:
                    return RequestHandle(self, known)
                self._idem_keys[idempotency_key] = entry
                while len(self._idem_keys) > 4096:
                    self._idem_keys.popitem(last=False)
        try:
            self._register(entry)
            try:
                # Check and append under one lock: each queued item holds a
                # whole decoded payload.
                with self._import_lock:
                    if len(self._import_queue) >= self.scheduler.max_queue:
                        raise QueueFullError(f"import queue full ({self.scheduler.max_queue})")
                    self._import_queue.append((entry, payload, len(payload_bytes), time.time()))
            except BaseException:
                with self._entries_lock:
                    self._entries.pop(request.request_id, None)
                raise
        except BaseException:
            if idempotency_key:
                # A failed graft must not poison the key: the sender's retry
                # deserves a fresh attempt.
                with self._idem_lock:
                    if self._idem_keys.get(idempotency_key) is entry:
                        del self._idem_keys[idempotency_key]
            raise
        self.metrics.on_submit()
        self.scheduler.notify()
        return RequestHandle(self, entry)

    def adopt_migration(self, entry: _Entry, payload) -> None:
        """In-process drain evacuation, receiving side: adopt a peer's live
        ``_Entry`` (its stream and done handles stay with the original
        caller) and queue its KV payload (bytes, or the parsed dict) for
        grafting.  Called from the evacuating replica's worker thread."""
        if not self.accepting_imports():
            raise RuntimeError("replica is not accepting imports")
        if isinstance(payload, (bytes, bytearray)):
            nbytes = len(payload)
            payload = payload_from_bytes(payload)
        else:
            nbytes = payload_nbytes(payload)
        self.engine.validate_import_payload(payload)
        self._register(entry)
        with self._import_lock:
            self._import_queue.append((entry, payload, nbytes, time.time()))
        self.scheduler.notify()

    def adopt_entry(self, entry: _Entry) -> None:
        """In-process drain evacuation of a NOT-YET-ADMITTED request: the
        peer's queued entry enters this replica's scheduler whole."""
        if not self.accepting_imports():
            raise RuntimeError("replica is not accepting new requests")
        self._register(entry)
        try:
            self.scheduler.submit(entry, request_id=entry.request.request_id,
                                  deadline_s=entry.request.deadline_s)
        except BaseException:
            with self._entries_lock:
                self._entries.pop(entry.request.request_id, None)
            raise
        self.metrics.on_submit()

    def _register(self, entry: _Entry) -> None:
        """Enter ``entry`` in the registry of unfinished requests.  Request
        ids (``X-Request-Id``) key the registry and the trace streams, so an
        id already in flight here raises :class:`DuplicateRequestError`
        rather than orphan the first caller."""
        rid = entry.request.request_id
        with self._entries_lock:
            if rid in self._entries:
                raise DuplicateRequestError(
                    f"request id {rid!r} is already in flight on this replica")
            self._entries[rid] = entry

    @staticmethod
    def _entry_from_meta(entry: _Entry, meta: dict) -> None:
        """Restore the serving-layer state a payload carries: the tokens
        already emitted and the phase timings accrued before the migration
        (so the Result's timings stay end to end)."""
        entry.tokens = [int(t) for t in meta.get("emitted") or []]
        entry.queue_wait_s = float(meta.get("queue_wait_s") or 0.0)
        entry.prefill_s = float(meta.get("prefill_s") or 0.0)
        entry.bucket = meta.get("bucket")
        entry.shared_tokens = int(meta.get("shared_tokens") or 0)
        entry.migrated_in = True

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

    # ------------------------------------------------------------ gauges

    def _engine_kind(self) -> str:
        return "spec" if self.spec else "paged" if self.paged else "dense"

    def decode_roofline(self) -> dict:
        """The decode tick's analytic roofline at CURRENT occupancy
        (``telemetry.attribution.decode_tick_roofline``): per tick, the
        weight sweep is the engine's streamed matmul-weight bytes, the KV
        stream is the live positions times the per-position footprint, and
        activations are an estimate (about 12 ``d_model``-sized transients
        per token per block, plus the vocab-sized tail: about three float32
        round trips unfused, one, the noise the kernel reads, fused).  Read
        from the engine's host-side mirrors only."""
        engine = self.engine
        config = engine.config
        active = engine.active_count
        live = int(((engine._positions + 1) * engine._active).sum())
        act_bytes = active * config.num_layers * 12 * config.d_model * (
            activation_dtype(config).itemsize
        )
        vocab_trip = 2 * active * config.vocab_size * 4
        act_bytes += vocab_trip if engine.fused_sampling else 3 * vocab_trip
        row = decode_tick_roofline(
            flops=decode_tick_flops(config, active, live),
            weight_bytes=engine.tick_weight_bytes,
            kv_bytes=engine.kv_bytes_per_token * (live + active),
            act_bytes=act_bytes,
            device_kind=self.device_kind,
        )
        row.update(
            {
                "active_slots": active,
                "live_positions": live,
                "weight_dtype": engine.weight_dtype,
                "fused_sampling": engine.fused_sampling,
            }
        )
        return row

    def stats(self) -> dict:
        """Engine/queue gauges + the live request counters: the aggregate
        ``GET /healthz`` and ``/metrics`` render.  A paged engine adds the
        kvpool gauges.  ``compiled_programs`` counts the kernel libraries
        loaded in this process (the port compiles no XLA programs)."""
        with self._import_lock:
            import_backlog = len(self._import_queue)
        stats = {
            "engine_kind": self._engine_kind(),
            "role": self.role,
            "import_backlog": import_backlog,
            "slots": self.engine.n_slots,
            "active_slots": self.engine.active_count,
            "queue_depth": self.scheduler.depth,
            "ticks": self.engine.ticks,
            "tokens_emitted": self.engine.tokens_emitted,
            "requests_finished": self._requests_finished,
            "compiled_programs": kernel_libraries_loaded(),
            "prefill_buckets": list(self.engine.buckets),
            "weight_dtype": self.engine.weight_dtype,
            "params_bytes": self.engine.params_bytes,
            "tick_weight_bytes": self.engine.tick_weight_bytes,
            "fused_sampling": self.engine.fused_sampling,
            "decode_roofline": self.decode_roofline(),
            "alerts_firing": len(self._alerts.active()),
            **self.metrics.snapshot(),
        }
        if self.paged:
            stats.update(self.engine.gauges())
            stats["block_size"] = self.engine.block_size
            stats["kv_dtype"] = self.engine.kv_dtype
            stats["admit_backlog"] = len(self._admit_backlog)
        return stats

    def statusz(self) -> dict:
        """The ``GET /statusz`` payload: run manifest, uptime, kernel-library
        accounting, per-slot state, queue depth, the recent-request ring,
        alerts, the flight recorder's counters, resources (with the kernel
        launches per kernel) and the last-error ring."""
        resources = sample_resources()
        with self._import_lock:
            import_backlog = len(self._import_queue)
        page = {
            "manifest": self.manifest,
            "uptime_s": round(self.metrics.uptime_s(), 3),
            "engine_kind": self._engine_kind(),
            # The router partitions the fleet off the role: prefill-role
            # replicas take /kv/export only, decode-role replicas imports.
            "role": self.role,
            "migrations_out": self.metrics.migrations_out,
            "migrations_in": self.metrics.migrations_in,
            "import_backlog": import_backlog,
            # Wire codecs this replica decodes, best first: what a
            # migration sender negotiates against.
            "kv_accept": ",".join(supported_codecs()),
            # Sessions relayed out over HTTP (ok / failed after retries) and
            # moved by controller rebalancing.
            "relays_ok": self._relays_ok,
            "relays_failed": self._relays_failed,
            "rebalanced_out": self._rebalanced_out,
            # A fleet router routes around a draining replica and weights by
            # OCCUPANCY: a slot mid-chunked-prefill is busy, a parked
            # admission is queued work.
            "draining": self._draining,
            "speculate_k": self.engine.k if self.spec else None,
            "weight_dtype": self.engine.weight_dtype,
            "params_bytes": self.engine.params_bytes,
            "fused_sampling": self.engine.fused_sampling,
            "decode_roofline": self.decode_roofline(),
            "compiled_programs": kernel_libraries_loaded(),
            "compile_events": resources["compile_events"],
            "prefill_buckets": list(self.engine.buckets),
            "queue_depth": self.scheduler.depth + len(self._admit_backlog) + import_backlog,
            "slots": self.engine.n_slots,
            "active_slots": self.engine.n_slots - self.engine.free_slots,
            "requests_finished": self._requests_finished,
            "worker_alive": self._thread is not None and self._worker_error is None,
            "slot_states": self.engine.slot_states(),
            "recent_requests": list(self._recent),
            "alerts": self._alerts.active(),
            "alert_history": self._alerts.history(16),
            "flightrecorder": self.flightrecorder.stats(),
            # The port's own addition: kernel launches per kernel in this
            # process, so a fleet's replicas show which kernels served them.
            "resources": {**resources, "kernel_launches": kernel_launches()},
            "last_errors": self.metrics.last_errors(),
        }
        if self.paged:
            page["kvpool"] = {
                **self.engine.gauges(),
                "block_size": self.engine.block_size,
                "kv_dtype": self.engine.kv_dtype,
                "admit_backlog": len(self._admit_backlog),
            }
        return page

    def prometheus_metrics(self) -> str:
        """The ``GET /metrics`` body (Prometheus text exposition)."""
        return render_prometheus(self.metrics, self.stats(), sample_resources())

    # ------------------------------------------------------------ batch mode

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

    def serve_batch_file(self, prompts_path, output_path, **knobs) -> list[Result]:
        """Offline file mode: one prompt per input line -> one JSONL result
        line per prompt (input order), tokenizing/detokenizing with the
        attached tokenizer."""
        if self.tokenizer is None:
            raise ValueError("batch file mode needs a tokenizer")
        lines = [
            ln for ln in Path(prompts_path).read_text(encoding="utf-8").splitlines()
            if ln.strip()
        ]
        prompts = [self.tokenizer.encode(ln) for ln in lines]
        results = self.run_batch(prompts, **knobs)
        with open(output_path, "w", encoding="utf-8") as f:
            for text, result in zip(lines, results):
                f.write(json.dumps({
                    "prompt": text,
                    "completion": self._completion(result),
                    "finish_reason": result.finish_reason,
                    "n_tokens": len(result.token_ids),
                    **result.timings(),
                }) + "\n")
        return results

    def _completion(self, result: Result) -> str:
        """The result's text; a stop token is not rendered."""
        ids = list(result.token_ids)
        if result.finish_reason == "stop":
            ids = ids[:-1]
        return self.tokenizer.decode(ids)

    # ---------------------------------------------------------- worker loop

    def _run(self) -> None:
        try:
            while self._running:
                if not self._step():
                    self.scheduler.wait_for_work(self._idle_poll_s)
        except BaseException as exc:  # noqa: BLE001 -- fail loudly, unblock callers
            self._worker_error = exc
            self._running = False
            self.metrics.record_error(repr(exc), source="worker")
            self.flightrecorder.record("worker_error", error=repr(exc))
            if self._telemetry is not None:
                self._telemetry.event("serve_worker_error", error=repr(exc))
            # A dead worker is a terminal incident: flush the decision ring
            # while the evidence is warm (past the cooldown).
            self.blackbox_dump("worker_error", force=True)
            self._release_all("error")
            drain = self.scheduler.pop_ready(self.scheduler.max_queue)
            for qe in drain.admit + drain.expired + drain.cancelled:
                self._finish(qe.item, "error")
            with self._entries_lock:
                leftover = list(self._entries.values())
            for entry in leftover:
                self._finish(entry, "error")

    def _release_all(self, reason: str) -> None:
        """Finish every admitted, parked or queued-graft request with
        ``reason``, freeing its slot (close, or a dead worker)."""
        for entries in (self._slot_entries, self._prefill_entries):
            for slot in list(entries):
                entry = entries.pop(slot)
                self.engine.release(slot)
                self._finish(entry, reason)
        for entry in self._admit_backlog:
            self._finish(entry, reason)
        self._admit_backlog = []
        with self._import_lock:
            imports = [item[0] for item in self._import_queue]
            self._import_queue.clear()
        for entry in imports:
            self._finish(entry, reason)

    def _step(self) -> bool:
        """One loop iteration: cancellations, admissions (parked ones
        first), prefill chunks under the per-tick budget (paged), then a
        decode tick.  Returns whether any work happened."""
        worked = False
        # Drain evacuation: once draining with peers attached, every queued
        # and in-flight session leaves before anything else runs.
        if self._draining and (self._evacuate_peers or self._evacuate_urls):
            worked |= self._evacuate_step()
        # Controller-initiated rebalancing: export the requested sessions to
        # the named peer without draining.
        if self._rebalance_queue:
            worked |= self._rebalance_step()
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

        # Inbound grafts land before fresh admissions: migrated work already
        # paid queue wait and prefill on its source replica.
        worked |= self._advance_imports()

        # Parked admissions retry first, strictly FIFO: while one is parked,
        # newer submissions stay queued.
        while self._admit_backlog and self.engine.free_slots:
            if not self._try_admit(self._admit_backlog[0]):
                break
            self._admit_backlog.pop(0)
            worked = True
        # Pending grafts gate fresh admissions as a parked backlog does.
        with self._import_lock:
            imports_pending = bool(self._import_queue)
        n_free = 0 if (self._admit_backlog or imports_pending) else self.engine.free_slots
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
            # Fault hook: a kill at decode tick K lands between slots
            # holding live KV and the tick that would advance them.
            self._decode_ticks += 1
            self.faults.at_decode_tick(self._decode_ticks)
            t0 = self._clock()
            events = self.engine.tick()
            tick_s = self._clock() - t0
            self._deliver(events, tick_s)
            # Consecutive ticks merge into one ring entry, so decode chatter
            # cannot evict the rarer decisions around it.
            self.flightrecorder.record(
                "tick", coalesce=True, n_events=len(events), tick_s=round(tick_s, 6),
                active_slots=self.engine.active_count, queue_depth=self.scheduler.depth,
            )
            worked = True
        self._maybe_emit_engine_record()
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
            entry.compiles_before = compile_events()
            try:
                slot = self.engine.begin(request.prompt_ids, **knobs)
            except NoFreeBlocksError:
                # Coalesced: the backlog head retries every step while the
                # pool stays dry.
                self.flightrecorder.record(
                    "park", coalesce=True, request_id=request.request_id,
                    prompt_len=len(request.prompt_ids), backlog=len(self._admit_backlog),
                )
                return False
            entry.queue_wait_s = t0 - entry.t_submit
            self._span("queue_wait", entry.t_submit, entry.queue_wait_s, request)
            entry.slot = slot
            entry.bucket = self.engine.slot_bucket(slot)
            entry.shared_tokens = self.engine.slot_shared_len(slot)
            entry.t_prefill_start = t0
            entry.prefill_s = 0.0
            self._prefill_entries[slot] = entry
            self.flightrecorder.record(
                "admit", request_id=request.request_id, slot=slot,
                prompt_len=len(request.prompt_ids), queue_wait_s=round(entry.queue_wait_s, 6),
                shared_tokens=entry.shared_tokens or None,
            )
            return True

        entry.queue_wait_s = t0 - entry.t_submit
        entry.bucket = self.engine.bucket_for(len(request.prompt_ids))
        compiles_before = compile_events()
        event = self.engine.admit(request.prompt_ids, **knobs)
        now = self._clock()
        entry.prefill_s = now - t0
        self.metrics.on_prefill(
            entry.bucket, len(request.prompt_ids), entry.prefill_s,
            # An admission that built or loaded a kernel library pays that
            # wall: keep it out of the bucket's steady-state throughput.
            compiled=compile_events() > compiles_before,
        )
        self._span("queue_wait", entry.t_submit, entry.queue_wait_s, request)
        self._span("prefill", t0, entry.prefill_s, request)
        # Time to first token, observed request-level for the ttfb SLO
        # histogram (never as a span).
        self.metrics.observe_phase("ttfb", entry.queue_wait_s + entry.prefill_s)
        self.flightrecorder.record(
            "admit", request_id=request.request_id, slot=event.slot,
            prompt_len=len(request.prompt_ids), bucket=entry.bucket,
            queue_wait_s=round(entry.queue_wait_s, 6),
        )
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
                    self._complete_prefill(entry, event)
                    break
        return worked

    def _complete_prefill(self, entry: _Entry, event: TickEvent) -> None:
        request = entry.request
        self.metrics.on_prefill(
            entry.bucket,
            # COMPUTED prompt tokens: the prefix-cache-shared prefix paid
            # no compute.
            len(request.prompt_ids) - entry.shared_tokens,
            entry.prefill_s,
            compiled=compile_events() > entry.compiles_before,
        )
        self._span("prefill", entry.t_prefill_start, entry.prefill_s, request)
        self.metrics.observe_phase("ttfb", entry.queue_wait_s + entry.prefill_s)
        self._start_decode(entry, event)

    # -------------------------------------------------- migration (worker)

    def _advance_imports(self) -> bool:
        """Graft queued KV payloads into the engine, FIFO.  A graft that
        cannot land yet (no free slot, a dry pool) stays queued and retries
        as retirements free capacity."""
        worked = False
        while True:
            with self._import_lock:
                if not self._import_queue:
                    return worked
                entry, payload, nbytes, recv_unix = self._import_queue[0]
            if entry.cancel_requested:
                with self._import_lock:
                    self._import_queue.popleft()
                self._finish(entry, "cancelled")
                worked = True
                continue
            deadline = entry.request.deadline_s
            if deadline is not None and self._clock() >= entry.t_submit + deadline:
                # The deadline follows the request through a migration
                # (t_submit is the graft's receipt).
                with self._import_lock:
                    self._import_queue.popleft()
                self._finish(entry, "deadline")
                worked = True
                continue
            if not self.engine.free_slots:
                return worked
            t0 = self._clock()
            try:
                slot = self.engine.import_slot(payload)
            except NoFreeBlocksError:
                return worked  # pool dry: retry as decode frees blocks
            with self._import_lock:
                self._import_queue.popleft()
            import_s = self._clock() - t0
            meta = payload["meta"]
            entry.slot = slot
            now = self._clock()
            if meta.get("decoding"):
                # Backdated by the decode seconds accrued on the exporter, so
                # Result.decode_s stays end to end.
                entry.t_decode_start = now - float(meta.get("decode_s") or 0.0)
                self._slot_entries[slot] = entry
            else:
                entry.t_prefill_start = now
                entry.compiles_before = compile_events()
                self._prefill_entries[slot] = entry
            self.metrics.on_migration("in", nbytes)
            exported_unix = meta.get("exported_unix")
            transfer_s = (
                max(recv_unix - exported_unix, 0.0)
                if isinstance(exported_unix, (int, float)) else None
            )
            export_s = meta.get("export_s")
            total_s = import_s + (transfer_s or 0.0) + (export_s or 0.0)
            self._span("migration_import", t0, import_s, entry.request)
            self.metrics.observe_phase("migration", total_s)
            self._emit_migration(
                direction="import", request_id=entry.request.request_id, bytes=nbytes,
                blocks=int(meta["n_blocks"]), export_s=export_s, transfer_s=transfer_s,
                import_s=round(import_s, 6), total_s=round(total_s, 6),
                decoding=bool(meta.get("decoding")),
            )
            worked = True

    def _export_entry(self, entry: _Entry, slot: int, codec: str = "raw") -> tuple[bytes, int]:
        """Export ``slot`` (holding ``entry``'s generation) as payload bytes,
        with the serving-layer state in the meta: emitted tokens, the token
        history (a speculative importer's draft re-prefill input) and the
        accrued phase timings.  Releases the slot.  Returns
        ``(payload_bytes, n_blocks)``."""
        t0 = self._clock()
        # Decode seconds accrued here travel, so the importer backdates its
        # decode clock.
        decode_accrued = (
            t0 - entry.t_decode_start
            if slot in self._slot_entries or self.engine._active[slot] else 0.0
        )
        payload = self.engine.export_slot(
            slot,
            {
                "emitted": [int(t) for t in entry.tokens],
                "history": [int(t) for t in entry.request.prompt_ids]
                + [int(t) for t in entry.tokens],
                "queue_wait_s": round(entry.queue_wait_s, 6),
                "prefill_s": round(entry.prefill_s, 6),
                "decode_s": round(max(decode_accrued, 0.0), 6),
                "bucket": entry.bucket,
                "shared_tokens": entry.shared_tokens,
                "deadline_s": entry.request.deadline_s,
                "session": entry.request.session,
                "exported_unix": time.time(),
            },
        )
        self.engine.release(slot)
        # The gather's wall rides the meta, so the importer's migration
        # record carries the export/transfer/import split.
        payload["meta"]["export_s"] = round(self._clock() - t0, 6)
        # Fault hook: truncate or bit-flip the bytes in flight (once); the
        # importer's CRC and length checks must refuse the graft.
        data = self.faults.on_export_payload(payload_to_bytes(payload, codec=codec))
        return data, int(payload["meta"]["n_blocks"])

    def _complete_migration_export(self, entry: _Entry, slot: int) -> None:
        """Prefill-role handoff: the finished prefix leaves as a KV payload,
        and the request finishes here as ``"migrated"`` with the payload on
        its result."""
        t0 = self._clock()
        data, blocks = self._export_entry(entry, slot,
                                          codec=negotiate_codec(entry.request.kv_accept))
        export_s = self._clock() - t0
        self.metrics.on_migration("out", len(data))
        self._span("migration_export", t0, export_s, entry.request)
        self._emit_migration(direction="export", request_id=entry.request.request_id,
                             bytes=len(data), blocks=blocks, export_s=round(export_s, 6))
        self._finish(entry, "migrated", kv_payload=data)

    def _evacuate_step(self) -> bool:
        """Move every queued and in-flight session to an evacuation peer
        (round-robin).  In-process peers: queued entries enter the peer's
        scheduler whole and in-flight slots (decoding and mid-prefill)
        graft as payload dicts.  Over the wire (only ``_evacuate_urls``):
        queued requests replay as seeded ``/generate`` calls and exported
        sessions relay to ``/kv/import`` from background threads, each under
        one idempotency key across its retries.  The original callers'
        handles complete from the peer: no request fails."""
        peers = [p for p in self._evacuate_peers if p.accepting_imports()]
        urls = list(self._evacuate_urls)
        if not peers and not urls:
            self._evacuate_peers = []
            return False
        wire = not peers
        wire_codec = negotiate_codec(self.export_codec)

        def next_peer():
            self._evacuate_rr += 1
            return peers[self._evacuate_rr % len(peers)]

        def hand_over(entry, payload=None):
            if wire:
                data = payload
                if isinstance(payload, dict):
                    data = payload_to_bytes(payload, codec=wire_codec)
                # The entry stays registered until the relay finishes it
                # (drain waits on the registry).
                self._relay_entry_thread(entry, data, urls, "evacuate")
                return
            with self._entries_lock:
                self._entries.pop(entry.request.request_id, None)
            try:
                if payload is None:
                    next_peer().adopt_entry(entry)
                else:
                    next_peer().adopt_migration(entry, payload)
            except (RuntimeError, ValueError) as exc:
                self.metrics.record_error(repr(exc), source="evacuate")
                self._finish(entry, "error")

        worked = False
        # Not-yet-admitted work first (no KV moves): the queue, parked
        # admissions and queued grafts.
        pop = self.scheduler.pop_ready(self.scheduler.max_queue)
        for qe in pop.cancelled:
            self._finish(qe.item, "cancelled")
        for qe in pop.expired:
            self._finish(qe.item, "deadline")
        moved_entries = list(self._admit_backlog) + [qe.item for qe in pop.admit]
        self._admit_backlog = []
        with self._import_lock:
            moved_imports = list(self._import_queue)
            self._import_queue.clear()
        for entry in moved_entries:
            hand_over(entry)
            worked = True
        for entry, payload, _nbytes, _recv in moved_imports:
            hand_over(entry, payload)
            worked = True

        # In-flight sessions: export and graft; the entry itself moves.
        in_flight = list(self._prefill_entries.items()) + list(self._slot_entries.items())
        for slot, entry in in_flight:
            self._prefill_entries.pop(slot, None)
            self._slot_entries.pop(slot, None)
            t0 = self._clock()
            data, blocks = self._export_entry(entry, slot, codec=wire_codec if wire else "raw")
            export_s = self._clock() - t0
            entry.slot = None
            self.metrics.on_migration("out", len(data))
            self._span("migration_export", t0, export_s, entry.request)
            self._emit_migration(direction="evacuate", request_id=entry.request.request_id,
                                 bytes=len(data), blocks=blocks, export_s=round(export_s, 6))
            hand_over(entry, data)
            worked = True
        if worked and self._telemetry is not None:
            self._telemetry.event(
                "serve_evacuate", sessions=len(in_flight),
                queued=len(moved_entries) + len(moved_imports), peers=len(peers) or len(urls),
                wire=wire,
            )
        return worked

    def _relay_entry_thread(self, entry, data, urls, direction) -> None:
        threading.Thread(target=self._relay_entry, args=(entry, data, urls, direction),
                         name="kv-relay", daemon=True).start()

    def _relay_entry(self, entry, data, urls, direction) -> None:
        """Move one session to a peer over HTTP and complete the original
        caller's handle with the peer's result.  ``data=None`` replays a
        never-admitted request as a seeded ``/generate``; otherwise ``data``
        is a KV payload POSTed to ``/kv/import`` under ONE idempotency key
        across every retry, so the receiver grafts it once even when a
        response is lost.  Connection failures rotate to the next peer with
        exponential backoff; a 400 is final (the payload itself is bad)."""
        import urllib.error
        import urllib.request

        idem_key = uuid.uuid4().hex
        rid = entry.request.request_id
        t0 = self._clock()
        result = None
        last_exc: Exception | None = None
        for attempt in range(self.relay_attempts):
            url = urls[attempt % len(urls)]
            try:
                if data is None:
                    req = entry.request
                    body = json.dumps({
                        "prompt_ids": list(req.prompt_ids),
                        "max_new_tokens": req.max_new_tokens,
                        "temperature": req.temperature,
                        "top_k": req.top_k,
                        "top_p": req.top_p,
                        "seed": req.seed,
                        "stop_id": req.stop_id,
                        "deadline_s": req.deadline_s,
                        "session": req.session,
                    }).encode("utf-8")
                    http_req = urllib.request.Request(
                        url + "/generate", data=body,
                        headers={"Content-Type": "application/json", "X-Request-Id": rid},
                    )
                else:
                    http_req = urllib.request.Request(
                        url + "/kv/import", data=data,
                        headers={"Content-Type": "application/octet-stream",
                                 "X-Request-Id": rid, "X-Idempotency-Key": idem_key},
                    )
                with urllib.request.urlopen(http_req, timeout=self.relay_timeout_s) as resp:
                    result = json.loads(resp.read())
                break
            except urllib.error.HTTPError as exc:
                last_exc = exc
                if exc.code == 400:
                    break
            except (OSError, ValueError) as exc:
                last_exc = exc
            if attempt + 1 < self.relay_attempts:
                time.sleep(self.relay_backoff_s * (2 ** attempt))
        transfer_s = self._clock() - t0
        if result is None:
            self._relays_failed += 1
            self.metrics.record_error(f"relay failed: {last_exc!r}", source="relay",
                                      request_id=rid)
            self.flightrecorder.record("relay_failed", request_id=rid, direction=direction,
                                       error=repr(last_exc))
            self._finish(entry, "error")
            return
        # The peer's token_ids are the tokens emitted before the move plus
        # what it decoded: stream only the suffix.
        all_tokens = [int(t) for t in result.get("token_ids", [])]
        for tok in all_tokens[len(entry.tokens):]:
            entry.tokens.append(tok)
            entry.stream.put(tok)
        self._relays_ok += 1
        self._emit_migration(
            direction=f"{direction}_relay", request_id=rid,
            bytes=len(data) if data is not None else 0, transfer_s=round(transfer_s, 6),
            total_s=round(transfer_s, 6),
        )
        self._finish(entry, result.get("finish_reason") or "stop")

    def request_rebalance(self, target_url: str, max_sessions: int = 1,
                          timeout_s: float = 30.0) -> dict:
        """Transport side of ``POST /admin/evacuate``: ask the worker to
        export up to ``max_sessions`` decoding sessions and relay them to
        ``target_url``'s ``/kv/import``.  Blocks until the exports happen
        (the relays finish in the background).  Returns ``{"moved",
        "request_ids", "target"}``."""
        if not self.paged:
            raise RuntimeError("rebalancing needs a paged engine")
        if self._worker_error is not None:
            raise RuntimeError("serving engine worker died") from self._worker_error
        if not self._running:
            raise RuntimeError("serving engine is not running")
        done = threading.Event()
        out: dict = {}
        self._rebalance_queue.append((_base_url(target_url), max(1, int(max_sessions)), done,
                                      out))
        self.scheduler.notify()
        if not done.wait(timeout_s):
            raise TimeoutError("rebalance request not picked up by worker")
        return out

    def _rebalance_step(self) -> bool:
        """Worker side of rebalancing: the victims are the decoding slots
        with the most budget left (they gain most from a less loaded
        replica)."""
        worked = False
        codec = negotiate_codec(self.export_codec)
        while self._rebalance_queue:
            target, n, done, out = self._rebalance_queue.popleft()
            victims = sorted(
                self._slot_entries.items(),
                key=lambda kv: kv[1].request.max_new_tokens - len(kv[1].tokens), reverse=True,
            )[:n]
            moved = []
            for slot, entry in victims:
                self._slot_entries.pop(slot, None)
                t0 = self._clock()
                data, blocks = self._export_entry(entry, slot, codec=codec)
                export_s = self._clock() - t0
                entry.slot = None
                self.metrics.on_migration("out", len(data))
                self._span("migration_export", t0, export_s, entry.request)
                self._emit_migration(direction="rebalance", request_id=entry.request.request_id,
                                     bytes=len(data), blocks=blocks, export_s=round(export_s, 6))
                self._relay_entry_thread(entry, data, [target], "rebalance")
                moved.append(entry.request.request_id)
                self._rebalanced_out += 1
                worked = True
            out.update(moved=len(moved), request_ids=moved, target=target)
            self.flightrecorder.record("rebalance", target=target, moved=len(moved))
            done.set()
        return worked

    def _emit_migration(self, **fields) -> None:
        """One ``kind="migration"`` record (bytes, blocks, phase split), and
        its decision-ring entry whether or not a sink is attached."""
        fields = {k: v for k, v in fields.items() if v is not None}
        self.flightrecorder.record("migration", **fields)
        if self._telemetry is None:
            return
        self._telemetry.emit({
            "kind": "migration",
            "t": round(self._clock() - self._t0, 6),
            "time_unix": round(time.time(), 6),
            **fields,
        })

    def _start_decode(self, entry: _Entry, event: TickEvent) -> None:
        """Deliver an admission's first token; the slot then decodes, or, on
        a ``migrate`` request (prefill handoff), leaves as a KV payload."""
        entry.t_decode_start = self._clock()
        entry.slot = event.slot
        entry.tokens.append(event.token)
        entry.stream.put(event.token)
        if event.finished:
            self._finish(entry, event.finished)
        elif entry.request.migrate:
            self._complete_migration_export(entry, event.slot)
        else:
            self._slot_entries[event.slot] = entry

    def _deliver(self, events: list[TickEvent], tick_s: float) -> None:
        """Hand each event's token to its request, in order: a speculative
        tick may carry several events of one slot, ``finished`` on its
        last."""
        self.metrics.on_decode_tick(len(events), tick_s)
        for event in events:
            entry = self._slot_entries.get(event.slot)
            if entry is None:
                continue  # released between admit and tick (cancellation)
            entry.tokens.append(event.token)
            entry.stream.put(event.token)
            if event.finished:
                del self._slot_entries[event.slot]
                self._finish(entry, event.finished)

    def _finish(self, entry: _Entry, reason: str, kv_payload: bytes | None = None) -> None:
        if entry.done.is_set():
            return
        now = self._clock()
        decoded = entry.slot is not None and reason != "migrated"
        decode_s = now - entry.t_decode_start if decoded else 0.0
        if decoded:
            self._span("decode", entry.t_decode_start, decode_s, entry.request)
        elif reason in ("deadline", "cancelled") and not entry.migrated_in:
            # Never admitted: the whole life was queue wait.
            entry.queue_wait_s = now - entry.t_submit
            self._span("queue_wait", entry.t_submit, entry.queue_wait_s, entry.request)
        entry.result = Result(
            request_id=entry.request.request_id,
            token_ids=tuple(entry.tokens),
            finish_reason=reason,
            queue_wait_s=entry.queue_wait_s,
            prefill_s=entry.prefill_s,
            decode_s=decode_s,
            kv_payload=kv_payload,
        )
        self._requests_finished += 1
        self.metrics.on_finish(reason)
        self.flightrecorder.record(
            "deadline" if reason == "deadline" else "finish",
            request_id=entry.request.request_id,
            reason=reason if reason != "deadline" else None,
            n_tokens=len(entry.tokens) or None,
            slot=entry.slot,
        )
        # Whole-request latency for the total SLO histogram (request-level
        # only: a total SPAN would double-count in the report).
        self.metrics.observe_phase("total", entry.queue_wait_s + entry.prefill_s + decode_s)
        self._recent.append(
            {
                "request_id": entry.request.request_id,
                "finish_reason": reason,
                "n_tokens": len(entry.tokens),
                "prompt_len": len(entry.request.prompt_ids),
                "bucket": entry.bucket,
                "slot": entry.slot,
                "t_submit": round(entry.t_submit - self._t0, 6),
                "queue_wait_s": round(entry.queue_wait_s, 6),
                "prefill_s": round(entry.prefill_s, 6),
                "decode_s": round(decode_s, 6),
            }
        )
        with self._entries_lock:
            self._entries.pop(entry.request.request_id, None)
        entry.stream.put(_STREAM_END)
        entry.done.set()

    # ------------------------------------------------------------ telemetry

    def _span(self, name: str, start: float, dur: float, request: Request) -> None:
        """Emit one request-phase span record (directly, not through the
        Telemetry nesting stack: concurrent requests interleave).  The same
        duration feeds the live /metrics histogram."""
        self.metrics.observe_phase(name, dur)
        if self._telemetry is None:
            return
        self._telemetry.emit(
            {
                "kind": "span",
                "name": name,
                "path": f"serve/{name}",
                "t": round(start - self._t0, 6),
                "dur_s": round(dur, 6),
                "request_id": request.request_id,
                # Absolute span START time (spans are emitted at phase end).
                "time_unix": round(time.time() - dur, 6),
            }
        )

    def _feed_alerts(self, t: float, resources: dict | None) -> None:
        """One watchdog sample on the engine-record cadence; transitions go
        to the telemetry stream when one is attached."""
        sample: dict = {
            "queue_depth": self.scheduler.depth + len(self._admit_backlog),
            "active_slots": self.engine.active_count,
        }
        if resources is not None:
            sample["compile_events"] = resources.get("compile_events")
        if self.paged:
            gauges = self.engine.gauges()
            sample["kv_blocks_free"] = gauges.get("kv_blocks_free")
            sample["kv_blocks_total"] = gauges.get("kv_blocks_total")
            if self.spec:
                sample["spec_accept_rate"] = gauges.get("spec_accept_rate")
                sample["spec_proposed"] = gauges.get("spec_proposed_tokens")
        for transition in self._alerts.feed(sample, round(t, 6)):
            self.flightrecorder.record(
                "alert", rule=transition.get("rule"), state=transition.get("state"),
                severity=transition.get("severity"),
            )
            if self._telemetry is not None:
                self._telemetry.emit(transition)
            if transition.get("state") == "firing":
                # An alert edge flushes the ring; the recorder's cooldown
                # folds a storm of edges into one dump.
                self.blackbox_dump(f"alert:{transition.get('rule')}")

    def blackbox_dump(self, trigger: str, force: bool = False) -> dict | None:
        """Flush the decision ring as a ``kind="blackbox"`` record with the
        host-side context an incident needs (queue/slot/kvpool state, the
        alerts), emitted into the telemetry stream when a sink is attached
        and kept on the recorder for ``GET /debug/flightrecorder``.  Returns
        the dump, or None while the post-dump cooldown holds (``force``
        bypasses it)."""
        context: dict = {
            "queue_depth": self.scheduler.depth + len(self._admit_backlog),
            "active_slots": self.engine.active_count,
            "draining": self._draining,
            "requests_finished": self._requests_finished,
            "slot_states": self.engine.slot_states(),
            "alerts": self._alerts.active(),
            "alert_history": self._alerts.history(16),
        }
        if self.paged:
            context["kvpool"] = {**self.engine.gauges(), "admit_backlog": len(self._admit_backlog)}
        dump = self.flightrecorder.blackbox(trigger, context=context, force=force)
        if dump is not None and self._telemetry is not None:
            self._telemetry.emit(dump)
        return dump

    def _maybe_emit_engine_record(self) -> None:
        now = self._clock()
        elapsed = now - self._last_record_t
        if elapsed < self._record_every_s:
            return
        # Sampled whether or not a sink exists: the compile-storm rule reads
        # the counter on a server run without --metrics-jsonl too.
        resources = sample_resources(t=round(now - self._t0, 6))
        # The watchdog samples before the idle short-circuit: an idle engine
        # is when a queue-growth alert must clear.
        self._feed_alerts(now - self._t0, resources)
        if self._telemetry is None:
            self._last_record_t = now
            return
        tokens = self.engine.tokens_emitted
        # A fully idle engine stays silent: an idle server must not grow its
        # JSONL.
        if (
            tokens == self._last_record_tokens
            and not self.engine.active_count
            and not self.scheduler.depth
        ):
            self._last_record_t = now
            return
        t = round(now - self._t0, 6)
        self._telemetry.emit(
            {
                "kind": "engine",
                "t": t,
                "active_slots": self.engine.active_count,
                "queue_depth": self.scheduler.depth,
                "tokens_per_sec": round(
                    (tokens - self._last_record_tokens) / max(elapsed, 1e-9), 3
                ),
                "tokens_total": tokens,
                "ticks": self.engine.ticks,
                "requests_finished": self._requests_finished,
                "compiled_programs": kernel_libraries_loaded(),
            }
        )
        self._telemetry.emit(resources)
        roof = self.decode_roofline()
        self._telemetry.emit(
            {
                "kind": "roofline",
                "t": t,
                **{
                    key: roof[key]
                    for key in (
                        "weight_bytes", "kv_bytes", "act_bytes", "flops",
                        "arithmetic_intensity", "ridge_flops_per_byte", "bound",
                        "projected_tick_s", "weight_frac", "active_slots", "weight_dtype",
                        "fused_sampling",
                    )
                },
            }
        )
        if self.paged:
            gauges = self.engine.gauges()
            self._telemetry.emit(
                {
                    "kind": "kvpool",
                    "t": t,
                    "blocks_total": gauges["kv_blocks_total"],
                    "blocks_free": gauges["kv_blocks_free"],
                    "blocks_shared": gauges["kv_blocks_shared"],
                    "prefix_hits": gauges["prefix_cache_hits"],
                    "prefix_misses": gauges["prefix_cache_misses"],
                    "prefix_hit_rate": gauges["prefix_hit_rate"],
                    "prefill_pending_tokens": gauges["prefill_pending_tokens"],
                    "kv_pool_bytes": gauges["kv_pool_bytes"],
                    "kv_bytes_per_token": gauges["kv_bytes_per_token"],
                }
            )
            if self.spec:
                self._telemetry.emit(
                    {
                        "kind": "spec",
                        "t": t,
                        "k": gauges["spec_k"],
                        "proposed": gauges["spec_proposed_tokens"],
                        "accepted": gauges["spec_accepted_tokens"],
                        "emitted": self.engine.spec_emitted,
                        "target_steps": gauges["spec_target_steps"],
                        "accept_rate": gauges["spec_accept_rate"],
                        "tokens_per_target_step": gauges["spec_tokens_per_target_step"],
                        "rewound": gauges["spec_rewound_tokens"],
                        "draft_frac": gauges["spec_draft_frac"],
                    }
                )
        self._last_record_t = now
        self._last_record_tokens = tokens


# ------------------------------------------------------------------ HTTP


def make_http_server(serving: ServingEngine, host: str = "127.0.0.1", port: int = 8000):
    """A ``ThreadingHTTPServer`` exposing the serving engine as JSON over
    HTTP (stdlib only):

    * ``POST /generate``: body ``{"prompt": str | "prompt_ids": [int],
      "max_new_tokens"?, "temperature"?, "top_k"?, "top_p"?, "seed"?,
      "stop_id"?, "deadline_s"?, "session"?}`` -> ``{"completion"?,
      "token_ids", "finish_reason", "timings", "request_id"}``; 400 on bad
      input, 503 on a full queue, an id already in flight, or a draining or
      dead engine.  An inbound ``X-Request-Id`` becomes the request's trace
      id and is echoed on every response, errors included.
    * ``GET /healthz``: engine/queue stats (JSON).
    * ``GET /metrics``: Prometheus text exposition.
    * ``GET /statusz``: the JSON operator page.
    * ``POST /kv/export``: a /generate-shaped body served by the chunk
      machine only; the finished prefix (first token sampled) returns as a
      binary KV payload (``application/octet-stream``) in the codec the
      ``X-KV-Accept`` header allows.  When the first token already finishes
      the request, the /generate JSON returns instead.
    * ``POST /kv/import``: a ``/kv/export`` payload; the replica grafts it,
      decodes to completion and answers with the /generate JSON (the
      tokens emitted before the migration and everything decoded here).
      ``X-Idempotency-Key`` makes a retried graft land once.  400 on a bad
      or mismatched payload, 503 on backpressure.
    * ``POST /admin/evacuate``: body ``{"target": url, "max_sessions"?,
      "timeout_s"?}``; exports sessions and relays them to the target's
      ``/kv/import`` (the controller's hot rebalancing).
    * ``GET /debug/flightrecorder``: the decision ring and retained dumps.
    * ``POST /debug/dump``: force a black-box flush; answers with the dump.

    ``BT_FAULTS`` paths: a blackholed path drops the connection unanswered,
    a delayed one sleeps first (``resilience/faults.py``).

    ``port=0`` binds an ephemeral port; the caller owns ``serve_forever()``
    and ``shutdown()``.  ``server.handlers_in_flight()`` counts the requests
    still being answered, so a draining ``serve`` writes every answer (an
    evacuated session's too) before it exits.
    """
    import socket
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    in_flight = [0]
    in_flight_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # noqa: D102 -- telemetry is the log
            pass

        def handle(self):  # noqa: D102 -- counts the answers in flight
            with in_flight_lock:
                in_flight[0] += 1
            try:
                super().handle()
            finally:
                with in_flight_lock:
                    in_flight[0] -= 1

        def _fault_gate(self) -> bool:
            """Fault hook (``BT_FAULTS``): a blackholed path drops the
            connection with no response, as a partitioned peer looks to
            its caller.  Delays sleep inside ``on_http_request``."""
            if serving.faults.on_http_request(self.path) == "blackhole":
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.close_connection = True
                return True
            return False

        def _reply(self, code: int, payload: dict, request_id: str | None = None) -> None:
            self._reply_text(code, json.dumps(payload), "application/json", request_id)

        def _reply_text(
            self, code: int, text: str, content_type: str, request_id: str | None = None
        ) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            if request_id is not None:
                self.send_header("X-Request-Id", request_id)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self._fault_gate():
                return
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                return self._reply(200, {"ok": True, **serving.stats()})
            if path == "/metrics":
                return self._reply_text(
                    200, serving.prometheus_metrics(), "text/plain; version=0.0.4; charset=utf-8"
                )
            if path == "/statusz":
                return self._reply(200, serving.statusz())
            if path == "/debug/flightrecorder":
                return self._reply(200, serving.flightrecorder.debug_page())
            return self._reply(404, {"error": "unknown path"})

        def _reply_payload(self, data: bytes, request_id: str) -> None:
            """A binary KV payload (a /kv/export success)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Request-Id", request_id)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _reply_result(self, result: Result) -> None:
            payload = {
                "request_id": result.request_id,
                "token_ids": list(result.token_ids),
                "finish_reason": result.finish_reason,
                "timings": result.timings(),
            }
            if serving.tokenizer is not None:
                payload["completion"] = serving._completion(result)
            self._reply(200, payload, result.request_id)

        def do_POST(self):  # noqa: N802 (stdlib API)
            if self._fault_gate():
                return
            if self.path == "/kv/import":
                return self._kv_import()
            if self.path == "/admin/evacuate":
                return self._admin_evacuate()
            if self.path == "/debug/dump":
                return self._reply(200, serving.blackbox_dump("manual", force=True))
            if self.path not in ("/generate", "/kv/export"):
                return self._reply(404, {"error": "unknown path"})
            migrate = self.path == "/kv/export"
            trace_id = (self.headers.get("X-Request-Id") or "").strip()
            trace_id = trace_id[:128] or uuid.uuid4().hex
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                prompt_ids = body.get("prompt_ids")
                if prompt_ids is None:
                    prompt = body.get("prompt")
                    if prompt is None:
                        raise ValueError("need 'prompt' or 'prompt_ids'")
                    if serving.tokenizer is None:
                        raise ValueError("'prompt' needs a tokenizer; send 'prompt_ids'")
                    prompt_ids = serving.tokenizer.encode(prompt)
                result = serving.generate(
                    prompt_ids,
                    max_new_tokens=body.get("max_new_tokens"),
                    temperature=float(body.get("temperature", 1.0)),
                    top_k=body.get("top_k"),
                    top_p=body.get("top_p"),
                    seed=int(body.get("seed", 0)),
                    stop_id=body.get("stop_id"),
                    deadline_s=body.get("deadline_s"),
                    session=body.get("session"),
                    request_id=trace_id,
                    migrate=migrate,
                    # The importer-to-be names the frames it opens; the
                    # export picks the best one both sides share.
                    kv_accept=self.headers.get("X-KV-Accept") if migrate else None,
                )
            except (QueueFullError, DuplicateRequestError) as exc:
                # "This replica can't take THIS request now": 503, so a
                # router fails over instead of judging the caller.
                return self._reply(503, {"error": str(exc), "request_id": trace_id}, trace_id)
            except (ValueError, TypeError) as exc:  # json.JSONDecodeError is a ValueError
                return self._reply(400, {"error": str(exc), "request_id": trace_id}, trace_id)
            except RuntimeError as exc:
                # Not running, draining or a dead worker.
                return self._reply(503, {"error": str(exc), "request_id": trace_id}, trace_id)
            if result.finish_reason == "migrated":
                return self._reply_payload(result.kv_payload, result.request_id)
            self._reply_result(result)

        def _kv_import(self):
            """POST /kv/import: graft a payload, decode to completion, answer
            with the /generate JSON."""
            trace_id = (self.headers.get("X-Request-Id") or "").strip()[:128] or None
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                idem = (self.headers.get("X-Idempotency-Key") or "").strip()[:128] or None
                result = serving.submit_import(data, idempotency_key=idem).result()
            except (QueueFullError, DuplicateRequestError) as exc:
                return self._reply(503, {"error": str(exc)}, trace_id)
            except (ValueError, TypeError, KeyError, IndexError) as exc:
                # KeyError/IndexError: a JSON-valid but structurally corrupt
                # header; the caller's bad payload, never a replica fault.
                return self._reply(400, {"error": f"bad payload: {exc!r}"}, trace_id)
            except RuntimeError as exc:
                return self._reply(503, {"error": str(exc)}, trace_id)
            self._reply_result(result)

        def _admin_evacuate(self):
            """POST /admin/evacuate: body ``{"target": base_url,
            "max_sessions"?, "timeout_s"?}``; answers with the moved request
            ids once the exports happen (the relays finish later)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                target = body.get("target")
                if not target or not isinstance(target, str):
                    raise ValueError("need 'target' (peer base URL)")
                out = serving.request_rebalance(
                    target, max_sessions=int(body.get("max_sessions", 1)),
                    timeout_s=float(body.get("timeout_s", 30.0)),
                )
            except (ValueError, TypeError) as exc:  # json.JSONDecodeError is a ValueError
                return self._reply(400, {"error": str(exc)})
            except (RuntimeError, TimeoutError) as exc:
                return self._reply(503, {"error": str(exc)})
            return self._reply(200, out)

    server = ThreadingHTTPServer((host, port), Handler)
    server.handlers_in_flight = lambda: in_flight[0]
    return server
