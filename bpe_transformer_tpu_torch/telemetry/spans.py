"""Span/event emitter: nested wall-clock spans as structured JSONL records.

The port's copy of ``bpe_transformer_tpu/telemetry/spans.py``.

``Telemetry`` is the host-side narrator of a run.  It shares the step
metrics' sink (``MetricsLogger.log``), so one JSONL file carries the whole
story — a run manifest header, step records, span/event records, and a
footer — and ``bpe-tpu report`` can reconstruct the run from that single
file.

Record kinds (step metrics carry no ``kind`` key, preserving the existing
JSONL schema):

- ``{"kind": "span", "name", "path", "t", "dur_s", ...attrs}`` — a closed
  wall-clock span; ``path`` is the ``/``-joined nesting
  (``"setup/resume"``), ``t`` the start offset in seconds since the
  ``Telemetry`` object was created.
- ``{"kind": "event", "name", "t", ...attrs}`` — a point-in-time marker
  (NaN detection, watchdog trips, checkpoint completions).
- ``{"kind": "manifest", ...}`` / ``{"kind": "footer", ...}`` — run header
  and trailer (see `telemetry.manifest` and :meth:`Telemetry.footer`).

:func:`phase` is the one span primitive the step's hot path uses: while a
``torch.profiler`` records, it opens a host range named ``bpt.<name>`` on the
profiler's own clock, beside the kernels and the CUDA runtime calls, and
with no profiler it costs one flag check.  The trace is the store: nothing
is kept in memory.  A ``Telemetry`` span opens the same range, so the
loop's set-up, eval, checkpoint and rollback spans show on a
``--profile-trace`` timeline too.  The ranges are ``FUNCTION`` scope, never
``USER_SCOPE``: the profiler mirrors a user-scope range onto the device
timeline as a CUDA-typed ``gpu_user_annotation``, which every union of
device intervals (the busy time, the idle share) would count as device work.
This module imports without torch (the router and the fleet tools narrate
through ``Telemetry`` on hosts that have none); the ranges bind to torch
once it is loaded.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import Counter
from typing import Callable

#: The context every span returns while no profiler records: one shared
#: object, so a span then allocates nothing.
_NO_SPAN = contextlib.nullcontext()
#: ``torch.autograd.profiler`` (whose ``_is_profiler_enabled`` flag the
#: profiler sets as it starts and clears as it stops) and the range's
#: constructor, ``torch._C._profiler._RecordFunctionFast``, bound by
#: :func:`_bind` once torch is loaded.
_profiler = None
_open_range = None


def _bind() -> bool:
    """Bind the profiler's flag and the range's constructor; False while
    torch is not loaded (then no profiler can be recording)."""
    global _profiler, _open_range
    if sys.modules.get("torch") is None:
        return False
    from torch._C._profiler import _RecordFunctionFast
    from torch.autograd import profiler

    _open_range = _RecordFunctionFast
    _profiler = profiler
    return True


def phase(name: str):
    """``with phase("forward"): ...`` — a ``bpt.<name>`` range on the
    profiler's clock while a ``torch.profiler`` records (``FUNCTION``
    scope: a host event, module docstring); otherwise the shared no-op
    context, after one flag check."""
    if _profiler is None and not _bind():
        return _NO_SPAN
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _open_range("bpt." + name)


class SpanHandle:
    """An open span; ``end()`` (or the ``Telemetry.span`` context manager)
    closes it and emits the record.  While a profiler records, the span is
    also a :func:`phase` range, closed by ``end()``."""

    def __init__(self, telemetry: "Telemetry", name: str, path: str, attrs: dict):
        self._telemetry = telemetry
        self.name = name
        self.path = path
        self._attrs = attrs
        self._range = phase(name)
        self._range.__enter__()
        self._start = telemetry._clock()
        self._closed = False

    def end(self, **extra_attrs) -> float:
        """Close the span; returns its duration in seconds.  Idempotent."""
        if self._closed:
            return 0.0
        self._closed = True
        dur = self._telemetry._clock() - self._start
        self._range.__exit__(None, None, None)
        self._telemetry._close_span(self, dur, extra_attrs)
        return dur


class Telemetry:
    """Nested spans + events emitted through a record sink.

    ``sink`` is any ``callable(dict)`` — typically ``MetricsLogger.log`` so
    telemetry lands in the same JSONL as step metrics.  With ``sink=None``
    records are buffered and flushed on :meth:`attach` (the training loop
    starts narrating before its sinks exist); never attached, the buffer is
    simply dropped, so a bare ``Telemetry()`` is a safe no-op emitter.

    Emission is lock-protected: the watchdog thread emits hang events while
    the main thread emits step spans.
    """

    def __init__(self, sink: Callable[[dict], None] | None = None, clock=time.perf_counter):
        self._sink = sink
        self._clock = clock
        self._t0 = clock()
        self._stack: list[str] = []
        self._buffer: list[dict] = []
        self._lock = threading.Lock()
        #: "<kind>:<name>" -> count of records emitted; the footer reports it.
        self.counts: Counter = Counter()

    # ------------------------------------------------------------- plumbing

    def attach(self, sink: Callable[[dict], None]) -> None:
        """Set the sink and flush records emitted before it existed."""
        with self._lock:
            self._sink = sink
            buffered, self._buffer = self._buffer, []
            for record in buffered:
                sink(record)

    def emit(self, record: dict) -> None:
        """Send one record to the sink (or buffer it when none is attached)."""
        key = f"{record.get('kind', 'metric')}:{record.get('name', '')}"
        with self._lock:
            self.counts[key] += 1
            if self._sink is None:
                self._buffer.append(record)
            else:
                self._sink(record)

    def _now(self) -> float:
        return self._clock() - self._t0

    def now(self) -> float:
        """Seconds since this Telemetry was created — the ``t`` axis every
        span/event record shares.  Public so emitters of custom record
        kinds (preemption/recovery in the training loop) stamp the same
        timeline."""
        return round(self._now(), 6)

    # ------------------------------------------------------- span/event API

    def start_span(self, name: str, **attrs) -> SpanHandle:
        """Open a span; close it with ``handle.end()``.  Spans must close in
        LIFO order (they nest), on the thread that opened them."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        return SpanHandle(self, name, path, attrs)

    def _close_span(self, handle: SpanHandle, dur: float, extra_attrs: dict) -> None:
        if self._stack and self._stack[-1] == handle.name:
            self._stack.pop()
        self.emit(
            {
                "kind": "span",
                "name": handle.name,
                "path": handle.path,
                "t": round(handle._start - self._t0, 6),
                "dur_s": round(dur, 6),
                **handle._attrs,
                **extra_attrs,
            }
        )

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """``with telemetry.span("compile"): ...`` — nested wall-clock span."""
        handle = self.start_span(name, **attrs)
        try:
            yield handle
        finally:
            handle.end()

    def event(self, name: str, **attrs) -> None:
        """Emit a point-in-time event record."""
        self.emit(
            {"kind": "event", "name": name, "t": round(self._now(), 6), **attrs}
        )

    def footer(self, **attrs) -> None:
        """Emit the run trailer: record counts plus caller attrs (step count,
        watchdog verdict).  A JSONL ending without one signals a crash."""
        self.emit(
            {
                "kind": "footer",
                "t": round(self._now(), 6),
                "record_counts": dict(self.counts),
                **attrs,
            }
        )
