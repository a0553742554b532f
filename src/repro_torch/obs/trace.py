"""Low-overhead hierarchical span tracing for the serving path (a copy of
``repro/obs/trace.py``, the same API and span vocabulary, plus the two
additions and the engine's phase spans below).

A **span** is one timed region of the serving loop — a batcher drain, a
per-generation cache lookup, a miss-lane execute, a top-k merge, a
maintenance action — recorded with its name, start time, duration, free-
form attributes, and its position in the span tree (``trace_id`` /
``span_id`` / ``parent_id``). Finished spans land in a bounded ring
buffer (oldest dropped first, ``Tracer.dropped`` counts the losses), so a
long-running service can leave tracing on without growing memory.

The module-level API is what instrumented code calls::

    from repro_torch.obs import trace

    with trace.span("service.flush", batch=n):
        ...
    trace.record("batcher.queue_wait", wait_s, batch=n)   # pre-measured

Tracing is **disabled by default**: the module-level tracer is the
:data:`NOOP_TRACER`, whose ``span()`` returns the shared
:data:`NOOP_SPAN` singleton — no allocation, no clock read, no ring
append. ``tests/test_torch_obs.py`` pins that contract, which is what lets
the hot path (``repro_torch.serving.service``, ``repro_torch.core.engine``)
keep its instrumentation unconditionally. Enable with :func:`enable` (or the
scoped :class:`tracing` context manager), export with
:meth:`Tracer.export_jsonl`, and see docs/OBSERVABILITY.md for the span
vocabulary and the measured overhead budget.

Spans nest through a plain stack, so the tracer is single-threaded like
the serving loop it instruments (docs/SERVING.md); CUDA launches are
asynchronous, so a span around a call whose result is not synchronized
times the launches, not the device work — span names note ``dispatch``
where that applies.

Two things the reference's tracer does not do:

* **Stream-timed spans.** ``span(name, device=d)`` with a CUDA device
  records a CUDA event on the current stream as it opens and as it closes;
  the record gets ``stream_ms``, the device time between the two. It is
  read from the events only when the ring is read (:meth:`Tracer.finished`,
  :meth:`Tracer.drain`, :meth:`Tracer.export_jsonl`), never inside the
  traced call, so a span adds no host wait. On the CPU it is a host span.
* **The profiler's clock.** While a ``torch.profiler`` records, every live
  span also opens a ``record_function`` of its own name, so the program's
  spans land in the profiler's trace beside the device operations they
  launched.

The engine's phase spans (:data:`PORT_ONLY`) are the port's own; the rest
of the vocabulary is the reference's. docs/PORT_OBSERVABILITY.md describes
both additions and the phase spans.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Optional

import torch

# The spans the port's engine opens inside ``engine.retrieve.dispatch`` that
# the reference has no counterpart of: candidate generation (with the host's
# wait at the candidate bitmap inside it), the prefilter and late
# interaction (with, on the fused lane, the survivor gathers and the
# kernel inside it). No span of the reference's vocabulary opens inside
# them.
PORT_ONLY = ("engine.candgen", "engine.candgen.bitmap_wait",
             "engine.prefilter", "engine.late", "engine.late.gather",
             "engine.late.pqinter")


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is recording on this thread now."""
    return torch._C._autograd._profiler_enabled()


class _NoopSpan:
    """The do-nothing span: context manager + ``set()``, all no-ops.

    A single shared instance (:data:`NOOP_SPAN`) is returned by every
    ``span()`` call on the no-op tracer — the identity is part of the
    overhead contract (tests pin ``trace.span("x") is NOOP_SPAN``).
    """

    __slots__ = ()

    def __enter__(self):
        """No-op enter; returns itself so ``as sp`` still binds."""
        return self

    def __exit__(self, exc_type, exc, tb):
        """No-op exit; never swallows exceptions."""
        return False

    def set(self, **attrs):
        """Discard attributes; returns itself for chaining."""
        return self


NOOP_SPAN = _NoopSpan()


class _NoopTracer:
    """The do-nothing tracer installed by default (``enabled`` is False)."""

    enabled = False

    def span(self, name: str, device=None, **attrs):
        """-> the shared :data:`NOOP_SPAN` (no allocation, no clock, no
        event)."""
        return NOOP_SPAN

    def record(self, name: str, duration_s: float, **attrs) -> None:
        """Discard a pre-measured event."""
        return None


NOOP_TRACER = _NoopTracer()


class Span:
    """One open span — a context manager handed out by :meth:`Tracer.span`.

    ``__enter__`` assigns ids (parented under the innermost open span),
    reads the clock, and pushes onto the tracer's stack; ``__exit__`` pops
    and emits the finished record into the ring. ``set(**attrs)`` adds
    attributes mid-span (e.g. a hit count known only after the lookup
    loop). Attribute values should be JSON-able; the exporter falls back
    to ``str()`` for anything that is not.

    With a CUDA ``device`` the span also records a CUDA event on that
    device's current stream (``_stream``) at each end (``_events``), which
    the tracer reads into ``stream_ms`` when its ring is read; while a
    profiler records, ``_range`` is the ``record_function`` the span
    opened.
    """

    __slots__ = ("_tracer", "name", "attrs", "start", "span_id",
                 "parent_id", "trace_id", "_device", "_stream", "_events",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 device=None):
        """Built by :meth:`Tracer.span`; not started until ``__enter__``."""
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.start = 0.0
        self.span_id = 0
        self.parent_id: Optional[int] = None
        self.trace_id = 0
        self._device = (device if device is not None and
                        torch.device(device).type == "cuda" else None)
        self._stream = self._events = self._range = None

    def set(self, **attrs) -> "Span":
        """Merge attributes into the span; returns itself for chaining."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        """Start the span: assign ids, parent under the innermost open
        span (a root span starts a new trace), read the clock LAST so the
        bookkeeping is outside the timed region."""
        t = self._tracer
        self.span_id = t._next_id()
        if t._stack:
            parent = t._stack[-1]
            self.parent_id = parent.span_id
            self.trace_id = parent.trace_id
        else:
            self.parent_id = None
            self.trace_id = self.span_id
        t._stack.append(self)
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._device is not None:
            self._stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.start = t.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        """Finish the span: read the clock FIRST, pop the stack (popping
        through any unexited children so one leaked span cannot corrupt
        the hierarchy forever), emit the record. An exception inside the
        span marks ``error: true`` and propagates (never swallowed)."""
        t = self._tracer
        end = t.clock()
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        while t._stack and t._stack.pop() is not self:
            pass
        rec = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_s": end - self.start,
            "attrs": self.attrs,
        }
        if exc_type is not None:
            rec["error"] = True
        t._emit(rec)
        if self._events is not None:
            t._timed.append((rec, *self._events))
        return False


class Tracer:
    """Ring-buffered span collector (``enabled`` is True).

    capacity : finished spans kept; older ones drop off the ring
               (``dropped`` counts them — a dashboard's signal to raise
               the capacity or export more often).
    clock    : injectable monotonic clock in SECONDS (default
               ``time.perf_counter``); deterministic tests inject a fake.
    """

    enabled = True

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.perf_counter):
        """Build an empty tracer; install it with :func:`set_tracer` (or
        use :func:`enable` / :class:`tracing`, which do both)."""
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1: the ring must "
                             "hold at least one span")
        self.capacity = int(capacity)
        self.clock = clock
        self.dropped = 0
        self._spans: deque = deque()
        self._stack: list[Span] = []
        self._ids = 0
        # (record, start event, end event) of the stream-timed spans not
        # read yet; the ring holds at most ``capacity`` records, so an
        # entry that falls off this deque's far end belongs to a record
        # the ring has dropped too
        self._timed: deque = deque(maxlen=self.capacity)

    def _next_id(self) -> int:
        self._ids += 1
        return self._ids

    def _emit(self, rec: dict) -> None:
        if len(self._spans) >= self.capacity:
            self._spans.popleft()
            self.dropped += 1
        self._spans.append(rec)

    def span(self, name: str, device=None, **attrs) -> Span:
        """-> an unstarted :class:`Span` context manager (``with
        tracer.span("name", key=val):``); with a CUDA ``device`` its record
        also gets ``stream_ms``."""
        return Span(self, name, attrs, device)

    def record(self, name: str, duration_s: float, **attrs) -> None:
        """Record a PRE-MEASURED event as a finished span ending now.

        For durations measured with a foreign clock (the batcher's
        injectable deadline clock, a staged-swap wait): the span's
        ``start`` is back-dated to ``clock() - duration_s``, and it
        parents under the innermost open span like any other.
        """
        end = self.clock()
        sid = self._next_id()
        parent = self._stack[-1] if self._stack else None
        self._emit({
            "name": name,
            "trace_id": parent.trace_id if parent else sid,
            "span_id": sid,
            "parent_id": parent.span_id if parent else None,
            "start": end - duration_s,
            "duration_s": duration_s,
            "attrs": attrs,
        })

    def _resolve(self) -> None:
        """Give each stream-timed record its ``stream_ms``: the device ms
        between its two events, waiting for the later one to complete."""
        while self._timed:
            rec, start, end = self._timed.popleft()
            end.synchronize()
            rec["stream_ms"] = start.elapsed_time(end)

    def finished(self) -> list[dict]:
        """The ring's finished span records, oldest first (a copy), the
        stream-timed ones with their ``stream_ms``."""
        self._resolve()
        return list(self._spans)

    def drain(self) -> list[dict]:
        """Pop and return every finished span (the export-loop primitive),
        as :meth:`finished` gives them; ``dropped`` keeps its cumulative
        count."""
        self._resolve()
        out = list(self._spans)
        self._spans.clear()
        return out

    def export_jsonl(self, path) -> int:
        """Write the finished spans to ``path`` as JSON Lines (one span
        record per line; non-JSON attribute values fall back to ``str``);
        -> the number of spans written. The ring is left intact — pair
        with :meth:`drain` for an incremental export loop."""
        spans = self.finished()
        with open(path, "w") as f:
            for rec in spans:
                f.write(json.dumps(rec, default=str))
                f.write("\n")
        return len(spans)


_tracer = NOOP_TRACER


def get_tracer():
    """The currently installed tracer (:data:`NOOP_TRACER` by default)."""
    return _tracer


def set_tracer(tracer):
    """Install ``tracer`` as the module-level tracer (``None`` restores
    the no-op); -> the previously installed one, so scoped users can
    restore it (:class:`tracing` does exactly that)."""
    global _tracer
    prev = _tracer
    _tracer = NOOP_TRACER if tracer is None else tracer
    return prev


def enable(capacity: int = 4096,
           clock: Callable[[], float] = time.perf_counter) -> Tracer:
    """Install a fresh :class:`Tracer` module-wide and return it."""
    t = Tracer(capacity, clock)
    set_tracer(t)
    return t


def disable():
    """Restore the no-op tracer; -> the tracer that was installed."""
    return set_tracer(NOOP_TRACER)


def span(name: str, device=None, **attrs):
    """A span on the CURRENT tracer — the call instrumented code makes.

    Disabled (the default): returns the shared :data:`NOOP_SPAN` with no
    allocation. Enabled: returns a live :class:`Span` context manager,
    stream-timed when ``device`` is a CUDA device.
    """
    return _tracer.span(name, device, **attrs)


def record(name: str, duration_s: float, **attrs) -> None:
    """A pre-measured event on the CURRENT tracer (no-op when disabled)."""
    return _tracer.record(name, duration_s, **attrs)


class tracing:
    """Scoped tracing: ``with trace.tracing() as tr:`` installs a fresh
    :class:`Tracer` for the block and restores the previous tracer after —
    the benchmark/test-friendly enable that cannot leak an enabled tracer
    into later code."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.perf_counter):
        """Same knobs as :class:`Tracer`."""
        self._capacity = capacity
        self._clock = clock
        self._prev = None

    def __enter__(self) -> Tracer:
        """Install a fresh tracer; -> that tracer (read it after the
        block: the reference outlives the installation)."""
        t = Tracer(self._capacity, self._clock)
        self._prev = set_tracer(t)
        return t

    def __exit__(self, exc_type, exc, tb):
        """Restore the previously installed tracer."""
        set_tracer(self._prev)
        return False
