"""Low-overhead hierarchical span tracing for the serving path (a copy of
``repro/obs/trace.py``, same span vocabulary).

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
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Optional


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

    def span(self, name: str, **attrs):
        """-> the shared :data:`NOOP_SPAN` (no allocation, no clock)."""
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
    """

    __slots__ = ("_tracer", "name", "attrs", "start", "span_id",
                 "parent_id", "trace_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        """Built by :meth:`Tracer.span`; not started until ``__enter__``."""
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.start = 0.0
        self.span_id = 0
        self.parent_id: Optional[int] = None
        self.trace_id = 0

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
        self.start = t.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        """Finish the span: read the clock FIRST, pop the stack (popping
        through any unexited children so one leaked span cannot corrupt
        the hierarchy forever), emit the record. An exception inside the
        span marks ``error: true`` and propagates (never swallowed)."""
        t = self._tracer
        end = t.clock()
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

    def _next_id(self) -> int:
        self._ids += 1
        return self._ids

    def _emit(self, rec: dict) -> None:
        if len(self._spans) >= self.capacity:
            self._spans.popleft()
            self.dropped += 1
        self._spans.append(rec)

    def span(self, name: str, **attrs) -> Span:
        """-> an unstarted :class:`Span` context manager (``with
        tracer.span("name", key=val):``)."""
        return Span(self, name, attrs)

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

    def finished(self) -> list[dict]:
        """The ring's finished span records, oldest first (a copy)."""
        return list(self._spans)

    def drain(self) -> list[dict]:
        """Pop and return every finished span (the export-loop primitive);
        ``dropped`` keeps its cumulative count."""
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


def span(name: str, **attrs):
    """A span on the CURRENT tracer — the call instrumented code makes.

    Disabled (the default): returns the shared :data:`NOOP_SPAN` with no
    allocation. Enabled: returns a live :class:`Span` context manager.
    """
    return _tracer.span(name, **attrs)


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
