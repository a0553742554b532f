"""What the per-layer readers share (``perfbench/metrics/<name>.py``).

Each reader gets the run's :class:`Readings` and its metric's parameters
(``perfbench/metrics/<name>.json``) and returns a number, or None when it
finds nothing to read: then the metric is left out of the result line. A
share of a roofline is never given as 0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from . import yardstick
from .trace_view import TraceView


class Readings(NamedTuple):
    """What a traced run leaves for the readers."""

    trace: Optional[TraceView]   # the profiled calls
    spans: list                  # the program's spans, untraced calls
    counts: list                 # the reference's counts, one a traced call
    missing: set                 # range labels that could not be installed


def range_ms(r: Readings, params: dict) -> Optional[float]:
    """Device ms a call of the operations launched inside the ranges."""
    labels = params["ranges"]
    if r.trace is None or set(labels) & r.missing:
        return None
    return r.trace.device_ms_per_call(labels)


def roofline_pct(r: Readings, params: dict) -> Optional[float]:
    """100 x the traced calls' bound ms (the yardstick's, from the
    reference's counts of those calls) over the device ms of the
    operations launched inside the ranges."""
    ms = range_ms(r, params)
    if ms is None or len(r.counts) != r.trace.calls:
        return None
    fn = yardstick.BOUNDS[params["bound"]]
    bound = sum(fn(c[params["bound"]])["bound_ms"] for c in r.counts)
    return 100.0 * bound / (ms * r.trace.calls)


def span_ms(r: Readings, params: dict) -> Optional[float]:
    """Mean host ms of the program's span ``params["span"]``."""
    d = [s["duration_s"] for s in r.spans if s["name"] == params["span"]]
    return 1e3 * sum(d) / len(d) if d else None


def idle_pct(r: Readings, params: dict) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    if r.trace is None or r.trace.window_s() <= 0 or r.trace.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s())
