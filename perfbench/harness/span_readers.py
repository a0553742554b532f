"""Readers of the program's own phase spans (``repro_torch.obs.trace``;
``core/engine.py`` opens them inside ``engine.retrieve.dispatch``), over the
window's calls that the profiler did not record (``Readings.spans``).

A program without such a span, or a run on the CPU, where spans carry no
``stream_ms``, gives None: the metric is left out of the result line.
"""
from __future__ import annotations

from typing import Optional

from .readers import Readings

DISPATCH = "engine.retrieve.dispatch"   # a call's root span, with its batch


def stream_ms(r: Readings, params: dict) -> Optional[float]:
    """Mean ``stream_ms`` of the program's span ``params["span"]``: the
    device ms between the CUDA events it records on its stream as it opens
    and as it closes."""
    d = [s["stream_ms"] for s in r.spans
         if s["name"] == params["span"] and "stream_ms" in s]
    return sum(d) / len(d) if d else None


def per_query(r: Readings, params: dict) -> Optional[float]:
    """The attribute ``params["attr"]`` of the span ``params["span"]``,
    summed over the calls, over the queries of those calls: the ``batch``
    of the nearest ``engine.retrieve.dispatch`` above each such span, found
    by its parents, so that a dispatch under other spans, or several in one
    trace, each count their own queries."""
    by_id = {s["span_id"]: s for s in r.spans}
    total = queries = 0
    for s in r.spans:
        if s["name"] != params["span"] or params["attr"] not in s["attrs"]:
            continue
        up = by_id.get(s["parent_id"])
        while up is not None and up["name"] != DISPATCH:
            up = by_id.get(up["parent_id"])
        batch = None if up is None else up["attrs"].get("batch")
        if batch:
            total += s["attrs"][params["attr"]]
            queries += batch
    return total / queries if queries else None
