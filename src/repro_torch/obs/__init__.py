"""Observability of the port (counterpart of ``repro/obs``): span tracing
and the metrics registry, both plain Python.

* :mod:`repro_torch.obs.trace` — ring-buffered hierarchical span tracer
  with a module-level no-op default; the serving hot path, maintenance
  loop and engine dispatch are instrumented unconditionally because the
  disabled cost is one no-op call.
* :mod:`repro_torch.obs.registry` — Counter/Gauge/Histogram/Summary
  instruments with Prometheus text exposition and a JSON snapshot;
  ``repro_torch.serving.metrics.ServiceMetrics`` is built on it.

The reference's third piece, ``explain`` (the per-phase candidate-funnel
debug path), is not ported yet: ``repro_torch.obs.explain`` raises
``AttributeError``.
"""
from . import trace
from .registry import (Counter, Gauge, Histogram, Metric, MetricsRegistry,
                       Summary)
from .trace import (NOOP_SPAN, NOOP_TRACER, Span, Tracer, disable, enable,
                    get_tracer, record, set_tracer, span, tracing)

__all__ = [
    "trace",
    "Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry", "Summary",
    "NOOP_SPAN", "NOOP_TRACER", "Span", "Tracer", "disable", "enable",
    "get_tracer", "record", "set_tracer", "span", "tracing",
]
