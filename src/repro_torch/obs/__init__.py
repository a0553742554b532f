"""Observability of the port (counterpart of ``repro/obs``): span tracing,
the metrics registry and retrieval explain.

* :mod:`repro_torch.obs.trace` — ring-buffered hierarchical span tracer
  with a module-level no-op default; the serving hot path, maintenance
  loop and engine dispatch are instrumented unconditionally because the
  disabled cost is one no-op call.
* :mod:`repro_torch.obs.registry` — Counter/Gauge/Histogram/Summary
  instruments with Prometheus text exposition and a JSON snapshot;
  ``repro_torch.serving.metrics.ServiceMetrics`` is built on it.
* :mod:`repro_torch.obs.explain` — the per-phase candidate-funnel debug
  path (imported lazily: it imports ``repro_torch.core.engine``, which
  imports ``repro_torch.obs.trace``, so an eager import here would cycle).
"""
from . import trace
from .registry import (Counter, Gauge, Histogram, Metric, MetricsRegistry,
                       Summary)
from .trace import (NOOP_SPAN, NOOP_TRACER, Span, Tracer, disable, enable,
                    get_tracer, record, set_tracer, span, tracing)

__all__ = [
    "trace", "explain",
    "Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry", "Summary",
    "NOOP_SPAN", "NOOP_TRACER", "Span", "Tracer", "disable", "enable",
    "get_tracer", "record", "set_tracer", "span", "tracing",
]


def __getattr__(name):
    """``repro_torch.obs.explain``, imported on first attribute access (it
    imports the engine, which imports this package's tracer)."""
    if name == "explain":
        # importlib, not ``from . import``: the from-import form probes the
        # package with hasattr first, which would re-enter this hook
        import importlib
        return importlib.import_module(".explain", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
