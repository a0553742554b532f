"""A small metrics registry: Counter / Gauge / Histogram / Summary with
Prometheus text exposition and a JSON snapshot (a copy of
``repro/obs/registry.py``).

``repro_torch.serving.metrics.ServiceMetrics`` is built on it: subsystems
**register** instruments (get-or-create by name, so a shared registry
composes), mutate them
through the instrument handles, and the registry renders every registered
sample into the Prometheus text exposition format (``# HELP`` / ``# TYPE``
comments + ``name{label="value"} 1234`` samples —
``scripts/check_metrics_exposition.py`` lints the output against the
format spec in CI) or a JSON-able dict.

Design constraints, in order:

* **Cheap updates** — ``Counter.inc`` / ``Gauge.set`` are a dict write;
  the serving hot path calls them per batch, not per document.
* **External state without mirroring** — ``bind(fn)`` attaches a zero-arg
  callback so values owned elsewhere (the result cache's cumulative
  counters, the batcher's queue depth) are read at render time instead of
  being copied on every mutation.
* **Conventions enforced, not assumed** — counter names must end in
  ``_total``, metric/label names must match the Prometheus grammar,
  counters reject negative increments; the CI lint then only has to
  check the rendering, not the call sites.

Labels are supported on counters and gauges (e.g. the per-generation
cache hit ratio, labeled by generation fingerprint); histograms and
summaries are unlabeled — the serving layer needs exactly one of each per
reservoir, and unlabeled keeps their sample rendering simple. A
:class:`Summary` does not own samples: it renders quantiles from any
object shaped like ``repro_torch.serving.metrics.LatencyStats`` (``count``,
``total_s``, ``percentile(pct)``), so the existing reservoirs plug in
without a second copy of every latency sample.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Optional, Sequence

_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")

# histogram default: powers of two around micro-batch latencies/sizes
DEFAULT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def _escape_help(text: str) -> str:
    """Escape a HELP string per the exposition format (backslash, LF)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    """Escape a label value (backslash, double quote, LF)."""
    return value.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _format_value(v: float) -> str:
    """Render a sample value: integers without a trailing ``.0``,
    non-finite values as the spec's ``+Inf`` / ``-Inf`` / ``NaN``."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Metric:
    """Base instrument: a name, HELP text, optional labels, and either
    stored per-labelset values or a bound read callback.

    Subclasses set ``kind`` (the ``# TYPE`` word) and add their mutation
    verbs; rendering is shared through :meth:`samples`.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = (),
                 fn: Optional[Callable[[], float]] = None):
        """``name`` must match the Prometheus metric-name grammar;
        ``label_names`` likewise. ``fn`` (unlabeled metrics only) is a
        zero-arg callback read at render time — see :meth:`bind`."""
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_NAME_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._values: dict[tuple, float] = {}
        self._fn: Optional[Callable[[], float]] = None
        if fn is not None:
            self.bind(fn)

    def bind(self, fn: Callable[[], float]) -> "Metric":
        """Attach a zero-arg callback as this (unlabeled) metric's value
        source — the externally-owned-state hook (cache counters, queue
        depth). Rebinding replaces the callback (the latest owner wins;
        metrics objects are per-service by contract). -> self."""
        if self.label_names:
            raise ValueError(
                f"{self.name} is labeled; bind() supports unlabeled "
                "metrics only (labeled values must be stored)")
        self._fn = fn
        return self

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)

    def value(self, **labels) -> float:
        """Current value for one labelset (callback-backed metrics read
        their callback); 0.0 before any write."""
        if self._fn is not None:
            return float(self._fn())
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> list[tuple[str, tuple, float]]:
        """-> ``[(name_suffix, ((label, value), ...), sample_value)]`` —
        everything the renderers need, sorted by labelset."""
        if self._fn is not None:
            return [("", (), float(self._fn()))]
        if not self.label_names:
            return [("", (), self._values.get((), 0.0))]
        return [("", tuple(zip(self.label_names, key)), v)
                for key, v in sorted(self._values.items())]


class Counter(Metric):
    """Monotonically increasing count. Name MUST end in ``_total`` (the
    Prometheus counter convention, enforced at registration so the
    exposition lint never sees a violation)."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = (),
                 fn: Optional[Callable[[], float]] = None):
        """See :class:`Metric`; additionally enforces the ``_total``
        suffix."""
        if not name.endswith("_total"):
            raise ValueError(
                f"counter {name!r} must end in '_total' (Prometheus "
                "counter naming convention)")
        super().__init__(name, help, label_names, fn)

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (>= 0) to the counter for this labelset."""
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc by {amount})")
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(Metric):
    """A value that goes up and down (queue depth, hit ratio, bytes)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        """Set the gauge for this labelset."""
        self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (may be negative) to the gauge."""
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        """Subtract ``amount`` from the gauge."""
        self.inc(-amount, **labels)


class Histogram(Metric):
    """Cumulative-bucket histogram (unlabeled).

    ``observe(v)`` lands in every bucket with ``le >= v`` (rendered
    cumulatively, ``+Inf`` bucket included, as the format requires) plus
    ``_sum`` / ``_count``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        """``buckets``: finite upper bounds, any order; sorted here and
        implicitly completed with ``+Inf``."""
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError(
                f"histogram {name} needs >= 1 finite bucket bound "
                "(+Inf is implicit)")
        self.buckets = tuple(bs)
        self._counts = [0] * (len(bs) + 1)     # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        """Record one observation."""
        v = float(value)
        self._sum += v
        self._count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def value(self, **labels) -> float:
        """The observation count (the scalar a dashboard sanity-checks)."""
        return float(self._count)

    def samples(self) -> list[tuple[str, tuple, float]]:
        """Cumulative ``_bucket`` samples (``le`` labels, ``+Inf`` last),
        then ``_sum`` and ``_count``."""
        out = []
        acc = 0
        for b, c in zip(self.buckets, self._counts):
            acc += c
            out.append(("_bucket", (("le", _format_value(b)),), float(acc)))
        acc += self._counts[-1]
        out.append(("_bucket", (("le", "+Inf"),), float(acc)))
        out.append(("_sum", (), self._sum))
        out.append(("_count", (), float(self._count)))
        return out


class Summary(Metric):
    """Quantile summary rendered from an external reservoir (unlabeled).

    ``stats`` is any object shaped like
    :class:`repro_torch.serving.metrics.LatencyStats`: cumulative ``count`` and
    ``total_s`` attributes plus ``percentile(pct)`` (pct in 0..100). The
    summary stores nothing itself — it renders the reservoir's current
    state, so the serving layer's existing latency reservoirs export
    without duplicating samples.
    """

    kind = "summary"

    def __init__(self, name: str, help: str, stats,
                 quantiles: Sequence[float] = (0.5, 0.95, 0.99)):
        """``quantiles``: fractions in (0, 1) rendered as ``quantile=``
        samples."""
        super().__init__(name, help)
        for q in quantiles:
            if not 0.0 < q < 1.0:
                raise ValueError(f"quantile {q} outside (0, 1)")
        self.stats = stats
        self.quantiles = tuple(quantiles)

    def value(self, **labels) -> float:
        """The reservoir's cumulative observation count."""
        return float(self.stats.count)

    def samples(self) -> list[tuple[str, tuple, float]]:
        """``quantile=`` samples from the reservoir, then ``_sum`` (the
        cumulative total) and ``_count``."""
        out = [("", (("quantile", repr(q)),),
                float(self.stats.percentile(q * 100.0)))
               for q in self.quantiles]
        out.append(("_sum", (), float(self.stats.total_s)))
        out.append(("_count", (), float(self.stats.count)))
        return out


class MetricsRegistry:
    """Named instruments + the two renderers (Prometheus text, JSON).

    Registration is **get-or-create**: asking for an existing name
    returns the existing instrument (kind and labels must match — a
    clash raises instead of silently splitting a metric), so independent
    subsystems can share one registry without coordinating init order.
    """

    def __init__(self):
        """An empty registry."""
        self._metrics: dict[str, Metric] = {}

    def _get_or_create(self, cls, name, args, kwargs):
        existing = self._metrics.get(name)
        if existing is not None:
            if type(existing) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(existing).__name__}, requested {cls.__name__}")
            want = tuple(kwargs.get("label_names", ()))
            if existing.label_names != want:
                raise ValueError(
                    f"metric {name!r} already registered with labels "
                    f"{existing.label_names}, requested {want}")
            return existing
        m = cls(name, *args, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str,
                label_names: Sequence[str] = (),
                fn: Optional[Callable[[], float]] = None) -> Counter:
        """Get-or-create a :class:`Counter`."""
        return self._get_or_create(Counter, name, (help,),
                                   {"label_names": label_names, "fn": fn})

    def gauge(self, name: str, help: str,
              label_names: Sequence[str] = (),
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        """Get-or-create a :class:`Gauge`."""
        return self._get_or_create(Gauge, name, (help,),
                                   {"label_names": label_names, "fn": fn})

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        """Get-or-create a :class:`Histogram`."""
        return self._get_or_create(Histogram, name, (help,),
                                   {"buckets": buckets})

    def summary(self, name: str, help: str, stats,
                quantiles: Sequence[float] = (0.5, 0.95, 0.99)) -> Summary:
        """Get-or-create a :class:`Summary` over ``stats`` (a
        LatencyStats-shaped reservoir)."""
        return self._get_or_create(Summary, name, (help, stats),
                                   {"quantiles": quantiles})

    def get(self, name: str) -> Optional[Metric]:
        """The registered instrument, or None."""
        return self._metrics.get(name)

    def metrics(self) -> list[Metric]:
        """Every registered instrument, sorted by name."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def exposition(self) -> str:
        """Render every instrument in the Prometheus text exposition
        format: per metric a ``# HELP`` line, a ``# TYPE`` line, then its
        samples; ends with a newline as the format requires.
        ``scripts/check_metrics_exposition.py`` validates this output in
        CI against a live service."""
        lines = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for suffix, labelpairs, value in m.samples():
                if labelpairs:
                    body = ",".join(
                        f'{k}="{_escape_label_value(str(v))}"'
                        for k, v in labelpairs)
                    label_str = "{" + body + "}"
                else:
                    label_str = ""
                lines.append(
                    f"{m.name}{suffix}{label_str} {_format_value(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """A JSON-able dict per instrument: scalar values for unlabeled
        counters/gauges, ``{label_repr: value}`` for labeled ones,
        count/sum (+ buckets) for histograms and summaries."""
        out: dict = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                out[m.name] = {
                    "count": m._count, "sum": m._sum,
                    "buckets": {_format_value(b): c for b, c in
                                zip(m.buckets, m._counts)},
                }
            elif isinstance(m, Summary):
                out[m.name] = {"count": float(m.stats.count),
                               "sum": float(m.stats.total_s)}
            elif m.label_names:
                out[m.name] = {
                    ",".join(f"{k}={v}" for k, v in labelpairs): value
                    for _, labelpairs, value in m.samples()}
            else:
                out[m.name] = m.value()
        return out
