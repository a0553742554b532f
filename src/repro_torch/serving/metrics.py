"""Serving telemetry: warm/cold traffic split, latency percentiles, and the
byte accounting (cache occupancy + timeline footprint) in one snapshot
(counterpart of ``repro/serving/metrics.py``, same metric names).

A query is **warm** when every cacheable (immutable) generation's partial
was a cache hit — only the newest, still-mutable generation was computed —
and **cold** otherwise. The split is the cache's effectiveness measured in
requests rather than lookups: a Zipf-repeated stream should go warm almost
immediately, while a
stream of distinct queries stays cold no matter how large the cache.

Latency is recorded per flushed batch into bounded reservoirs
(:class:`LatencyStats`), reported as p50/p95/p99/max — the numbers a
capacity plan actually budgets against, not means. The snapshot also folds
in ``repro_torch.core.store.timeline_footprint`` (per-generation bytes +
manifest overhead) next to the cache's byte occupancy, so one dict
answers "what does this service cost in memory and what latency does it
buy".

:class:`ServiceMetrics` is built on the instrument registry
(:class:`repro_torch.obs.registry.MetricsRegistry`): every counter is a
registered ``Counter``, the reservoirs export as
``Summary`` quantiles, and subsystems ADD instruments by registering them
instead of editing ``snapshot()``. Two renderings of the same registry:
``snapshot()`` keeps the historical JSON dict shape (tests pin it), and
``exposition()`` renders the Prometheus text format that
``scripts/check_metrics_exposition.py`` lints in CI. The historical
attribute reads (``metrics.warm_queries`` etc.) survive as read-only
properties over the registered counters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..obs.registry import MetricsRegistry

# timeline-footprint keys every producer must supply (the core byte
# accounting repro_torch.core.store.timeline_footprint emits) …
REQUIRED_FOOTPRINT_KEYS = (
    "n_generations", "n_docs", "n_tokens", "index_bytes", "manifest_bytes",
    "total_bytes", "predicate_bytes", "bytes_per_embedding",
    "bytes_per_embedding_actual")
# … and the genuinely optional ones, passed through when present:
# pooling accounting exists only for producers aware of document budgets,
# n_epochs only for epoched timelines.
OPTIONAL_FOOTPRINT_KEYS = (
    "n_raw_tokens", "doc_budget", "bytes_per_doc", "unpooled_bytes_per_doc",
    "pooling_savings", "n_epochs")


class LatencyStats:
    """Bounded-reservoir latency recorder with percentile readout.

    Keeps the most recent ``window`` samples (a ring buffer): long-running
    services would otherwise grow an unbounded sample list, and recent
    samples are the ones a serving dashboard wants anyway. ``count`` and
    ``total_s`` stay cumulative over ALL samples.

    **Ring-wrap semantics** (tests/test_torch_serving.py pins them): the
    write cursor wraps at ``window``, overwriting oldest-first, so once
    ``count > window`` the buffer holds exactly the most recent ``window``
    samples — in scrambled storage order, which percentiles and max are
    insensitive to. ``percentile``/``max`` therefore read
    ``samples[:min(count, window)]``: the filled prefix before the first
    wrap, the entire ring after it. Quantiles computed this way are over a
    sliding window, not all history — by design (``mean_ms`` is the one
    all-history statistic, from the cumulative ``total_s``).
    """

    def __init__(self, window: int = 4096):
        """``window``: number of most-recent samples percentiles see."""
        self._window = int(window)
        self._samples = np.zeros(self._window, dtype=np.float64)
        self._next = 0
        self.count = 0
        self.total_s = 0.0

    def record(self, seconds: float) -> None:
        """Record one latency sample (seconds)."""
        self._samples[self._next] = seconds
        self._next = (self._next + 1) % self._window
        self.count += 1
        self.total_s += seconds

    def percentile(self, pct: float) -> float:
        """The ``pct``-th percentile (seconds) over the most recent
        ``min(count, window)`` samples; 0.0 before the first sample."""
        n = min(self.count, self._window)
        if n == 0:
            return 0.0
        return float(np.percentile(self._samples[:n], pct))

    def max(self) -> float:
        """The maximum (seconds) over the same window ``percentile``
        sees; 0.0 before the first sample."""
        n = min(self.count, self._window)
        if n == 0:
            return 0.0
        return float(np.max(self._samples[:n]))

    def snapshot(self) -> dict:
        """count / mean / p50 / p95 / p99 / max, milliseconds for the
        readable fields (mean over ALL samples, quantiles+max over the
        window)."""
        return {
            "count": self.count,
            "mean_ms": (self.total_s / self.count * 1e3) if self.count
            else 0.0,
            "p50_ms": self.percentile(50) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "max_ms": self.max() * 1e3,
        }


class ServiceMetrics:
    """Registry-backed counters + latency reservoirs for one
    :class:`~repro_torch.serving.service.RetrievalService`.

    ``record_batch`` is the single ingestion point: the service calls it
    once per executed batch with the warm/cold split it just observed.
    ``snapshot`` folds in the cache's counters and the timeline's footprint
    so callers get the whole picture from one dict; ``exposition`` renders
    the same registry as Prometheus text. Historical counter attributes
    (``batches``, ``warm_queries``, ``swaps``, …) are read-only properties
    over the registered instruments — mutate through the ``record_*``
    verbs, never by assignment.
    """

    def __init__(self, window: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        """``window`` sizes every latency reservoir (see LatencyStats);
        ``registry`` lets services share one exposition endpoint
        (instruments are get-or-create, so two ServiceMetrics sharing a
        registry also share counters — usually you want one each)."""
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self._c_batches = r.counter(
            "emvb_batches_total", "Micro-batches executed")
        self._c_queries = r.counter(
            "emvb_queries_total", "Queries served")
        self._c_warm = r.counter(
            "emvb_warm_queries_total",
            "Queries whose cacheable partials all cache-hit")
        self._c_cold = r.counter(
            "emvb_cold_queries_total",
            "Queries that computed at least one cacheable partial")
        # predicate-filtered vs unfiltered traffic (docs/FILTERING.md):
        # filtered queries hit a different cache-key space (the filter
        # fingerprint joins the config fingerprint), so their warm share
        # ramps independently — the split makes that visible
        self._c_filtered = r.counter(
            "emvb_filtered_queries_total",
            "Queries served under a predicate filter")
        self._c_unfiltered = r.counter(
            "emvb_unfiltered_queries_total",
            "Queries served without a predicate filter")
        # maintenance counters (docs/MAINTENANCE.md): timeline snapshot
        # swaps (and how many had to wait for a flush boundary), plus the
        # actions the maintenance loop applied
        self._c_swaps = r.counter(
            "emvb_timeline_swaps_total", "Timeline snapshot swaps installed")
        self._c_deferred = r.counter(
            "emvb_deferred_swaps_total",
            "Swaps staged behind pending queries, installed at a flush "
            "boundary")
        self._c_merges = r.counter(
            "emvb_maintenance_merges_total",
            "Generation compactions applied")
        self._c_reepochs = r.counter(
            "emvb_maintenance_reepochs_total",
            "Drift-triggered codebook rebuilds applied")
        # serving-lane instruments: the batcher's live queue depth and
        # cumulative deadline misses (bound to the live batcher by
        # RetrievalService via bind_batcher), the per-generation cache hit
        # ratio, and the batch-size histogram
        self._g_queue_depth = r.gauge(
            "emvb_batcher_queue_depth",
            "Queries pending in the micro-batcher")
        self._c_deadline = r.counter(
            "emvb_deadline_misses_total",
            "Queries drained LATER than max_delay_s after submit (the "
            "cooperative poll loop ran behind the deadline promise)")
        self._g_gen_hit_ratio = r.gauge(
            "emvb_generation_cache_hit_ratio",
            "Per-generation result-cache hit ratio (label: generation "
            "content fingerprint, truncated)",
            label_names=("generation",))
        self._h_batch_size = r.histogram(
            "emvb_batch_size", "Executed micro-batch sizes (queries)",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        self.batch_latency = LatencyStats(window)
        self.warm_latency = LatencyStats(window)
        self.cold_latency = LatencyStats(window)
        r.summary("emvb_batch_latency_seconds",
                  "Per-batch wall latency (all batches)",
                  stats=self.batch_latency)
        r.summary("emvb_warm_batch_latency_seconds",
                  "Per-batch wall latency, fully-warm batches",
                  stats=self.warm_latency)
        r.summary("emvb_cold_batch_latency_seconds",
                  "Per-batch wall latency, batches with >= 1 miss",
                  stats=self.cold_latency)
        # per-generation lookup tallies behind the labeled hit-ratio gauge
        self._gen_lookups: dict[str, list] = {}

    # -- historical attribute reads (properties over the registry) ----------

    @property
    def batches(self) -> int:
        """Micro-batches executed."""
        return int(self._c_batches.value())

    @property
    def queries(self) -> int:
        """Queries served."""
        return int(self._c_queries.value())

    @property
    def warm_queries(self) -> int:
        """Queries whose cacheable partials all hit."""
        return int(self._c_warm.value())

    @property
    def cold_queries(self) -> int:
        """Queries that computed at least one cacheable partial."""
        return int(self._c_cold.value())

    @property
    def filtered_queries(self) -> int:
        """Queries served under a predicate filter."""
        return int(self._c_filtered.value())

    @property
    def unfiltered_queries(self) -> int:
        """Queries served without a predicate filter."""
        return int(self._c_unfiltered.value())

    @property
    def swaps(self) -> int:
        """Timeline snapshot swaps installed."""
        return int(self._c_swaps.value())

    @property
    def deferred_swaps(self) -> int:
        """Swaps that waited for a flush boundary."""
        return int(self._c_deferred.value())

    @property
    def merges(self) -> int:
        """Generation compactions applied."""
        return int(self._c_merges.value())

    @property
    def reepochs(self) -> int:
        """Codebook rebuilds applied."""
        return int(self._c_reepochs.value())

    @property
    def deadline_misses(self) -> int:
        """Queries drained later than the deadline promise."""
        return int(self._c_deadline.value())

    # -- ingestion verbs -----------------------------------------------------

    def record_batch(self, n_queries: int, n_warm: int,
                     seconds: float, n_filtered: int = 0) -> None:
        """Record one executed batch: size, how many of its queries were
        warm (all immutable-generation partials cache-hit), wall seconds,
        and how many ran under a predicate filter (a micro-batch is
        homogeneous — all-filtered or all-unfiltered — so ``n_filtered``
        is 0 or ``n_queries`` from the service, but mixed counts are
        accepted for direct callers).

        The batch latency lands in the warm reservoir only when the WHOLE
        batch was warm (mixed batches pay the miss lane's compute, which is
        cold-path latency by any honest accounting).
        """
        self._c_batches.inc()
        self._c_queries.inc(n_queries)
        self._c_warm.inc(n_warm)
        self._c_cold.inc(n_queries - n_warm)
        self._c_filtered.inc(n_filtered)
        self._c_unfiltered.inc(n_queries - n_filtered)
        self._h_batch_size.observe(n_queries)
        self.batch_latency.record(seconds)
        if n_warm == n_queries:
            self.warm_latency.record(seconds)
        else:
            self.cold_latency.record(seconds)

    def record_swap(self, deferred: bool = False) -> None:
        """Record one installed timeline snapshot swap; ``deferred=True``
        when the swap was staged behind pending queries and applied at the
        next flush boundary (the double-buffered hot-swap path)."""
        self._c_swaps.inc()
        if deferred:
            self._c_deferred.inc()

    def record_maintenance(self, kind: str) -> None:
        """Record one applied maintenance action: ``"merge"`` (generation
        compaction) or ``"reepoch"`` (drift-triggered codebook rebuild)."""
        if kind == "merge":
            self._c_merges.inc()
        elif kind == "reepoch":
            self._c_reepochs.inc()
        else:
            raise ValueError(
                f"unknown maintenance action kind {kind!r}: expected "
                "'merge' or 'reepoch'")

    def record_deadline_misses(self, n: int) -> None:
        """Add ``n`` deadline misses (standalone use; a service binds the
        batcher's own cumulative counter instead — ``bind_batcher``)."""
        self._c_deadline.inc(n)

    def set_queue_depth(self, n: int) -> None:
        """Set the batcher queue-depth gauge (standalone use; a service
        binds the live batcher instead — ``bind_batcher``)."""
        self._g_queue_depth.set(n)

    def bind_batcher(self, batcher) -> None:
        """Bind the queue-depth gauge and deadline-miss counter to a live
        :class:`~repro_torch.serving.batcher.MicroBatcher` — values are read
        from the batcher at snapshot/exposition time instead of being
        mirrored on the hot path. Called by ``RetrievalService.__init__``
        (latest binding wins; metrics are per-service by contract)."""
        self._g_queue_depth.bind(lambda: len(batcher))
        self._c_deadline.bind(lambda: batcher.deadline_misses)

    def record_generation_lookups(self, generation_fp: str, hits: int,
                                  misses: int) -> None:
        """Accumulate one batch's cache lookups for one immutable
        generation (keyed by content fingerprint, truncated to 12 hex
        chars for label cardinality) and refresh its hit-ratio gauge."""
        key = generation_fp[:12]
        tally = self._gen_lookups.setdefault(key, [0, 0])
        tally[0] += hits
        tally[1] += misses
        total = tally[0] + tally[1]
        self._g_gen_hit_ratio.set(
            tally[0] / total if total else 0.0, generation=key)

    # -- renderings ----------------------------------------------------------

    def _timeline_section(self, timeline_footprint: dict) -> dict:
        """Validate and trim a footprint dict for the snapshot: the
        required byte-accounting keys must ALL be present (a partial dict
        means the producer is not ``repro_torch.core.store.timeline_footprint``
        and the capacity numbers would silently lie); optional keys pass
        through when present."""
        missing = [k for k in REQUIRED_FOOTPRINT_KEYS
                   if k not in timeline_footprint]
        if missing:
            raise KeyError(
                f"timeline_footprint is missing required keys {missing}: "
                "pass the dict produced by repro_torch.core.store."
                "timeline_footprint(timeline) (generation-level or "
                "hand-built dicts lack the timeline rollup; optional "
                f"keys are {list(OPTIONAL_FOOTPRINT_KEYS)})")
        out = {k: timeline_footprint[k] for k in REQUIRED_FOOTPRINT_KEYS}
        out.update({k: timeline_footprint[k] for k in OPTIONAL_FOOTPRINT_KEYS
                    if k in timeline_footprint})
        return out

    def snapshot(self, cache=None,
                 timeline_footprint: Optional[dict] = None) -> dict:
        """One flat-ish dict: traffic counters, warm share, latency
        percentiles, batcher depth/deadline misses, per-generation cache
        hit ratios, plus ``cache`` stats (a ``ResultCache``) and the
        ``timeline`` footprint when provided (all
        :data:`REQUIRED_FOOTPRINT_KEYS` must be present — missing ones
        raise ``KeyError`` rather than silently dropping byte
        accounting)."""
        queries = self.queries
        out = {
            "batches": self.batches,
            "queries": queries,
            "warm_queries": self.warm_queries,
            "cold_queries": self.cold_queries,
            "warm_fraction": (self.warm_queries / queries
                              if queries else 0.0),
            "filtered_queries": self.filtered_queries,
            "unfiltered_queries": self.unfiltered_queries,
            "latency": self.batch_latency.snapshot(),
            "warm_latency": self.warm_latency.snapshot(),
            "cold_latency": self.cold_latency.snapshot(),
            "maintenance": {
                "swaps": self.swaps,
                "deferred_swaps": self.deferred_swaps,
                "merges": self.merges,
                "reepochs": self.reepochs,
            },
            "batcher": {
                "queue_depth": int(self._g_queue_depth.value()),
                "deadline_misses": self.deadline_misses,
            },
            "generations": {
                fp: {"hits": h, "misses": m,
                     "hit_ratio": h / (h + m) if h + m else 0.0}
                for fp, (h, m) in self._gen_lookups.items()
            },
        }
        if cache is not None:
            out["cache"] = cache.stats()
        if timeline_footprint is not None:
            out["timeline"] = self._timeline_section(timeline_footprint)
        return out

    def exposition(self, cache=None,
                   timeline_footprint: Optional[dict] = None) -> str:
        """The registry rendered as Prometheus text exposition
        (``scripts/check_metrics_exposition.py`` lints the format).

        ``cache`` (a ``ResultCache``) binds its cumulative counters and
        occupancy as callback-backed instruments; ``timeline_footprint``
        (validated like ``snapshot``) sets the timeline byte gauges. Both
        register on first use, so a bare ServiceMetrics exposes only its
        own instruments.
        """
        r = self.registry
        if cache is not None:
            r.counter("emvb_cache_hits_total",
                      "Result-cache hits").bind(lambda: cache.hits)
            r.counter("emvb_cache_misses_total",
                      "Result-cache misses").bind(lambda: cache.misses)
            r.counter("emvb_cache_evictions_total",
                      "Result-cache LRU evictions").bind(
                          lambda: cache.evictions)
            r.gauge("emvb_cache_bytes",
                    "Result-cache occupancy (payload bytes)").bind(
                        lambda: cache.bytes)
            r.gauge("emvb_cache_entries",
                    "Result-cache entries").bind(lambda: len(cache))
        if timeline_footprint is not None:
            fp = self._timeline_section(timeline_footprint)
            r.gauge("emvb_timeline_generations",
                    "Generations in the served timeline").set(
                        fp["n_generations"])
            r.gauge("emvb_timeline_docs",
                    "Documents in the served timeline").set(fp["n_docs"])
            r.gauge("emvb_timeline_total_bytes",
                    "Timeline footprint incl. manifests (bytes)").set(
                        fp["total_bytes"])
            r.gauge("emvb_timeline_bytes_per_embedding",
                    "Nominal bytes per embedding (paper Table 1 "
                    "accounting)").set(fp["bytes_per_embedding"])
        return r.exposition()
