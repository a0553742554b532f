"""`RetrievalService` — the serving façade over a timeline of generations
(counterpart of ``repro/serving/service.py``).

Turns the one-shot :func:`repro_torch.core.engine.retrieve_timeline` into a
service loop:

* queries arrive one at a time (``submit``/``flush``/``poll``, micro-
  batched by ``repro_torch.serving.batcher``) or as ready-made batches
  (``query``);
* per generation, the batch splits into a **cache-hit lane** (partials
  served from ``repro_torch.serving.cache``, host memory, no compute) and
  a **cache-miss lane** (partials computed by the generation's execution
  plan — the engine on the timeline's device by default, or any plan a
  ``plan_factory`` builds), so the expensive candidate-generation phases
  run for misses only;
* the per-generation partials merge through the same
  :func:`repro_torch.core.engine.merge_partial_topk` the uncached path
  uses — and, when drift-triggered re-epoching has opened codebook epochs
  (``repro_torch.serving.maintenance``), per-epoch results merge by RANK
  through :func:`repro_torch.core.engine.merge_partial_topk_by_rank`,
  exactly as ``retrieve_timeline`` does.

The service runs where its timeline lives: queries are numpy on the host,
the miss lane's batch goes to the timeline's device, and its partials come
back to the host (the copy waits for the device). Like every entry point
of the port it refuses to fall back to the CPU: a CPU timeline needs
``device="cpu"``.

The contract (tests/test_torch_serving.py): ``RetrievalService(timeline,
cfg).query(q) == retrieve_timeline(timeline, q, cfg)`` — ids AND score
bits — cold and warm, across both candidate modes, both megakernels,
masked/pruned queries, and across ``add_passages``/``new_generation``
mutations. It holds because (a) an immutable generation's partial is a
pure function of (query bytes, generation fingerprint, config), (b) the
engine is bit-invariant to batch composition (a miss-lane sub-batch
scores a query exactly as the full batch does), and (c) cached and fresh
partials merge through one shared merge definition.

Mutations are functional, like the store they wrap: ``add_passages`` grows
the NEWEST generation (new fingerprint -> its never-cached partials are
recomputed; older generations keep their cache entries), and
``new_generation`` freezes the current newest — whose partials become
cacheable from the next query on — and opens a fresh one.

**Hot swap (double-buffered).** ``update_timeline`` builds the new
snapshot's per-generation plans FIRST, while the current snapshot keeps
serving, then swaps one reference atomically. If queries are pending in
the micro-batcher the swap is STAGED and applied when the batcher drains
(end of the next ``flush``): a submitted query is always answered against
the snapshot it was accepted under. Maintenance (compaction /
re-epoching, ``repro_torch.serving.maintenance``) rides this path: merged or
re-epoched generations carry new content fingerprints and recompute,
untouched generations keep their fingerprints AND their warm cache
entries across the swap — invalidation by construction, no flush.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core import bitvector, store
from ..core.engine import (EngineConfig, QueryBatch, RetrievalResult,
                           merge_partial_topk, merge_partial_topk_by_rank,
                           retrieve_generation_topk)
from ..core.store import EpochedTimeline, ShardedTimeline
from ..device import resolve_on
from ..obs import trace

from .batcher import MicroBatcher, Ticket, pad_query
from .cache import ResultCache, config_fingerprint, query_fingerprint
from .metrics import ServiceMetrics

# A generation's execution plan: (queries (B, n_q, d), q_masks (B, n_q)) ->
# partial top-k with doc ids GLOBAL within its epoch. A PlanFactory builds
# one per generation for a given (one-epoch) timeline; the service invokes
# it once per epoch, so factories written for plain timelines keep working.
# Filtered queries call the plan with a THIRD positional argument (the
# compiled FilterPlan); plans that predate filtering keep working for
# unfiltered traffic (the service only passes the third argument when a
# filter is set — a 2-arg plan receiving a filtered query fails with a
# plain TypeError, the honest signal that the plan can't filter).
Plan = Callable[[torch.Tensor, torch.Tensor], RetrievalResult]
PlanFactory = Callable[[ShardedTimeline], "list[Plan]"]

Timeline = Union[ShardedTimeline, EpochedTimeline]


class RetrievalService:
    """Cached, micro-batched retrieval over an immutable-generation timeline.

    One instance owns a timeline snapshot, a result cache, a micro-batcher
    and its metrics. Single-threaded by design: deadlines are enforced
    cooperatively through ``poll()`` (docs/SERVING.md discusses why that is
    the right shape for a kernel-dispatch loop), and the staged timeline swap
    relies on the same discipline — "atomically between flushes" means no
    batch is ever computed against a half-installed snapshot.
    """

    def __init__(self, timeline: Timeline,
                 cfg: Optional[EngineConfig] = None, *,
                 cache: Optional[ResultCache] = None,
                 metrics: Optional[ServiceMetrics] = None,
                 max_batch: int = 16, max_delay_s: float = 0.002,
                 plan_factory: Optional[PlanFactory] = None,
                 pad_miss_lane: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        """Build a service over ``timeline`` (a ``ShardedTimeline`` or an
        ``EpochedTimeline``).

        cfg           : retrieval configuration (default ``EngineConfig()``);
                        hashed into every cache key.
        cache         : injectable :class:`ResultCache` (fresh 64 MiB LRU by
                        default). Share one across services ONLY if they use
                        the same cfg AND execution plan.
        metrics       : injectable :class:`ServiceMetrics`.
        max_batch     : micro-batch size trigger.
        max_delay_s   : micro-batch deadline trigger (from the oldest
                        pending submit).
        plan_factory  : one-epoch timeline -> per-generation execution
                        plans; defaults to the engine on the timeline's
                        device (:func:`~repro_torch.core.engine.
                        retrieve_generation_topk` per generation). Invoked
                        once per epoch on every swap.
        pad_miss_lane : pad the miss lane to the full batch size (repeating
                        its first row) so every flush runs ONE batch shape
                        per generation config, whatever the miss count.
                        Compute cost is the cold path's either way.
        clock         : injectable monotonic clock (deadlines + latency).
        device        : where the timeline lives and the miss lanes run:
                        CUDA unless ``"cpu"`` is asked for; a timeline on
                        another device raises.
        """
        first = EpochedTimeline.of(timeline).epochs[0].generations[0]
        self.device = resolve_on(first.device, device)
        self.cfg = cfg if cfg is not None else EngineConfig()
        self.cache = cache if cache is not None else ResultCache()
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.pad_miss_lane = pad_miss_lane
        self.clock = clock
        # overwritten at every install with the snapshot's document budget
        # folded in (see _install); pre-set so a failed first _prepare
        # leaves a coherent object
        self._doc_budget = None
        self._cfg_fp = config_fingerprint(self.cfg)
        # per-filter config fingerprints, memoized by compiled plan: the
        # filter is config as far as the result cache is concerned, so a
        # filtered partial NEVER collides with an unfiltered one (or with a
        # different filter's) for the same (query, generation) pair
        self._filter_cfg_fps: dict = {}
        self._batcher = MicroBatcher(self.cfg.n_q, max_batch, max_delay_s,
                                     clock=clock)
        # queue depth + deadline misses render from the live batcher at
        # snapshot/exposition time (no hot-path mirroring)
        self.metrics.bind_batcher(self._batcher)
        self._plan_factory = plan_factory
        # generation fingerprints already computed (see _fingerprints)
        self._hashed: dict = {}
        self._staged: Optional[tuple] = None
        self._staged_at: Optional[float] = None   # for the deferred-wait span
        self.update_timeline(timeline)

    # -- timeline lifecycle -------------------------------------------------

    @property
    def timeline(self) -> Timeline:
        """The snapshot currently being served: the plain
        ``ShardedTimeline`` while the service has a single codebook epoch
        (the common case), the full ``EpochedTimeline`` once re-epoching
        has opened more."""
        if len(self._epoched) == 1:
            return self._epoched.epochs[0]
        return self._epoched

    @property
    def epoched(self) -> EpochedTimeline:
        """The snapshot currently being served, always epoch-shaped."""
        return self._epoched

    @property
    def latest_timeline(self) -> EpochedTimeline:
        """The newest accepted snapshot: the STAGED one when a swap is
        waiting for pending queries to drain, else the serving snapshot.
        Mutations (and the maintenance loop) must compose on this — basing
        a new snapshot on the serving one while another is staged would
        silently drop the staged changes."""
        return self._staged[0] if self._staged is not None else self._epoched

    def update_timeline(self, timeline: Timeline) -> None:
        """Swap in a new timeline snapshot — double-buffered.

        The expensive half (per-generation plan builds, fingerprints) runs
        first, against the NEW snapshot, while the current one keeps
        serving; the swap itself is an atomic reference switch. With
        queries pending in the micro-batcher the prepared snapshot is
        STAGED instead and installed when the batcher drains (end of the
        next ``flush``/``poll``/``query``), so a submitted query is always
        answered against the snapshot it was accepted under. Staging twice
        before a flush keeps the LATEST snapshot only.

        No cache flush, ever: entries key on generation CONTENT
        fingerprints, so unchanged generations keep serving from cache and
        changed ones (grown / merged / re-epoched -> new fingerprint)
        recompute — invalidation by construction.
        """
        with trace.span("service.swap.prepare"):
            staged = self._prepare(timeline)
        if len(self._batcher) == 0:
            self._install(staged)
        else:
            self._staged = staged
            self._staged_at = self.clock()

    def _prepare(self, timeline: Timeline) -> tuple:
        """Build everything a swap needs, off the serving path."""
        epoched = EpochedTimeline.of(timeline)
        resolve_on(epoched.epochs[0].generations[0].device, self.device)
        plans, fps = [], []
        for tl, _ in epoched:
            if self._plan_factory is not None:
                eplans = list(self._plan_factory(tl))
            else:
                eplans = [
                    lambda q, m, f=None, _g=gen, _m=meta, _o=off:
                        retrieve_generation_topk(_g, _m, _o, q, self.cfg, m,
                                                 doc_filter=f,
                                                 device=self.device)
                    for gen, meta, off in tl]
            if len(eplans) != len(tl):
                raise ValueError(
                    f"plan_factory built {len(eplans)} plan(s) for a "
                    f"{len(tl)}-generation epoch")
            plans.append(eplans)
            fps.append(self._fingerprints(tl))
        # the snapshot's document-budget signature: None for an all-
        # per-token timeline (config fingerprints stay pre-budget-exact),
        # the budget for one epoch, per-epoch budgets once re-epoching
        # has mixed regimes
        budgets = tuple(tl.metas[0].doc_budget for tl, _ in epoched)
        if all(b is None for b in budgets):
            budget_sig = None
        else:
            budget_sig = budgets[0] if len(budgets) == 1 else budgets
        return (epoched, plans, fps, list(epoched.epoch_offsets),
                budget_sig)

    def _fingerprints(self, tl: ShardedTimeline) -> tuple:
        """``tl.fingerprints``, hashing only generations this service has
        not hashed: a swap, merge or re-epoch keeps most generations, and
        hashing an 8.8M-doc base again copies its 19 GB to the host. A
        generation is known by the ids of its tensors, held weakly, and
        their version counters (a tensor changed in place is hashed
        anew). Fingerprints the timeline object already holds are taken as
        they are."""
        known = tl.__dict__.get("fingerprints")
        out = []
        for i, g in enumerate(tl.generations):
            key = tuple(id(t) for t in g)
            versions = tuple(t._version for t in g)
            hit = self._hashed.get(key)
            if hit is None or hit[1] != versions or any(
                    ref() is not t for ref, t in zip(hit[0], g)):
                hit = (tuple(weakref.ref(t) for t in g), versions,
                       store.index_fingerprint(g) if known is None
                       else known[i])
                self._hashed[key] = hit
            out.append(hit[2])
        for key in [k for k, (refs, _, _) in self._hashed.items()
                    if any(ref() is None for ref in refs)]:
            del self._hashed[key]
        tl.__dict__["fingerprints"] = tuple(out)
        return tl.fingerprints

    def _install(self, staged: tuple) -> None:
        """Atomically switch the serving snapshot to a prepared one."""
        swap = hasattr(self, "_epoched")        # constructor install is free
        deferred = self._staged is not None
        if deferred and self._staged_at is not None:
            # how long the prepared snapshot sat behind pending queries
            trace.record("service.swap.deferred_wait",
                         self.clock() - self._staged_at)
        self._staged = None
        self._staged_at = None
        with trace.span("service.swap.install", deferred=deferred):
            (self._epoched, self._plans, self._gen_fps, self._epoch_offsets,
             budget_sig) = staged
            if budget_sig != self._doc_budget or not swap:
                # the budget joins every cache key: pooled and unpooled
                # partials must never collide even when their generation
                # fingerprints coincide (all docs under budget)
                self._doc_budget = budget_sig
                self._cfg_fp = config_fingerprint(self.cfg,
                                                  doc_budget=budget_sig)
                self._filter_cfg_fps = {}
            # only the open generation (last of the live epoch) is mutable
            self._n_cacheable = sum(len(p) for p in self._plans) - 1
        if swap:
            self.metrics.record_swap(deferred=deferred)

    def _maybe_install(self) -> None:
        """Install a staged snapshot once no query is pending against the
        old one — the flush-boundary half of the double buffer."""
        if self._staged is not None and len(self._batcher) == 0:
            self._install(self._staged)

    def add_passages(self, doc_embs: np.ndarray,
                     doc_lens: np.ndarray) -> None:
        """Grow the NEWEST (still-mutable) generation with new passages.

        The grown generation's content fingerprint changes, so its (never
        cached) partials are recomputed with the new docs visible on the
        very next query; older generations' cache entries stay live.
        """
        et = self.latest_timeline
        tl = et.epochs[-1]
        grown, gmeta = store.add_passages(
            tl.generations[-1], tl.metas[-1], doc_embs, doc_lens,
            device=self.device)
        self.update_timeline(
            et.with_newest_epoch(tl.with_newest(grown, gmeta)))

    def new_generation(self, doc_embs: np.ndarray,
                       doc_lens: np.ndarray) -> None:
        """Freeze the current newest generation and open a fresh one
        (quantized against the LIVE epoch's codebooks).

        From the next query on, the previously-newest generation is
        immutable and therefore CACHEABLE: its partials start populating
        the cache (first lookup per query misses, later ones hit).
        """
        et = self.latest_timeline
        tl = et.epochs[-1]
        gen, meta = store.new_generation(
            tl.generations[0], tl.metas[0], doc_embs, doc_lens,
            device=self.device)
        self.update_timeline(et.with_newest_epoch(tl.append(gen, meta)))

    # -- query paths --------------------------------------------------------

    def _resolve_filter(self, doc_filter):
        """Normalize a per-query filter to a compiled ``FilterPlan``.

        Accepts ``None`` (unfiltered), an already-compiled ``FilterPlan``
        (validated downstream against each generation's predicate names),
        or a ``FilterExpr`` — compiled here against the SERVING snapshot's
        predicate vocabulary (every generation in a timeline shares one;
        ``ShardedTimeline`` enforces it), so callers can hand the service
        expressions without knowing bit positions."""
        if doc_filter is None or isinstance(doc_filter, bitvector.FilterPlan):
            return doc_filter
        names = self._epoched.epochs[0].metas[0].pred_names
        return bitvector.compile_filter(doc_filter, names)

    def _cfg_fp_for(self, doc_filter) -> str:
        """The config fingerprint for cache keys: the base config's when
        unfiltered, a per-filter one (memoized) when filtered."""
        if doc_filter is None:
            return self._cfg_fp
        fp = self._filter_cfg_fps.get(doc_filter)
        if fp is None:
            fp = config_fingerprint(
                dataclasses.replace(self.cfg, doc_filter=doc_filter),
                doc_budget=self._doc_budget)
            self._filter_cfg_fps[doc_filter] = fp
        return fp

    def query(self, queries, q_masks=None, *,
              doc_filter=None) -> RetrievalResult:
        """Retrieve a ready-made batch, bypassing the micro-batcher.

        queries : (B, t, d) with t <= cfg.n_q (zero-padded up to n_q here),
                  or a :class:`~repro_torch.core.engine.QueryBatch`
                  carrying the mask itself
        q_masks : optional (B, t) bool per-term masks (True = live)
        doc_filter : optional predicate filter applied to the whole batch —
                  a ``bitvector.FilterExpr`` (compiled here against the
                  timeline's predicate names) or a pre-compiled
                  ``FilterPlan``
        -> RetrievalResult (scores (B, k), global doc ids (B, k)) on the
        service's device — bit-exact to ``retrieve_timeline(timeline,
        queries, cfg, q_masks, doc_filter=doc_filter)``.
        """
        self._maybe_install()
        if isinstance(queries, QueryBatch):
            if q_masks is not None and queries.q_mask is not None:
                raise ValueError(
                    "got a q_mask both inside the QueryBatch and as a "
                    "separate argument — pass exactly one")
            queries, q_masks = queries.q, \
                queries.q_mask if q_masks is None else q_masks
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 3:
            raise ValueError(f"queries have shape {q.shape}: expected "
                             "(batch, terms, d)")
        if q.shape[0] == 0:
            raise ValueError(
                "empty query batch (B=0): query() needs at least one "
                "query — guard the caller, or use submit()/flush() for "
                "streams that may be idle")
        padded, masks = [], []
        for i in range(q.shape[0]):
            pq, pm = pad_query(q[i], self.cfg.n_q,
                               None if q_masks is None
                               else np.asarray(q_masks)[i])
            padded.append(pq)
            masks.append(pm)
        return self._execute(np.stack(padded), np.stack(masks),
                             doc_filter=self._resolve_filter(doc_filter))

    def submit(self, query: np.ndarray,
               q_mask: Optional[np.ndarray] = None, *,
               doc_filter=None) -> Ticket:
        """Enqueue one (t, d) query; flushes immediately when the batch
        fills to ``max_batch``. -> a :class:`Ticket` (``result()`` after
        the flush that computes it). ``doc_filter`` (FilterExpr or compiled
        FilterPlan) is resolved NOW — compile errors surface at submit, not
        at flush — and batches only with same-filter neighbors (see
        ``MicroBatcher.drain``)."""
        ticket = self._batcher.submit(query, q_mask,
                                      self._resolve_filter(doc_filter))
        if len(self._batcher) >= self._batcher.max_batch:
            self.flush()
        return ticket

    def flush(self) -> None:
        """Execute ALL pending micro-batches now, filling their tickets;
        then install any staged timeline swap (the batcher is empty — the
        double buffer's safe point)."""
        while True:
            drained = self._batcher.drain()
            if drained is None:
                self._maybe_install()
                return
            qb, tickets, doc_filter = drained
            with trace.span("service.flush", batch=len(tickets)):
                res = self._execute(qb.q, qb.q_mask, doc_filter=doc_filter)
                scores = res.scores.cpu().numpy()
                ids = res.doc_ids.cpu().numpy()
                for j, t in enumerate(tickets):
                    t._fill(scores[j], ids[j])

    def poll(self) -> None:
        """Flush iff a pending batch is due (full or past its deadline) —
        the cooperative deadline hook; call it from the serving loop."""
        if self._batcher.due():
            self.flush()
        else:
            self._maybe_install()

    def stats(self) -> dict:
        """Metrics snapshot: traffic + latency + maintenance counters +
        cache bytes + timeline footprint (one dict; see
        ``repro_torch.serving.metrics``)."""
        return self.metrics.snapshot(
            cache=self.cache,
            timeline_footprint=store.timeline_footprint(self.timeline))

    def exposition(self) -> str:
        """The same telemetry as ``stats()`` rendered as Prometheus text
        exposition (cache counters and timeline byte gauges folded in;
        docs/OBSERVABILITY.md documents the metric names,
        scripts/check_metrics_exposition.py lints the format)."""
        return self.metrics.exposition(
            cache=self.cache,
            timeline_footprint=store.timeline_footprint(self.timeline))

    # -- the hit/miss lane split --------------------------------------------

    def _execute(self, q: np.ndarray, masks: np.ndarray, *,
                 doc_filter=None) -> RetrievalResult:
        """Run one dense batch through the per-generation lanes, merge by
        score within each epoch and by rank across epochs. ``doc_filter``
        (a compiled FilterPlan, already resolved) applies to the whole
        batch: it joins the cache key through the config fingerprint and
        rides to every miss-lane plan as the third positional argument."""
        t0 = self.clock()
        dev = self.device
        n = q.shape[0]
        if n == 0:
            raise ValueError(
                "empty query batch (B=0): nothing to retrieve (the "
                "micro-batcher never drains an empty batch; direct "
                "callers must pass >= 1 query)")
        cfg_fp = self._cfg_fp_for(doc_filter)
        qfps = [query_fingerprint(q[i], masks[i]) for i in range(n)]
        warm = np.full(n, self._n_cacheable > 0)
        n_epochs = len(self._plans)
        epoch_parts = []
        with trace.span("service.execute", batch=n, epochs=n_epochs,
                        filtered=doc_filter is not None):
            for e, (plans, fps, eoff) in enumerate(
                    zip(self._plans, self._gen_fps, self._epoch_offsets)):
                parts = []
                for g, plan in enumerate(plans):
                    # only the live epoch's newest gen is still mutable
                    cacheable = e < n_epochs - 1 or g < len(plans) - 1
                    gen_fp = fps[g]
                    with trace.span("service.generation", epoch=e,
                                    generation=g) as gsp:
                        rows: list = [None] * n
                        miss = []
                        with trace.span("service.cache_lookup",
                                        cacheable=cacheable):
                            for i in range(n):
                                hit = self.cache.get(
                                    (qfps[i], gen_fp, cfg_fp)) \
                                    if cacheable else None
                                if hit is None:
                                    miss.append(i)
                                else:
                                    rows[i] = hit
                        gsp.set(hits=n - len(miss), misses=len(miss))
                        if cacheable:
                            self.metrics.record_generation_lookups(
                                gen_fp, n - len(miss), len(miss))
                        if miss:
                            if cacheable:
                                warm[miss] = False
                            mq, mm = q[miss], masks[miss]
                            padded = self.pad_miss_lane and len(miss) < n
                            if padded:
                                # repeat row 0: 1 compiled shape per cfg
                                pad = n - len(miss)
                                mq = np.concatenate(
                                    [mq, np.repeat(mq[:1], pad, axis=0)])
                                mm = np.concatenate(
                                    [mm, np.repeat(mm[:1], pad, axis=0)])
                            with trace.span("service.miss_execute",
                                            misses=len(miss),
                                            padded=padded):
                                args = (torch.from_numpy(mq).to(dev),
                                        torch.from_numpy(mm).to(dev))
                                if doc_filter is not None:
                                    args += (doc_filter,)
                                res = plan(*args)
                                # the copy to the host waits for the
                                # device, so the span times its work
                                ms = res.scores[:len(miss)].cpu().numpy()
                                # epoch-local -> global ids BEFORE caching,
                                # so cached and fresh partials merge
                                # identically (epoch offsets are stable:
                                # compaction and re-epoching both preserve
                                # every surviving doc's global id)
                                mi = res.doc_ids[:len(miss)].cpu().numpy() \
                                    + np.int32(eoff)
                            for j, i in enumerate(miss):
                                rows[i] = (ms[j], mi[j])
                                if cacheable:
                                    self.cache.put(
                                        (qfps[i], gen_fp, cfg_fp),
                                        ms[j], mi[j])
                    parts.append(RetrievalResult(
                        torch.from_numpy(np.stack([r[0] for r in rows]))
                        .to(dev),
                        torch.from_numpy(np.stack([r[1] for r in rows]))
                        .to(dev)))
                with trace.span("service.merge", epoch=e,
                                generations=len(parts)):
                    epoch_parts.append(merge_partial_topk(
                        parts, self.cfg.k, device=dev))
            with trace.span("service.merge", epochs=n_epochs, final=True):
                merged = epoch_parts[0] if n_epochs == 1 else \
                    merge_partial_topk_by_rank(epoch_parts, self.cfg.k,
                                               device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self.metrics.record_batch(n, int(warm.sum()), self.clock() - t0,
                                  n_filtered=0 if doc_filter is None else n)
        return merged
