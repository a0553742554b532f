"""Distributed EMVB serving over ``torch.distributed`` (counterpart of
``repro/launch/serve.py``): a process group takes the place of the mesh.

Two execution plans:

  * :func:`retrieve_pjit` — one process, the engine on the whole index
    (the reference's global-semantics plan; the name is kept so the
    counterpart is easy to find);
  * :func:`make_shardmap_retriever` — each rank owns a block of the docs
    with a local IVF (:func:`shard_index`), runs the whole four-phase
    pipeline on its shard for the whole query batch, and the per-shard
    top-k merge with one all-gather and a second top-k (two-level top-k):
    collective traffic is O(B · k), not O(corpus).

The backend is the caller's group, never picked here: NCCL between cards,
gloo on the CPU or for several ranks sharing one card (NCCL refuses two
ranks on one device). Over gloo the (B, k) partials of a CUDA rank are
copied to the host for the all-gather and back. Every rank must call a
plan with the same queries, in the same order, as collectives require.

Like every entry point of the port, the plans run on CUDA unless
``device="cpu"`` is asked for.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..core import engine
from ..core.engine import EngineConfig, RetrievalResult
from ..core.index import PackedIndex
from ..core.topk import topk
from ..device import resolve_device, resolve_on
from ..obs import trace

IVF_BLOCK = 1 << 26   # IVF entries a step of shard_index's local lists


def retrieve_pjit(group, index: PackedIndex, queries, cfg: EngineConfig,
                  **kwargs) -> RetrievalResult:
    """Retrieval on the whole index in this process (ref ``serve.py:46``):
    ``engine.retrieve``; ``kwargs`` pass through (``q_masks``,
    ``doc_filter``, ``device``). ``group`` is unused: one process holds
    the index."""
    del group
    return engine.retrieve(index, queries, cfg, **kwargs)


# ---------------------------------------------------------------------------
# The sharded plan
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(B, k) on every rank -> (B, S, k), rank-major along axis 1. Over
    gloo a CUDA tensor goes through the host."""
    via_host = (x.device.type == "cuda"
                and dist.get_backend(group) == dist.Backend.GLOO)
    src = x.cpu() if via_host else x.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts, 1).to(x.device)


def _local_retrieve(index_local: PackedIndex, queries: torch.Tensor,
                    q_masks: torch.Tensor, cfg: EngineConfig,
                    group) -> RetrievalResult:
    """One rank's shard (ref ``serve.py:58``): the engine's batched
    pipeline on the local index, local ids shifted by the shard's offset,
    then the two-level top-k: every rank's (B, k) gathered, concatenated
    shard-major and cut with ``lax.top_k``'s order (ties go to the lower
    shard)."""
    local = engine._retrieve_batch(index_local, queries, cfg, q_masks)
    n_local = index_local.codes.shape[0]
    global_ids = local.doc_ids + dist.get_rank(group) * n_local
    b = queries.shape[0]
    sc = _all_gather(local.scores, group).reshape(b, -1)       # (B, S*k)
    gi = _all_gather(global_ids, group).reshape(b, -1)
    top, pos = topk(sc, cfg.k)
    return RetrievalResult(top, torch.gather(gi, 1, pos))


def _shard(index_stacked: PackedIndex, rank: int) -> PackedIndex:
    """Leaf ``rank`` of a stacked index."""
    return PackedIndex(*(f[rank] for f in index_stacked))


def make_shardmap_retriever(group, cfg: EngineConfig, *, device=None):
    """-> ``run(index_stacked, queries, q_masks=None, *, doc_filter=None)
    -> RetrievalResult`` over global doc ids (ref ``serve.py:86``).

    ``group`` is the caller's process group (None: the default group).
    ``index_stacked`` carries a leading shard axis of the group's size
    (:func:`shard_index`); rank r runs the pipeline on leaf r only.
    ``q_masks`` (B, n_q) bool is the same on every rank (None fills in an
    all-True mask, the identity); ``doc_filter``, a compiled
    ``bitvector.FilterPlan``, is evaluated per shard on its own
    ``pred_words``, so the merge sees passing docs only. Runs on
    ``device`` (CUDA unless ``"cpu"`` is asked for), where the index must
    live."""
    dev = resolve_device(device)

    def run(index_stacked: PackedIndex, queries, q_masks=None, *,
            doc_filter=None) -> RetrievalResult:
        n_shards = dist.get_world_size(group)
        if index_stacked.codes.shape[0] != n_shards:
            raise ValueError(
                f"the stacked index holds {index_stacked.codes.shape[0]} "
                f"shards but the group has {n_shards} ranks: shard it with "
                "shard_index(index, world_size)")
        local = _shard(index_stacked, dist.get_rank(group))
        q, qm = engine._inputs(local, queries, q_masks, dev)
        if qm is None:
            qm = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
        return _local_retrieve(local, q, qm,
                               engine._with_filter(cfg, doc_filter), group)

    return run


# ---------------------------------------------------------------------------
# Multi-generation serving (PLAID SHIRTTT): one sharded plan per immutable
# generation, merged by score at the top.
# ---------------------------------------------------------------------------

def make_timeline_partial_plans(group, cfg: EngineConfig, timeline, *,
                                shard_cache: dict = None, device=None):
    """Per-generation sharded plans over a ``store.ShardedTimeline`` (ref
    ``serve.py:150``): each generation is sharded over the group
    (:func:`shard_index`) and queried through
    :func:`make_shardmap_retriever` under the budgets clamped to its
    per-shard doc count and token cap (``engine.adapt_config_to_corpus``),
    its global offset added to the ids.

    ``shard_cache`` (a dict the caller owns) keeps the shards by generation
    content fingerprint, so across timeline swaps only changed generations
    are sharded again; it is bounded LRU (at least 32 entries, twice the
    generations), so stale fingerprints age out first. Every generation's
    ``n_docs`` must divide by the group's size. Returns one
    ``plan(queries, q_masks=None, doc_filter=None) -> RetrievalResult``
    (global ids) per generation: the partials ``RetrievalService`` caches.
    """
    n_shards = dist.get_world_size(group)
    fps = timeline.fingerprints if shard_cache is not None else None
    retrievers: dict = {}      # one per distinct clamped config
    plans = []
    for g, (gen, meta, off) in enumerate(timeline):
        gcfg = engine.adapt_config_to_corpus(cfg, meta.n_docs // n_shards,
                                             meta.cap)
        if gcfg not in retrievers:
            retrievers[gcfg] = make_shardmap_retriever(group, gcfg,
                                                       device=device)
        if shard_cache is None:
            stacked = shard_index(gen, n_shards, device=device)
        else:
            ckey = (fps[g], n_shards)
            stacked = shard_cache.pop(ckey, None)
            if stacked is None:
                stacked = shard_index(gen, n_shards, device=device)
            shard_cache[ckey] = stacked   # (re)insert at the LRU tail

        def plan(queries, q_masks=None, doc_filter=None, *, _stacked=stacked,
                 _retriever=retrievers[gcfg], _off=off, _g=g):
            """queries (B, n_q, d) or a QueryBatch; ``doc_filter`` an
            optional compiled FilterPlan applied on every shard."""
            with trace.span("launch.shard_plan", generation=_g,
                            shards=n_shards):
                r = _retriever(_stacked, queries, q_masks,
                               doc_filter=doc_filter)
                return RetrievalResult(r.scores, r.doc_ids + _off)

        plans.append(plan)
    if shard_cache is not None:
        while len(shard_cache) > max(32, 2 * len(plans)):
            del shard_cache[next(iter(shard_cache))]
    return plans


def make_timeline_retriever(group, cfg: EngineConfig, timeline, *,
                            device=None):
    """Sharded serving over a timeline (ref ``serve.py:225``): the
    per-generation plans merged by score (``engine.merge_partial_topk``), a
    third top-k level over the per-shard merge. Returns ``run(queries,
    q_masks=None, *, doc_filter=None) -> RetrievalResult`` over global
    ids."""
    dev = resolve_on(timeline.generations[0].device, device)
    plans = make_timeline_partial_plans(group, cfg, timeline, device=dev)

    def run(queries, q_masks=None, *, doc_filter=None) -> RetrievalResult:
        q, qm = engine._inputs(timeline.generations[0], queries, q_masks,
                               dev)
        if qm is None:
            qm = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
        return engine.merge_partial_topk(
            [p(q, qm, doc_filter) for p in plans], cfg.k, device=dev)

    return run


def make_service(group, cfg: EngineConfig, timeline, **service_kwargs):
    """A ``RetrievalService`` whose cache-miss lane runs the sharded plans
    (ref ``serve.py:245``): hits come from host memory, misses reach the
    group. The plan factory runs again at every timeline swap; unchanged
    generations keep their shards (a cache owned by this factory, keyed by
    content fingerprint) and their result-cache entries.
    ``service_kwargs`` pass through to ``RetrievalService`` (``device``
    included)."""
    from ..serving import RetrievalService

    shard_cache: dict = {}
    device = service_kwargs.get("device")
    return RetrievalService(
        timeline, cfg,
        plan_factory=lambda tl: make_timeline_partial_plans(
            group, cfg, tl, shard_cache=shard_cache, device=device),
        **service_kwargs)


# ---------------------------------------------------------------------------
# Sharding an index
# ---------------------------------------------------------------------------

def _local_ivfs(ivf: torch.Tensor, ivf_lens: torch.Tensor, n_shards: int,
                per: int):
    """Each shard's IVF with local doc ids, in the global lists' order:
    -> (ivf (S, n_c, list_cap) int32 padded with ``per``, lens (S, n_c)
    int32, entries dropped, lists overflowed). Built a block of centroids
    at a time on the index's device."""
    n_c, list_cap = ivf.shape
    dev = ivf.device
    local = torch.full((n_shards, n_c, list_cap), per, dtype=torch.int32,
                       device=dev)
    lens = torch.zeros((n_shards, n_c), dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    overflowed = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(list_cap, device=dev)
    step = max(1, IVF_BLOCK // max(list_cap, 1))
    for c0 in range(0, n_c, step):
        ids = ivf[c0:c0 + step].long()
        valid = slot < ivf_lens[c0:c0 + step, None]
        owner = torch.where(valid, ids // per, -1)
        for s in range(n_shards):
            mine = owner == s
            count = mine.sum(1)
            pos = torch.cumsum(mine, 1) - 1
            keep = mine & (pos < list_cap)
            row, col = keep.nonzero(as_tuple=True)
            local[s, c0 + row, pos[row, col]] = (ids[row, col]
                                                 - s * per).int()
            lens[s, c0:c0 + step] = count.clamp(max=list_cap).int()
            over = count - list_cap
            dropped += over.clamp(min=0).sum()
            overflowed += (over > 0).sum()
    return local, lens, int(dropped), int(overflowed)


def shard_index(index: PackedIndex, n_shards: int, *,
                device=None) -> PackedIndex:
    """Split an index into per-shard local indices stacked on a new leading
    axis (ref ``serve.py:266``), on the index's device (CUDA unless
    ``device="cpu"`` is asked for): the docs block-partitioned, each
    shard's IVF rebuilt with local doc ids. The per-doc fields are views of
    the index's; the shared ones (centroids, codebooks, codec, rotation)
    are broadcast views. If a local list exceeds the global ``list_cap``
    a warning reports how many doc-id entries were dropped, as the
    reference's does."""
    resolve_on(index.codes.device, device)
    n_docs = int(index.codes.shape[0])
    if n_docs % n_shards:
        raise ValueError(f"{n_docs} docs do not split into {n_shards} "
                         "shards: pad docs to a shard multiple first")
    per = n_docs // n_shards
    list_cap = index.ivf.shape[1]

    def blocks(x):
        return x.reshape(n_shards, per, *x.shape[1:])

    def rep(x):
        return x.unsqueeze(0).expand(n_shards, *x.shape)

    plaid_res = index.plaid_res
    plaid_res = blocks(plaid_res) if plaid_res.shape[0] == n_docs \
        else rep(plaid_res)     # a placeholder
    ivf, ivf_lens, n_dropped, n_overflowed = _local_ivfs(
        index.ivf, index.ivf_lens, n_shards, per)
    if n_dropped:
        warnings.warn(
            f"shard_index: {n_overflowed} local IVF list(s) overflowed "
            f"list_cap={list_cap}; {n_dropped} doc-id entries dropped — "
            "those docs are unreachable through the overflowed centroid on "
            "their shard. Rebuild with a larger list_cap.",
            stacklevel=2)
    return PackedIndex(
        centroids=rep(index.centroids), codes=blocks(index.codes),
        doc_lens=blocks(index.doc_lens), res_codes=blocks(index.res_codes),
        pq_codebooks=rep(index.pq_codebooks), ivf=ivf, ivf_lens=ivf_lens,
        plaid_res=plaid_res, plaid_cutoffs=rep(index.plaid_cutoffs),
        plaid_weights=rep(index.plaid_weights),
        opq_rotation=rep(index.opq_rotation),
        pred_words=blocks(index.pred_words))
