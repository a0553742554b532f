"""EMVB retrieval engine — the four-phase pipeline on batched queries
(counterpart of ``repro/core/engine.py``).

  1. centroid scores + candidate generation (CS matmul, masked
     top-nprobe, IVF union -> candidate bitmap)                  [§4.1]
  2. bit-vector pre-filter F(P, q), top-n_filter                 [§4.2]
  3. centroid interaction S̄ on the survivors, top-n_docs        [§4.3]
  4. PQ late interaction with the dynamic term filter, top-k     [§4.4]

``use_kernels=True`` runs the hand-written kernels (``kernels/ops.py``):
CUDA on the card, their plain PyTorch versions on the CPU. With the default
``fused_prefilter``/``fused_late_interaction`` phases 1b-2 and 3-4 are the
two fused megakernels; with either flag False that half runs the unfused
kernels of the reference's second kernel lane (bitpack + bitfilter, cinter +
pqscore) with the selections between them in torch. ``use_kernels=False``
runs the reference math of ``core`` (the reference's unfused path). On
float32 CS all lanes give the same ids and score bits.

Both candidate modes run: ``score_all`` (Eq. 4 over the whole corpus under
the candidate bitmap) and ``compact`` (each query's candidates gathered
into a ``cand_cap`` buffer first, the paper's loop). A predicate filter
(``doc_filter``, a compiled ``bitvector.FilterPlan``) is enforced at every
selection, as in the reference (docs/FILTERING.md): phase 2 ANDs the pass
mask into the candidate bitmap (inside the prefilter kernel in score_all
mode, before compaction in compact mode), phases 3-4 mask failing
survivors to -inf (inside pqinter on the fused lane).

``cs_dtype="bfloat16"`` (paper §6) runs on every lane with the reference's
dtypes: the CS matmul in bf16, the bit vectors and the masked top-nprobe
comparing in bf16 (float32 in the unfused bitpack, as the reference's
kernel does), S̄ in bf16, Eq. 5/6 on the kernel lanes adding the bf16
centroid score to the float32 residual, and on the reference-math lane an
exact float32 centroid term (the selected tokens' centroid vectors times
the query) for the final scores.

A ``store.ShardedTimeline`` of generations sharing frozen codebooks is
served by :func:`retrieve_timeline`: the pipeline once per generation, the
partial top-k merged by score (by rank across the epochs of a
``store.EpochedTimeline``).

The batch dimension is written out: there is no vmap. At B = 1 the batched
kernels run with B = 1 (row b of the batched kernels equals the
single-query kernel, the reference's tested contract). Internal helpers
take ``cs=`` and ``lut=`` overrides so a test can inject the reference's
matmul outputs and hold phases 1b-4 to the bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device, resolve_on
from ..kernels import ops
from ..obs import trace
from . import bitvector, interaction
from .index import PackedIndex
from .pq import build_lut
from .precision import CS_DTYPES, CS_TYPES, exact_matmuls
from .topk import topk


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static retrieval configuration — the reference's fields and defaults
    (``repro/core/engine.py:57``) minus ``kernel_interpret``, whose job the
    tensors' device does here. ``__post_init__`` raises the reference's
    errors. ``compact_cap`` acts only with ``use_kernels=False``, as in the
    reference."""

    n_q: int = 32
    nprobe: int = 4
    th: float = 0.4
    th_r: Optional[float] = 0.5
    n_filter: int = 512
    n_docs: int = 64
    k: int = 10
    use_kernels: bool = False
    fused_prefilter: bool = True
    fused_late_interaction: bool = True
    # the port always runs the batch-native kernels; the reference's vmap
    # path is bit-identical to them, so False changes nothing here
    batched_kernels: bool = True
    candidate_mode: str = "score_all"
    cand_cap: int = 4096
    compact_cap: Optional[int] = None
    cs_dtype: str = "float32"
    doc_filter: Optional[bitvector.FilterPlan] = None

    def __post_init__(self):
        """Reject inconsistent configurations, as the reference does."""
        if self.n_q > 32:
            raise ValueError(
                f"n_q={self.n_q} > 32: the stacked bit vector packs one "
                "query term per bit of a uint32 word (paper Fig. 3); split "
                "the query or widen the word type first")
        if self.k > self.n_docs:
            raise ValueError(
                f"k={self.k} > n_docs={self.n_docs}: phase 4 can only rank "
                "the n_docs survivors of phase 3; raise n_docs (paper uses "
                "n_docs >= 4*k) or lower k")
        if self.n_docs > self.n_filter:
            raise ValueError(
                f"n_docs={self.n_docs} > n_filter={self.n_filter}: phase 3 "
                "selects from the n_filter bit-vector survivors; raise "
                "n_filter or lower n_docs")
        if self.candidate_mode not in ("score_all", "compact"):
            raise ValueError(
                f"unknown candidate_mode={self.candidate_mode!r}: expected "
                "'score_all' (mask the whole corpus by the candidate "
                "bitmap) or 'compact' (gather candidates into a cand_cap "
                "buffer)")
        if self.candidate_mode == "compact" and self.cand_cap < self.n_filter:
            raise ValueError(
                f"cand_cap={self.cand_cap} < n_filter={self.n_filter}: in "
                "candidate_mode='compact' the top-n_filter selection runs "
                "over the cand_cap candidate buffer; raise cand_cap to at "
                "least n_filter")
        if self.compact_cap is not None and self.th_r is None:
            raise ValueError(
                f"compact_cap={self.compact_cap} requires th_r: per-token "
                "compaction keeps tokens whose centroid beats the Eq. 6 "
                "threshold — set th_r or drop compact_cap")
        if self.cs_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown cs_dtype={self.cs_dtype!r}: expected 'float32' or "
                "'bfloat16'")
        if self.doc_filter is not None and \
                not isinstance(self.doc_filter, bitvector.FilterPlan):
            raise ValueError(
                f"doc_filter is a {type(self.doc_filter).__name__}: expected "
                "a compiled FilterPlan (or None) — compile your FilterExpr "
                "against the index's predicate names first with "
                "bitvector.compile_filter(expr, meta.pred_names)")


class RetrievalResult(NamedTuple):
    """Top-k retrieval output: scores sorted descending + global doc ids."""

    scores: torch.Tensor   # (B, k) float32
    doc_ids: torch.Tensor  # (B, k) int32


class QueryBatch(NamedTuple):
    """A batch of queries ``q`` (B, n_q, d) with its optional per-term mask
    ``q_mask`` (B, n_q) bool (True = live term; None = all live)."""

    q: torch.Tensor
    q_mask: Optional[torch.Tensor] = None


def _with_filter(cfg: EngineConfig, doc_filter) -> EngineConfig:
    """``cfg`` with a per-call ``doc_filter`` folded in (it wins over the
    config's own, ref ``engine.py:216``)."""
    if doc_filter is None:
        return cfg
    return dataclasses.replace(cfg, doc_filter=doc_filter)


def _as_query_batch(queries, q_masks=None) -> QueryBatch:
    if isinstance(queries, QueryBatch):
        if q_masks is not None and queries.q_mask is not None:
            raise ValueError(
                "got a q_mask both inside the QueryBatch and as a separate "
                "argument — pass exactly one")
        return QueryBatch(queries.q,
                          queries.q_mask if q_masks is None else q_masks)
    return QueryBatch(queries, q_masks)


# ---------------------------------------------------------------------------
# Phase 1 — centroid scores and the candidate bitmap
# ---------------------------------------------------------------------------

def _aligned(x: torch.Tensor) -> bool:
    """Whether ``x`` starts at a 16-byte boundary: the alignment class the
    GEMM libraries choose their kernels by."""
    return x.data_ptr() % 16 == 0


@exact_matmuls()
def centroid_scores(q: torch.Tensor, centroids: torch.Tensor,
                    dtype: str = "float32") -> torch.Tensor:
    """q (..., n_q, d), centroids (n_c, d) -> CS (..., n_q, n_c) in
    ``dtype``: float32, or bf16 from bf16 operands (ref ``engine.py:229``).

    Each query's (n_q, d) @ (d, n_c) is its own product. One GEMM over all
    B · n_q rows is not batch-invariant: the library picks its algorithm
    (tiles, split-K) by M, so a query's row took other bits in a batch of
    1, 16 or 17 than in a batch of 32 (on the H100 at 512 centroids,
    d = 32, n_q = 16). A product per query has the same shape and operands
    in every batch, and the same alignment class: its query and its slice
    of the output are used in place when they start at a 16-byte boundary,
    else through a fresh copy (which does). So a query's CS has the same
    bits in any batch; at B = 1 it is the one product of before.

    TF32 stays off: a float32 product in TF32 keeps about three decimal
    digits and would change the bit vectors and every score. A bf16 product
    may not reduce in bf16 (split-K GEMMs would round each partial sum).
    Both flags are set only around these products
    (:func:`~.precision.exact_matmuls`)."""
    dt = CS_DTYPES[dtype]
    table = centroids.T.to(dt)
    rows = q.to(dt).reshape(-1, *q.shape[-2:])
    out = torch.empty((rows.shape[0], q.shape[-2], centroids.shape[0]),
                      dtype=dt, device=q.device)
    for x, o in zip(rows, out):
        x = x if _aligned(x) else x.clone()
        if _aligned(o):
            torch.matmul(x, table, out=o)
        else:
            o.copy_(torch.matmul(x, table))
    return out.reshape(*q.shape[:-1], centroids.shape[0])


def candidate_bitmap(ivf: torch.Tensor, ivf_lens: torch.Tensor,
                     probe_ids: torch.Tensor, n_docs: int,
                     wait_span=trace.NOOP_SPAN) -> torch.Tensor:
    """Union of the IVF lists of the probed centroids (ref
    ``engine.py:237``). probe_ids (..., n_q, nprobe) -> (..., n_docs) bool.
    Probe ids >= n_c (the masked-term sentinel) contribute nothing.
    ``wait_span``, an unstarted span, is opened around the scatter and
    given its ``postings``: every valid (row, term, probe, list slot)
    entry, duplicates included."""
    n_c, list_cap = ivf.shape
    lead = tuple(probe_ids.shape[:-2])
    flat = probe_ids.reshape(*lead, -1).long()
    safe = torch.clamp(flat, 0, n_c - 1)
    lens = torch.where(flat < n_c, ivf_lens[safe].long(),
                       torch.zeros_like(flat))
    valid = torch.arange(list_cap, device=ivf.device) < lens[..., None]
    ids = ivf[safe].long()                                  # (..., P, cap)
    valid = valid & (ids < n_docs)
    nrows = math.prod(lead)
    row = torch.arange(nrows, device=ivf.device).reshape(*lead, 1, 1)
    bitmap = torch.zeros(nrows * n_docs, dtype=torch.bool, device=ivf.device)
    keys = row * n_docs + ids
    # the boolean index is a nonzero: the host waits here for the card
    with wait_span as sp:
        hits = keys[valid]
        bitmap[hits] = True
        sp.set(postings=hits.numel())
    return bitmap.reshape(*lead, n_docs)


def _doc_pass(index: PackedIndex, cfg: EngineConfig
              ) -> Optional[torch.Tensor]:
    """(n_docs,) bool, the docs passing ``cfg.doc_filter`` on the index's
    predicate plane, or None when unfiltered (ref ``engine.py:255``)."""
    if cfg.doc_filter is None:
        return None
    return bitvector.apply_filter_plan(cfg.doc_filter, index.pred_words)


_RUN = 256   # docs a run of the candidate-buffer search


def _compact_candidates(bitmap: torch.Tensor, cfg: EngineConfig):
    """Each query's fixed-size candidate buffer (ref ``engine.py:290``,
    ``lax.top_k(bitmap, cand_cap)``): its candidate doc ids ascending, then
    non-candidates ascending to fill ``cand_cap`` slots — a stable
    partition, with no sort over the corpus and no wait on the device.
    Slot p holds the (p + 1)-th candidate: a binary search over the running
    count of candidates per run of ``_RUN`` docs finds its run, and a count
    within that run its doc. The fills come likewise from the non-candidates
    among the first ``cand_cap`` docs, which hold every fill a row needs.
    bitmap (B, n_docs) -> (cand_ids (B, cand_cap) int64, cand_valid
    (B, cand_cap) bool)."""
    nb, n_docs = bitmap.shape
    cap = cfg.cand_cap
    if cap > n_docs:
        raise ValueError(f"cand_cap={cap} > the index's {n_docs} docs: the "
                         "candidate buffer selects cand_cap of them")
    dev = bitmap.device
    runs = torch.nn.functional.pad(bitmap, (0, -n_docs % _RUN)).view(
        nb, -1, _RUN)
    per_run = runs.sum(2, dtype=torch.int32)                   # (B, R)
    ends = torch.cumsum(per_run, 1, dtype=torch.int32)
    rank = torch.arange(1, cap + 1, dtype=torch.int32,
                        device=dev).expand(nb, cap).contiguous()
    run = torch.searchsorted(ends, rank).clamp(max=runs.shape[1] - 1)
    within = rank - torch.gather(ends, 1, run) + torch.gather(per_run, 1, run)
    rows = torch.arange(nb, device=dev)[:, None]
    local = torch.cumsum(runs[rows, run], 2, dtype=torch.int32)
    set_ids = run * _RUN + torch.searchsorted(
        local, within.clamp(min=1)[..., None])[..., 0]
    n_set = ends[:, -1:]
    fill = torch.cumsum(~bitmap[:, :cap], 1, dtype=torch.int32)
    valid = rank <= n_set
    ids = torch.where(valid, set_ids,
                      torch.searchsorted(fill, (rank - n_set).clamp(min=1)))
    return ids, valid


# ---------------------------------------------------------------------------
# Single-phase helpers (ref ``engine.py:269-452``): each has a kernel branch
# through ``ops`` and the reference math of ``core``. ``retrieve`` and the
# phase entry points share them.
# ---------------------------------------------------------------------------

def _candidates(index: PackedIndex, cs: torch.Tensor, cfg: EngineConfig,
                q_masks=None) -> torch.Tensor:
    """Phase 1 after CS: masked top-nprobe probes -> (B, n_docs) bitmap,
    the host's wait at its scatter in the span
    ``engine.candgen.bitmap_wait``."""
    probe_ids = bitvector.masked_topk_centroids(cs, cfg.th, cfg.nprobe,
                                                q_masks)
    return candidate_bitmap(index.ivf, index.ivf_lens, probe_ids,
                            index.codes.shape[0],
                            trace.span("engine.candgen.bitmap_wait"))


def _phase1(index: PackedIndex, queries: torch.Tensor, cfg: EngineConfig,
            q_masks=None, *, cs=None):
    """Phase 1 -> (cs (B, n_q, n_c), bits (B, n_c) int32 words, bitmap
    (B, n_docs) bool). Masked terms pack a 0 bit and probe no IVF list;
    docs failing ``cfg.doc_filter`` are never candidates."""
    if cs is None:
        cs = centroid_scores(queries, index.centroids, cfg.cs_dtype)
    if cfg.use_kernels:
        bits = ops.bitpack_batched(cs, cfg.th, q_masks)
    else:
        bits = bitvector.build_bitvectors(cs, cfg.th, q_masks)
    bitmap = _candidates(index, cs, cfg, q_masks)
    doc_pass = _doc_pass(index, cfg)
    if doc_pass is not None:
        bitmap = bitmap & doc_pass
    return cs, bits, bitmap


def _phase2(index: PackedIndex, bits: torch.Tensor, bitmap: torch.Tensor,
            cfg: EngineConfig) -> torch.Tensor:
    """Unfused pre-filter: Eq. 4 on every doc (score_all) or on each
    query's candidate buffer (compact), -1 outside the candidates,
    top-n_filter -> sel1 (B, n_filter) int64."""
    if cfg.candidate_mode == "compact":
        cand_ids, cand_valid = _compact_candidates(bitmap, cfg)
        c_codes = index.codes[cand_ids]
        c_lens = torch.where(cand_valid, index.doc_lens[cand_ids], 0)
        if cfg.use_kernels:
            f = ops.bitfilter_batched(bits, c_codes, c_lens)
        else:
            c_mask = (torch.arange(c_codes.shape[-1], device=bits.device)
                      < c_lens[..., None])
            f = torch.stack([bitvector.filter_score(*x)
                             for x in zip(bits, c_codes, c_mask)])
        f = torch.where(cand_valid, f, torch.full_like(f, -1))
        return torch.gather(cand_ids, 1, topk(f, cfg.n_filter)[1])
    if cfg.use_kernels:
        f = ops.bitfilter_batched(bits, index.codes, index.doc_lens)
    else:
        token_mask = index.token_mask()
        f = torch.stack([bitvector.filter_score(b, index.codes, token_mask)
                         for b in bits])
    f = torch.where(bitmap, f, torch.full_like(f, -1))
    return topk(f, cfg.n_filter)[1]


def _phase3(index: PackedIndex, cs_t: torch.Tensor, sel1: torch.Tensor,
            cfg: EngineConfig, q_masks=None) -> torch.Tensor:
    """Centroid interaction on the survivors -> sel2 (B, n_docs) int64.
    cs_t is the (B, n_c, n_q) transposed CS. Survivors failing
    ``cfg.doc_filter`` are -inf before the cut."""
    codes = index.codes[sel1]
    if cfg.use_kernels:
        sbar = ops.cinter_batched(cs_t, codes, index.doc_lens[sel1], q_masks)
    else:
        sbar = interaction.centroid_interaction(
            cs_t, codes, index.token_mask()[sel1], q_masks)
    doc_pass = _doc_pass(index, cfg)
    if doc_pass is not None:
        sbar = torch.where(doc_pass[sel1], sbar,
                           torch.full_like(sbar, -torch.inf))
    _, local = topk(sbar, cfg.n_docs)
    return torch.gather(sel1, 1, local)


@exact_matmuls()
def _exact_centroid_term(index: PackedIndex, queries: torch.Tensor,
                         codes: torch.Tensor) -> torch.Tensor:
    """The float32 centroid term of Eq. 5/6 under reduced-precision CS (ref
    ``engine.py:410-417``): the tokens' centroid vectors times the query.
    queries (B, n_q, d), codes (B, docs, cap) -> (B, docs, cap, n_q)."""
    n_c = index.centroids.shape[0]
    vecs = index.centroids[torch.clamp(codes, 0, n_c - 1).long()]
    return torch.einsum("bntd,bqd->bntq", vecs, queries)


def _phase4(index: PackedIndex, queries: torch.Tensor, cs_t: torch.Tensor,
            lut: torch.Tensor, sel2: torch.Tensor, cfg: EngineConfig,
            q_masks=None):
    """PQ late interaction (+ Eq. 6) -> (scores (B, k), ids (B, k)).
    ``cfg.compact_cap`` compacts tokens first on the reference math only
    (the kernels ignore it, as the reference's do); under bf16 CS the
    reference math without it scores with the exact float32 centroid term,
    the kernels with the bf16 ``cs_t``; survivors failing
    ``cfg.doc_filter`` are -inf before the cut."""
    codes, res = index.codes[sel2], index.res_codes[sel2]
    if cfg.use_kernels:
        scores = ops.pqscore_batched(cs_t, lut, codes, res,
                                     index.doc_lens[sel2], cfg.th_r, q_masks)
    elif cfg.compact_cap is not None:
        scores = interaction.late_interaction_pq_compact(
            cs_t, lut, codes, res, index.token_mask()[sel2], cfg.th_r,
            cfg.compact_cap, q_masks)
    else:
        centroid = None
        if cfg.cs_dtype != "float32":
            centroid = _exact_centroid_term(index, queries, codes)
        scores = interaction.late_interaction_pq(
            cs_t, lut, codes, res, index.token_mask()[sel2], cfg.th_r,
            centroid=centroid, q_mask=q_masks)
    doc_pass = _doc_pass(index, cfg)
    if doc_pass is not None:
        scores = torch.where(doc_pass[sel2], scores,
                             torch.full_like(scores, -torch.inf))
    top, local = topk(scores, cfg.k)
    return top, torch.gather(sel2, 1, local)


# ---------------------------------------------------------------------------
# Batched phase pairs — the megakernels when configured, else the
# single-phase helpers
# ---------------------------------------------------------------------------

def _phase12_batch(index: PackedIndex, queries: torch.Tensor,
                   cfg: EngineConfig, q_masks=None, *, cs=None):
    """Phases 1-2 -> (cs (B, n_q, n_c), sel1 (B, n_filter) int64), in the
    stream-timed spans ``engine.candgen`` and ``engine.prefilter``."""
    dev = queries.device
    if not (cfg.use_kernels and cfg.fused_prefilter):
        with trace.span("engine.candgen", device=dev):
            cs, bits, bitmap = _phase1(index, queries, cfg, q_masks, cs=cs)
        with trace.span("engine.prefilter", device=dev):
            return cs, _phase2(index, bits, bitmap, cfg)
    compact = cfg.candidate_mode == "compact"
    with trace.span("engine.candgen", device=dev):
        if cs is None:
            cs = centroid_scores(queries, index.centroids, cfg.cs_dtype)
        bitmap = _candidates(index, cs, cfg, q_masks)
        if compact:
            # the filter goes in before compaction: failing docs never take
            # a slot of the buffer; the buffer's lengths are not masked by
            # cand_valid, which goes in as the bitmap (ref engine.py:339-352)
            doc_pass = _doc_pass(index, cfg)
            if doc_pass is not None:
                bitmap = bitmap & doc_pass
            cand_ids, cand_valid = _compact_candidates(bitmap, cfg)
    with trace.span("engine.prefilter", device=dev):
        if compact:
            _, local, _ = ops.prefilter_batched(
                cs, cfg.th, index.codes[cand_ids], index.doc_lens[cand_ids],
                cand_valid, cfg.n_filter, q_masks)
            return cs, torch.gather(cand_ids, 1, local.long())
        # score_all: the plan's verdict on each doc's predicate word is
        # ANDed into the bitmap inside the kernel
        plan = None if cfg.doc_filter is None else cfg.doc_filter.clauses
        _, sel1, _ = ops.prefilter_batched(
            cs, cfg.th, index.codes, index.doc_lens, bitmap, cfg.n_filter,
            q_masks, pred_words=index.pred_words, plan=plan)
        return cs, sel1.long()


LUT_CHUNK = 32   # queries one LUT product covers


@exact_matmuls()
def _query_lut(index: PackedIndex, queries: torch.Tensor) -> torch.Tensor:
    """The OPQ rotation, then the PQ inner-product LUT -> (B, n_q, m, K).

    Computed LUT_CHUNK queries at a time, the last chunk padded with zero
    queries, so each product has one shape whatever the batch: a query's
    LUT does not depend on what else is in the batch (each row of a GEMM
    of one shape runs the same reduction, wherever it sits), and a batch
    of one costs a chunk's few microseconds. One product per query, as the
    CS takes (:func:`centroid_scores`), costs its launches per query: the
    LUT and survivor gathers took 3.4 ms at B = 32 on an H100 that way,
    0.12 ms with one product."""
    rows = queries.reshape(-1, *queries.shape[-2:])
    n = rows.shape[0]
    pad = max(1, -(-n // LUT_CHUNK)) * LUT_CHUNK - n
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, *rows.shape[1:])])
    lut = torch.cat([build_lut(torch.matmul(c, index.opq_rotation), index.pq)
                     for c in rows.split(LUT_CHUNK)])
    return lut[:n].reshape(*queries.shape[:-1], *lut.shape[-2:])


def _transposed(cs: torch.Tensor) -> torch.Tensor:
    """CS (B, n_q, n_c) -> the contiguous CS^T (B, n_c, n_q) the phase 3-4
    kernels read, made from that same tensor so every kernel sees the same
    bits."""
    return cs.transpose(1, 2).contiguous()


def _survivor_operands(index: PackedIndex, cs: torch.Tensor,
                       lut: torch.Tensor, sel1: torch.Tensor):
    """What the phase 3-4 kernel reads: (cs_t (B, n_c, n_q), lut, and the
    survivors' codes, residual codes and token lengths). The three gathers
    run in the stream-timed span ``engine.late.gather``, whose ``bytes`` is
    what they write, taken from the shapes."""
    cs_t = _transposed(cs)
    with trace.span("engine.late.gather", device=sel1.device) as sp:
        codes, res = index.codes[sel1], index.res_codes[sel1]
        lens = index.doc_lens[sel1]
        sp.set(bytes=codes.nbytes + res.nbytes + lens.nbytes)
    return cs_t, lut, codes, res, lens


def _phase34_batch(index: PackedIndex, queries: torch.Tensor,
                   cs: torch.Tensor, sel1: torch.Tensor, cfg: EngineConfig,
                   q_masks=None, *, lut=None) -> RetrievalResult:
    """Phases 3-4 -> RetrievalResult with (B, k) scores and doc ids, in the
    stream-timed span ``engine.late``; on the fused lane the survivor
    gathers and the kernel in ``engine.late.gather`` and
    ``engine.late.pqinter`` inside it."""
    dev = queries.device
    with trace.span("engine.late", device=dev):
        if lut is None:
            lut = _query_lut(index, queries)
        sel1 = sel1.long()
        if cfg.use_kernels and cfg.fused_late_interaction:
            doc_pass = _doc_pass(index, cfg)
            operands = _survivor_operands(index, cs, lut, sel1)
            if doc_pass is not None:
                doc_pass = doc_pass[sel1]
            with trace.span("engine.late.pqinter", device=dev):
                scores, pos, _, _ = ops.pqinter_batched(
                    *operands, cfg.th_r, cfg.n_docs, cfg.k, q_masks,
                    doc_pass=doc_pass)
            ids = torch.gather(sel1, 1, pos.long())
        else:
            cs_t = _transposed(cs)
            sel2 = _phase3(index, cs_t, sel1, cfg, q_masks)
            scores, ids = _phase4(index, queries, cs_t, lut, sel2, cfg,
                                  q_masks)
        return RetrievalResult(scores, ids.to(torch.int32))


def _retrieve_batch(index: PackedIndex, queries: torch.Tensor,
                    cfg: EngineConfig, q_masks=None, *, cs=None,
                    lut=None) -> RetrievalResult:
    """The full batched pipeline."""
    cs, sel1 = _phase12_batch(index, queries, cfg, q_masks, cs=cs)
    return _phase34_batch(index, queries, cs, sel1, cfg, q_masks, lut=lut)


def _inputs(index: PackedIndex, queries, q_masks, device):
    """Normalize queries/mask onto the index's device, which must be the
    requested one (CUDA unless the caller passes ``device="cpu"``)."""
    idev = index.codes.device
    resolve_on(idev, device)
    qb = _as_query_batch(queries, q_masks)
    q = torch.as_tensor(qb.q, dtype=torch.float32, device=idev)
    qm = (None if qb.q_mask is None
          else torch.as_tensor(qb.q_mask, dtype=torch.bool, device=idev))
    return q, qm


def retrieve(index: PackedIndex, queries, cfg: EngineConfig, q_masks=None,
             *, doc_filter=None, device=None) -> RetrievalResult:
    """queries (B, n_q, d) or QueryBatch -> RetrievalResult, (B, k) each
    (ref ``engine.py:576``).

    Runs on CUDA unless ``device="cpu"``: with no GPU and no device given
    it raises rather than running on the CPU. ``q_masks`` (B, n_q) bool
    marks live query terms; masked terms are excluded from every phase.
    ``doc_filter``, a compiled ``bitvector.FilterPlan``, restricts results
    to the docs that pass it and overrides ``cfg.doc_filter`` for this
    call; under lossless budgets filtered retrieval equals
    retrieve-then-post-filter bit for bit.
    """
    q, qm = _inputs(index, queries, q_masks, device)
    cfg = _with_filter(cfg, doc_filter)
    # spans time the launches, not the device work (the reference's
    # dispatch spans, same names)
    with trace.span("engine.retrieve.dispatch", batch=q.shape[0],
                    filtered=cfg.doc_filter is not None):
        return _retrieve_batch(index, q, cfg, qm)


# ---------------------------------------------------------------------------
# Phase-split entry points (ref ``engine.py:697-841``), batched signatures
# only: ``phaseN(index, queries, cfg, *, q_mask=None, ...)`` with the
# intermediates as keyword arguments with a leading batch axis, and
# ``doc_filter=`` folded into the config as ``retrieve`` does. They compose
# the same helpers ``retrieve`` runs; the single-phase ones run the unfused
# helpers whatever the fused flags say, as the reference's do.
# ---------------------------------------------------------------------------

def _on(index: PackedIndex, x, dtype=None) -> torch.Tensor:
    """An intermediate handed back in, on the index's device."""
    return torch.as_tensor(x, dtype=dtype, device=index.codes.device)


def _cs_on(index: PackedIndex, cs) -> torch.Tensor:
    """A handed-back CS on the index's device, in its own dtype when that is
    float32 or bf16 (as the reference traces whatever it is given), else
    float32."""
    cs = _on(index, cs)
    return cs if cs.dtype in CS_TYPES else cs.to(torch.float32)


def phase1_candidates(index: PackedIndex, queries, cfg: EngineConfig, *,
                      q_mask=None, doc_filter=None, device=None):
    """Phase 1 (ref ``engine.py:697``) -> (cs (B, n_q, n_c), bits (B, n_c)
    int32 holding the reference's uint32 words, bitmap (B, n_docs) bool):
    centroid scores, the stacked Eq. 4 bit vectors and the IVF candidate
    bitmap."""
    cfg = _with_filter(cfg, doc_filter)
    q, qm = _inputs(index, queries, q_mask, device)
    return _phase1(index, q, cfg, qm)


def phase2_prefilter(index: PackedIndex, queries, cfg: EngineConfig, *,
                     q_mask=None, bits=None, bitmap=None, doc_filter=None,
                     device=None):
    """Phase 2 (ref ``engine.py:714``) -> sel1 (B, n_filter) int32: Eq. 4
    for every doc, the top-n_filter candidates. ``bits``/``bitmap`` are
    phase 1's outputs; omitted, phase 1 runs here (the only use of
    ``q_mask``: masked terms are already 0 bits in ``bits``)."""
    cfg = _with_filter(cfg, doc_filter)
    q, qm = _inputs(index, queries, q_mask, device)
    if bits is None or bitmap is None:
        _, bits, bitmap = _phase1(index, q, cfg, qm)
    sel1 = _phase2(index, _on(index, bits, torch.int32),
                   _on(index, bitmap, torch.bool), cfg)
    return sel1.to(torch.int32)


def phase12_prefilter(index: PackedIndex, queries, cfg: EngineConfig, *,
                      q_mask=None, doc_filter=None, device=None):
    """Fused phases 1-2 (ref ``engine.py:738``), batched signature only:
    ``(index, queries, cfg, *, q_mask=None)`` -> (cs (B, n_q, n_c),
    sel1 (B, n_filter) int32)."""
    cfg = _with_filter(cfg, doc_filter)
    q, qm = _inputs(index, queries, q_mask, device)
    cs, sel1 = _phase12_batch(index, q, cfg, qm)
    return cs, sel1.to(torch.int32)


def phase3_centroid_interaction(index: PackedIndex, queries,
                                cfg: EngineConfig, *, q_mask=None, cs=None,
                                sel1=None, doc_filter=None,
                                device=None) -> torch.Tensor:
    """Phase 3 (ref ``engine.py:757``) -> sel2 (B, n_docs) int32: S̄ on the
    phase-2 survivors, the top-n_docs. ``cs``/``sel1`` are phase 1-2's
    outputs; omitted, phases 1-2 run here."""
    cfg = _with_filter(cfg, doc_filter)
    q, qm = _inputs(index, queries, q_mask, device)
    if cs is None or sel1 is None:
        cs_c, sel1_c = _phase12_batch(index, q, cfg, qm)
        cs = cs_c if cs is None else cs
        sel1 = sel1_c if sel1 is None else sel1
    cs_t = _transposed(_cs_on(index, cs))
    return _phase3(index, cs_t, _on(index, sel1).long(), cfg,
                   qm).to(torch.int32)


def phase4_late_interaction(index: PackedIndex, queries, cfg: EngineConfig,
                            *, q_mask=None, cs=None, sel2=None,
                            doc_filter=None, device=None) -> RetrievalResult:
    """Phase 4 (ref ``engine.py:782``) -> RetrievalResult ((B, k) scores
    and doc ids): Eq. 5, or Eq. 6 when ``cfg.th_r`` is set, on the phase-3
    survivors, then the top-k. ``cs``/``sel2`` are phase 1-3's outputs;
    omitted, phases 1-3 run here."""
    cfg = _with_filter(cfg, doc_filter)
    q, qm = _inputs(index, queries, q_mask, device)
    if cs is None or sel2 is None:
        cs_c, sel1 = _phase12_batch(index, q, cfg, qm)
        cs = cs_c if cs is None else cs
    cs_t = _transposed(_cs_on(index, cs))
    if sel2 is None:
        sel2 = _phase3(index, cs_t, sel1, cfg, qm)
    scores, ids = _phase4(index, q, cs_t, _query_lut(index, q),
                          _on(index, sel2).long(), cfg, qm)
    return RetrievalResult(scores, ids.to(torch.int32))


def phase34_late_interaction(index: PackedIndex, queries, cfg: EngineConfig,
                             *, q_mask=None, cs=None, sel1=None,
                             doc_filter=None, device=None) -> RetrievalResult:
    """Fused phases 3-4 (ref ``engine.py:809``), batched signature only:
    ``(index, queries, cfg, *, q_mask=None, cs, sel1)`` -> RetrievalResult.
    ``cs``/``sel1`` are phase 1-2's outputs; omitted, phases 1-2 run
    here."""
    cfg = _with_filter(cfg, doc_filter)
    q, qm = _inputs(index, queries, q_mask, device)
    if cs is None or sel1 is None:
        cs_c, sel1_c = _phase12_batch(index, q, cfg, qm)
        cs = cs_c if cs is None else cs
        sel1 = sel1_c if sel1 is None else sel1
    return _phase34_batch(index, q, _cs_on(index, cs), _on(index, sel1),
                          cfg, qm)


# ---------------------------------------------------------------------------
# Multi-generation serving (ref ``engine.py:837``, PLAID SHIRTTT): the
# pipeline once per immutable generation, the partial top-k merged by score
# (by rank across codebook epochs).
# ---------------------------------------------------------------------------

def adapt_config_to_corpus(cfg: EngineConfig, n_docs: int,
                           cap: Optional[int] = None) -> EngineConfig:
    """Clamp a config's selection budgets to a corpus of ``n_docs`` (ref
    ``engine.py:843``): ``n_filter``, ``n_docs`` and ``cand_cap`` to the
    generation's size and ``compact_cap`` to its token ``cap``, all
    lossless. ``k`` is not clamped: a generation of fewer than ``k`` docs
    raises."""
    if n_docs < cfg.k:
        raise ValueError(
            f"corpus/generation has {n_docs} docs but cfg.k={cfg.k}: "
            "every generation must hold >= k docs to fill a per-generation "
            "top-k — batch tiny additions with store.add_passages instead "
            "of opening a new generation")
    nf = min(cfg.n_filter, n_docs)
    cc = cfg.compact_cap
    if cc is not None and cap is not None:
        cc = min(cc, cap)
    return dataclasses.replace(
        cfg, n_filter=nf, n_docs=min(cfg.n_docs, nf),
        cand_cap=max(min(cfg.cand_cap, n_docs), nf), compact_cap=cc)


def merge_partial_topk(parts: list[RetrievalResult], k: int, *,
                       device=None) -> RetrievalResult:
    """Merge partial top-k results carrying global doc ids into one top-k
    (ref ``engine.py:879``), on ``device`` (CUDA unless ``"cpu"`` is asked
    for), where the parts must live: the parts concatenate in generation
    order and the top ``k`` are re-selected by score with ``lax.top_k``'s
    ties (the earlier position, the lower global id, first)."""
    resolve_on(parts[0].scores.device, device)
    scores = torch.cat([r.scores for r in parts], 1)              # (B, G*k)
    ids = torch.cat([r.doc_ids for r in parts], 1)
    top, pos = topk(scores, k)
    return RetrievalResult(top, torch.gather(ids, 1, pos))


def merge_partial_topk_by_rank(parts: list[RetrievalResult], k: int, *,
                               device=None) -> RetrievalResult:
    """Merge per-epoch top-k results whose scores are not comparable (ref
    ``engine.py:899``), on ``device`` as :func:`merge_partial_topk`: the
    results interleave by rank, the newest epoch first at every rank, cut to
    ``k``. Each score is its doc's own-epoch score (diagnostic, unsorted).
    A single part passes through unchanged."""
    resolve_on(parts[0].scores.device, device)
    if len(parts) == 1:
        return parts[0]
    ids = torch.stack([p.doc_ids for p in reversed(parts)], 1)    # (B, E, k)
    sc = torch.stack([p.scores for p in reversed(parts)], 1)
    b = ids.shape[0]
    return RetrievalResult(sc.transpose(1, 2).reshape(b, -1)[:, :k],
                           ids.transpose(1, 2).reshape(b, -1)[:, :k])


def merge_generation_topk(parts: list[RetrievalResult], offsets, k: int, *,
                          device=None) -> RetrievalResult:
    """Merge per-generation top-k results carrying local doc ids (ref
    ``engine.py:931``): each generation's ``offset`` applied, then
    :func:`merge_partial_topk`."""
    return merge_partial_topk(
        [RetrievalResult(r.scores, r.doc_ids + off)
         for r, off in zip(parts, offsets)], k, device=device)


def _generation_topk(index: PackedIndex, meta, offset: int,
                     queries: torch.Tensor, cfg: EngineConfig, q_masks,
                     operands=None) -> RetrievalResult:
    """One generation's partial top-k in global ids. ``operands``, when
    given, maps a generation's index to its (cs, lut): the test harness
    injects the reference's matmul outputs there, as ``_retrieve_batch``
    takes them."""
    if cfg.doc_filter is not None and \
            tuple(cfg.doc_filter.names) != tuple(meta.pred_names):
        raise ValueError(
            f"doc_filter was compiled against predicate names "
            f"{tuple(cfg.doc_filter.names)} but this generation declares "
            f"{tuple(meta.pred_names)}: bit positions would disagree — "
            "recompile the FilterExpr with compile_filter(expr, "
            "meta.pred_names) for this timeline")
    cs, lut = (None, None) if operands is None else operands(index)
    with trace.span("engine.retrieve.dispatch", batch=queries.shape[0],
                    filtered=cfg.doc_filter is not None):
        part = _retrieve_batch(
            index, queries, adapt_config_to_corpus(cfg, meta.n_docs,
                                                   meta.cap),
            q_masks, cs=cs, lut=lut)
    return RetrievalResult(part.scores, part.doc_ids + offset)


def retrieve_generation_topk(index: PackedIndex, meta, offset: int, queries,
                             cfg: EngineConfig, q_masks=None, *,
                             doc_filter=None, device=None
                             ) -> RetrievalResult:
    """One generation's partial top-k, doc ids mapped into the global space
    (ref ``engine.py:943``), on ``device`` (CUDA unless ``"cpu"`` is asked
    for): ``retrieve`` with the budgets clamped to the generation
    (:func:`adapt_config_to_corpus`), ids shifted by ``offset``. The filter
    (``doc_filter`` or ``cfg.doc_filter``) must be compiled against
    ``meta.pred_names``."""
    q, qm = _inputs(index, queries, q_masks, device)
    return _generation_topk(index, meta, offset, q,
                            _with_filter(cfg, doc_filter), qm)


def _timeline_topk(timeline, queries: torch.Tensor, cfg: EngineConfig,
                   q_masks, doc_filter, operands=None) -> RetrievalResult:
    """:func:`retrieve_timeline` on normalized queries; ``operands`` as in
    :func:`_generation_topk`."""
    if getattr(timeline, "epochs", None) is not None:
        parts = [RetrievalResult(r.scores, r.doc_ids + eoff)
                 for tl, eoff in timeline
                 for r in (_timeline_topk(tl, queries, cfg, q_masks,
                                          doc_filter, operands),)]
        return merge_partial_topk_by_rank(parts, cfg.k,
                                          device=queries.device)
    if isinstance(doc_filter, bitvector.FilterExpr):
        doc_filter = bitvector.compile_filter(doc_filter,
                                              timeline.metas[0].pred_names)
    cfg = _with_filter(cfg, doc_filter)
    with trace.span("engine.retrieve_timeline.dispatch",
                    generations=len(timeline.generations)):
        parts = [_generation_topk(gen, meta, off, queries, cfg, q_masks,
                                  operands)
                 for gen, meta, off in timeline]
        return merge_partial_topk(parts, cfg.k, device=queries.device)


def retrieve_timeline(timeline, queries, cfg: EngineConfig, q_masks=None, *,
                      doc_filter=None, device=None) -> RetrievalResult:
    """Retrieve over a ``store.ShardedTimeline`` (ref ``engine.py:979``), on
    ``device`` (CUDA unless ``"cpu"`` is asked for), where the timeline must
    live: ``retrieve`` once per generation with the budgets clamped to it,
    local ids offset into the global space, the partial top-k merged by
    score (:func:`merge_partial_topk`). Under cut-lossless budgets the
    result equals ``retrieve`` on one index grown over the union corpus,
    ids and score bits.

    An ``store.EpochedTimeline`` retrieves each epoch so, shifts its ids by
    the epoch's offset, and merges the epochs by rank
    (:func:`merge_partial_topk_by_rank`). ``doc_filter`` is a compiled
    ``FilterPlan`` (matching the timeline's predicate names) or a raw
    ``bitvector.FilterExpr``, compiled here against each epoch's names.
    """
    epochs = getattr(timeline, "epochs", None)
    first = (epochs[0] if epochs is not None else timeline).generations[0]
    q, qm = _inputs(first, queries, q_masks, device)
    return _timeline_topk(timeline, q, cfg, qm, doc_filter)


# ---------------------------------------------------------------------------
# Query-embedding pruning (ref ``engine.py:1055``)
# ---------------------------------------------------------------------------

def prune_queries(q: torch.Tensor, keep: int,
                  importance: Optional[torch.Tensor] = None, *,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``keep`` most important terms of each query (ref
    ``engine.py:1057``), on ``resolve_device(device)``: the GPU unless the
    caller asks for the CPU, as every entry point.

    q (..., n_q, d); importance optional (..., n_q), by default each term's
    L2 norm, so zero-padded terms rank last. The selection is ``lax.top_k``'s
    (descending, the lower term first on ties), re-sorted to term order, so
    ``keep == n_q`` is the identity. -> (q_pruned (..., keep, d), q_mask
    (..., keep) bool), the mask False exactly where the kept term is a zero
    embedding (its norm, never the sign of its importance). Raises
    ``ValueError`` for ``keep > n_q``, where the reference asserts.
    """
    dev = resolve_device(device)
    q = torch.as_tensor(q, device=dev)
    n_q = q.shape[-2]
    if keep > n_q:
        raise ValueError(f"keep={keep} exceeds n_q={n_q}")
    if importance is None:
        importance = torch.linalg.vector_norm(q, dim=-1)
    importance = torch.as_tensor(importance, device=dev)
    sel = torch.sort(topk(importance, keep)[1], dim=-1).values
    q_pruned = torch.gather(q, -2, sel[..., None].expand(*sel.shape,
                                                          q.shape[-1]))
    return q_pruned, torch.linalg.vector_norm(q_pruned, dim=-1) > 0
