"""Retrieval explain — the per-phase candidate funnel for one query
(counterpart of ``repro/obs/explain.py``).

EMVB retrieval is a four-stage funnel: centroid probes select IVF
candidates (§4.1), the Eq. 4 bit-vector pre-filter cuts them to
``n_filter`` survivors (§4.2), the centroid-interaction proxy S̄ keeps the
top ``n_docs`` (§4.3), and PQ late interaction (Eq. 5, or Eq. 6 under the
``th_r`` term filter) ranks the final top-k (§4.4). :func:`explain`
recomputes one query's funnel through the port's public phase entry points
(``engine.phase1_candidates`` … ``phase4_late_interaction``: on the card
they launch bitpack, bitfilter, cinter and pqscore) and counts at every
stage. Composed, those phases are ``retrieve`` on every lane, so the
explained top-k is the served one, ids and score bits.

:func:`explain_timeline` extends the funnel across a ``ShardedTimeline`` or
``EpochedTimeline``: the final top-k comes from the real
``engine.retrieve_timeline``; each generation reports how many of the final
k it contributed (global id ranges partition the corpus, so the
contributions sum to k) and its own funnel under the clamped config the
serving path uses (``adapt_config_to_corpus``).

``phase_ms`` is wall time around each phase call with the device
synchronized after it (``torch.cuda.synchronize``), so it includes the
launches. A debug path: per query, eager; the spans of
:mod:`repro_torch.obs.trace` are the production telemetry. The field names
and ``to_dict()`` are the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import bitvector, interaction
from ..core.engine import (EngineConfig, adapt_config_to_corpus,
                           phase1_candidates, phase2_prefilter,
                           phase3_centroid_interaction,
                           phase4_late_interaction, retrieve_timeline)
from ..core.store import EpochedTimeline
from ..device import resolve_on


@dataclasses.dataclass(frozen=True)
class QueryExplain:
    """One query's per-phase funnel over ONE index (local doc ids), field
    for field the reference's (``repro/obs/explain.py:53``).

    ``live_terms`` query terms probe ``centroids_probed`` distinct
    centroids (of a ``live_terms * nprobe`` budget), whose IVF lists union
    into ``candidates`` bitmap docs (already ANDed with the predicate
    filter; ``docs_passing_filter`` / ``filter_selectivity`` report the
    filter alone); the Eq. 4 pre-filter keeps ``n_filter_survivors`` real
    candidates of its ``n_filter_budget``-wide selection; phase 3 scores
    ``phase3_docs_scored`` docs and keeps ``phase4_docs_scored`` for late
    interaction, where the Eq. 6 ``th_r`` filter evaluates
    ``scored_term_fraction`` of the (term, token) residual pairs (1.0 when
    ``th_r`` is None). ``topk_scores`` / ``topk_ids`` are ``retrieve``'s
    under the same config. ``phase_ms`` maps phase name -> wall ms.
    """

    n_q: int
    live_terms: int
    n_centroids: int
    centroids_probed: int
    probe_budget: int
    n_docs_corpus: int
    docs_passing_filter: Optional[int]
    filter_selectivity: Optional[float]
    candidates: int
    candidate_mode: str
    candidate_cap: Optional[int]
    n_filter_budget: int
    n_filter_survivors: int
    phase3_docs_scored: int
    phase4_docs_scored: int
    scored_term_fraction: float
    k: int
    topk_scores: np.ndarray
    topk_ids: np.ndarray
    phase_ms: dict

    def to_dict(self) -> dict:
        """JSON-able dict (arrays -> lists, numpy scalars -> Python)."""
        d = dataclasses.asdict(self)
        d["topk_scores"] = [float(s) for s in self.topk_scores]
        d["topk_ids"] = [int(i) for i in self.topk_ids]
        return d


@dataclasses.dataclass(frozen=True)
class GenerationExplain:
    """One generation's share of a timeline explain (ref ``:103``): its
    epoch and position, content ``fingerprint``, global id range
    ``[offset, offset + n_docs)``, how many of the final k it contributed,
    and its own :class:`QueryExplain` ``funnel`` (local ids)."""

    epoch: int
    generation: int
    fingerprint: str
    offset: int
    n_docs: int
    contribution: int
    funnel: QueryExplain

    def to_dict(self) -> dict:
        """JSON-able dict."""
        d = dataclasses.asdict(self)
        d["funnel"] = self.funnel.to_dict()
        return d


@dataclasses.dataclass(frozen=True)
class TimelineExplain:
    """One query explained across a timeline (ref ``:127``): the merged
    top-k of ``retrieve_timeline`` (global ids) plus per-generation
    attribution; the contributions sum to k."""

    k: int
    n_generations: int
    n_epochs: int
    topk_scores: np.ndarray
    topk_ids: np.ndarray
    generations: tuple
    merge_ms: float

    def to_dict(self) -> dict:
        """JSON-able dict."""
        return {
            "k": self.k,
            "n_generations": self.n_generations,
            "n_epochs": self.n_epochs,
            "topk_scores": [float(s) for s in self.topk_scores],
            "topk_ids": [int(i) for i in self.topk_ids],
            "generations": [g.to_dict() for g in self.generations],
            "merge_ms": self.merge_ms,
        }


def _timed(thunk, device: torch.device):
    """Run ``thunk``, wait for the device's work, and return (result, wall
    milliseconds)."""
    t0 = time.perf_counter()
    out = thunk()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def _one_query(query, q_mask, n_q: int):
    """Normalize a single query (+ optional mask) to batch-of-one numpy
    arrays; rejects real batches (explain is per query)."""
    q = np.asarray(query.cpu() if torch.is_tensor(query) else query,
                   dtype=np.float32)
    if q.ndim == 3:
        if q.shape[0] != 1:
            raise ValueError(
                f"explain is per-query but got a batch of {q.shape[0]}; "
                "loop over the batch (each query has its own funnel)")
        q = q[0]
    if q.ndim != 2 or q.shape[0] != n_q:
        raise ValueError(
            f"query has shape {q.shape}: expected ({n_q}, d) — pad/mask "
            "with repro_torch.serving.pad_query first")
    qm = None
    if q_mask is not None:
        qm = np.asarray(q_mask.cpu() if torch.is_tensor(q_mask) else q_mask,
                        dtype=bool).reshape(-1)
        if qm.shape[0] != n_q:
            raise ValueError(
                f"q_mask has {qm.shape[0]} entries, expected {n_q}")
        qm = qm[None]
    return q[None], qm


def explain(index, query, cfg: EngineConfig, *, q_mask=None,
            doc_filter=None, device=None) -> QueryExplain:
    """Explain one query's funnel over one ``PackedIndex`` (ref ``:188``),
    on ``device`` (CUDA unless ``"cpu"`` is asked for), where the index
    must live.

    query      : (n_q, d) padded query (or a batch of exactly one)
    cfg        : the exact config the query would be served with, budgets
                 as-is (clamp with ``adapt_config_to_corpus`` first for a
                 small corpus; :func:`explain_timeline` does that)
    q_mask     : optional (n_q,) bool live-term mask
    doc_filter : optional compiled ``bitvector.FilterPlan``; overrides
                 ``cfg.doc_filter`` like ``retrieve``'s keyword

    -> :class:`QueryExplain`, whose top-k is ``retrieve(index, query[None],
    cfg, ...)``'s, ids and score bits.
    """
    dev = resolve_on(index.codes.device, device)
    if doc_filter is not None:
        if not isinstance(doc_filter, bitvector.FilterPlan):
            raise ValueError(
                f"doc_filter is a {type(doc_filter).__name__}: explain() "
                "over a bare index takes a compiled FilterPlan — compile "
                "with bitvector.compile_filter(expr, meta.pred_names), or "
                "use explain_timeline() which compiles per epoch")
        cfg = dataclasses.replace(cfg, doc_filter=doc_filter)
    qb, qm = _one_query(query, q_mask, cfg.n_q)
    phase_ms: dict = {}
    kw = dict(device=dev)

    (cs, bits, bitmap), phase_ms["phase1"] = _timed(
        lambda: phase1_candidates(index, qb, cfg, q_mask=qm, **kw), dev)
    sel1, phase_ms["phase2"] = _timed(
        lambda: phase2_prefilter(index, qb, cfg, bits=bits, bitmap=bitmap,
                                 **kw), dev)
    sel2, phase_ms["phase3"] = _timed(
        lambda: phase3_centroid_interaction(index, qb, cfg, q_mask=qm,
                                            cs=cs, sel1=sel1, **kw), dev)
    res, phase_ms["phase4"] = _timed(
        lambda: phase4_late_interaction(index, qb, cfg, q_mask=qm, cs=cs,
                                        sel2=sel2, **kw), dev)

    n_c = int(index.centroids.shape[0])
    qm_t = None if qm is None else torch.from_numpy(qm[0]).to(dev)
    probes = bitvector.masked_topk_centroids(cs[0], cfg.th, cfg.nprobe, qm_t)
    centroids_probed = int((torch.unique(probes) < n_c).sum())
    live_terms = int(qm[0].sum()) if qm is not None else cfg.n_q

    n_docs_corpus = int(index.codes.shape[0])
    docs_passing = selectivity = None
    if cfg.doc_filter is not None:
        docs_passing = int(bitvector.apply_filter_plan(
            cfg.doc_filter, index.pred_words).sum())
        selectivity = docs_passing / max(n_docs_corpus, 1)

    candidates = int(bitmap[0].sum())
    cand_cap = cfg.cand_cap if cfg.candidate_mode == "compact" else None
    capped = candidates if cand_cap is None else min(candidates, cand_cap)
    n_filter_budget = int(sel1.shape[-1])
    phase4_docs = int(sel2.shape[-1])

    if cfg.th_r is None:
        stf = 1.0
    else:
        rows = sel2[0].long()
        lens = index.doc_lens[rows]
        mask = (torch.arange(index.codes.shape[1], device=dev)
                < lens[:, None])
        stf = float(interaction.scored_term_fraction(
            cs[0].T, index.codes[rows], mask, cfg.th_r, qm_t))

    return QueryExplain(
        n_q=cfg.n_q, live_terms=live_terms,
        n_centroids=n_c, centroids_probed=centroids_probed,
        probe_budget=live_terms * cfg.nprobe,
        n_docs_corpus=n_docs_corpus,
        docs_passing_filter=docs_passing, filter_selectivity=selectivity,
        candidates=candidates, candidate_mode=cfg.candidate_mode,
        candidate_cap=cand_cap,
        n_filter_budget=n_filter_budget,
        n_filter_survivors=min(capped, n_filter_budget),
        phase3_docs_scored=n_filter_budget, phase4_docs_scored=phase4_docs,
        scored_term_fraction=stf, k=cfg.k,
        topk_scores=res.scores[0].cpu().numpy(),
        topk_ids=res.doc_ids[0].cpu().numpy(),
        phase_ms=phase_ms)


def explain_timeline(timeline, query, cfg: EngineConfig, *, q_mask=None,
                     doc_filter=None, device=None) -> TimelineExplain:
    """Explain one query across a timeline (ref ``:281``) — the final top-k
    attribution plus a per-generation funnel — on ``device`` (CUDA unless
    ``"cpu"`` is asked for), where the timeline must live.

    timeline   : a ``ShardedTimeline`` or ``EpochedTimeline``
    doc_filter : a ``bitvector.FilterExpr`` (compiled here per epoch, as
                 ``retrieve_timeline`` does) or a compiled ``FilterPlan``

    The merged top-k is ``retrieve_timeline``'s; each generation's
    ``contribution`` counts the final ids inside its global id range, and
    its ``funnel`` is :func:`explain` under the ``adapt_config_to_corpus``
    clamped config. Contributions sum to k.
    """
    et = EpochedTimeline.of(timeline)
    dev = resolve_on(et.epochs[0].generations[0].device, device)
    qb, qm = _one_query(query, q_mask, cfg.n_q)
    final, merge_ms = _timed(
        lambda: retrieve_timeline(timeline, qb, cfg, qm,
                                  doc_filter=doc_filter, device=dev), dev)
    ids = final.doc_ids[0].cpu().numpy()

    rows = []
    for e, (tl, eoff) in enumerate(et):
        df = doc_filter
        if isinstance(df, bitvector.FilterExpr):
            df = bitvector.compile_filter(df, tl.metas[0].pred_names)
        gcfg = cfg if df is None else \
            dataclasses.replace(cfg, doc_filter=df)
        for g, (gen, meta, off) in enumerate(tl):
            lo = eoff + off
            hi = lo + meta.n_docs
            rows.append(GenerationExplain(
                epoch=e, generation=g, fingerprint=tl.fingerprints[g],
                offset=lo, n_docs=meta.n_docs,
                contribution=int(((ids >= lo) & (ids < hi)).sum()),
                funnel=explain(
                    gen, qb,
                    adapt_config_to_corpus(gcfg, meta.n_docs, meta.cap),
                    q_mask=None if qm is None else qm[0], device=dev)))

    return TimelineExplain(
        k=cfg.k, n_generations=len(rows), n_epochs=len(et.epochs),
        topk_scores=final.scores[0].cpu().numpy(),
        topk_ids=ids, generations=tuple(rows), merge_ms=merge_ms)
