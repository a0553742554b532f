"""PLAID baseline engine (Santhanam et al., CIKM 2022), the system EMVB is
measured against — counterpart of ``repro/core/plaid.py``.

Same index and centroid vocabulary as EMVB, but:

  1. retrieval: CS, then the plain top-nprobe over the full CS (no
     threshold pre-filter) and the IVF candidate bitmap;
  2. filtering: the centroid interaction S̄ of EVERY document of the
     index, non-candidates masked to ``-inf``, top-``n_docs``;
  3. decompression: the ``n_docs`` survivors' tokens rebuilt as centroid
     plus the b-bit residual (``residual.decode_residual``);
  4. late interaction: exact MaxSim (``interaction.maxsim``), top-k.

Phase 2 runs cinter's kernel over the whole corpus (``ops.cinter``, one
launch a query), as the reference writes it; on the CPU that is its plain
version (``cinter_batched_ref``), which materialises (docs, cap, n_q) and so
runs only at small widths. Every selection is ``topk.topk``'s: lax order,
the lowest index first on ties, so when fewer than ``n_docs`` candidates
exist the lowest-index ``-inf`` docs fill the cut, as in the reference.

The queries are batched (B, n_q, d); the phase entry points also take one
query (n_q, d), as the reference's do, and then return its unbatched
results. Each entry point runs on CUDA unless ``device="cpu"``.
``retrieve`` and ``phase_retrieval`` take ``cs=``, a CS computed elsewhere
(the tests inject the reference's, whose matmul bits differ: hazard 3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_on
from ..kernels import ops
from . import engine, interaction
from .index import PackedIndex
from .residual import decode_residual
from .topk import topk


@dataclasses.dataclass(frozen=True)
class PlaidConfig:
    """Static PLAID retrieval configuration (ref ``plaid.py:29``)."""

    n_q: int = 32
    nprobe: int = 4
    n_docs: int = 64      # docs decompressed and exactly scored
    k: int = 10


def _on(index: PackedIndex, x, device, dtype=None) -> torch.Tensor:
    """``x`` on the index's device, which must be the requested one."""
    resolve_on(index.codes.device, device)
    return torch.as_tensor(x, dtype=dtype, device=index.codes.device)


def _batch(x: torch.Tensor, single: bool) -> torch.Tensor:
    return x[None] if single else x


def _unbatch(x: torch.Tensor, single: bool) -> torch.Tensor:
    return x[0] if single else x


def _probe(index: PackedIndex, q: torch.Tensor, cfg: PlaidConfig,
           cs: Optional[torch.Tensor]):
    """Phase 1 on batched queries -> (cs (B, n_q, n_c), bitmap
    (B, n_docs) bool)."""
    if cs is None:
        cs = engine.centroid_scores(q, index.centroids)
    probe_ids = topk(cs, cfg.nprobe)[1]
    return cs, engine.candidate_bitmap(index.ivf, index.ivf_lens, probe_ids,
                                       index.codes.shape[0])


def _filter(index: PackedIndex, cs: torch.Tensor, bitmap: torch.Tensor,
            cfg: PlaidConfig) -> torch.Tensor:
    """Phase 2 on a batch -> sel2 (B, n_docs) int64: S̄ over the whole
    corpus (cinter's kernel, one launch a query), non-candidates -inf."""
    cs_t = engine._transposed(cs)
    sel = []
    for b in range(cs_t.shape[0]):
        sbar = ops.cinter(cs_t[b], index.codes, index.doc_lens)
        sbar = torch.where(bitmap[b], sbar, torch.full_like(sbar, -torch.inf))
        sel.append(topk(sbar, cfg.n_docs)[1])
    return torch.stack(sel)


def _decompress(index: PackedIndex, sel2: torch.Tensor) -> torch.Tensor:
    """Phase 3: sel2 (..., nd) -> embeddings (..., nd, cap, d), each token
    its centroid plus its decoded b-bit residual."""
    n_c, d = index.centroids.shape
    res = decode_residual(index.plaid_res[sel2], index.plaid_codec, d)
    cent = index.centroids[torch.clamp(index.codes[sel2], 0, n_c - 1).long()]
    return cent + res


def _token_mask(index: PackedIndex, sel2: torch.Tensor) -> torch.Tensor:
    """The prefix token mask of the selected docs only."""
    cap = index.codes.shape[1]
    return (torch.arange(cap, device=sel2.device)
            < index.doc_lens[sel2][..., None])


def _late(index: PackedIndex, q: torch.Tensor, emb: torch.Tensor,
          sel2: torch.Tensor, k: int):
    """Phase 4 on a batch -> (scores (B, k), ids (B, k) int32)."""
    scores = interaction.maxsim(q, emb, _token_mask(index, sel2))
    top, local = topk(scores, k)
    return top, torch.gather(sel2, 1, local).to(torch.int32)


def _queries(index: PackedIndex, queries, device) -> tuple:
    """Queries on the index's device as float32, with a batch axis ->
    (q (B, n_q, d), single)."""
    q = _on(index, queries, device, torch.float32)
    single = q.dim() == 2
    return _batch(q, single), single


def retrieve(index: PackedIndex, queries, cfg: PlaidConfig, *, cs=None,
             device=None):
    """PLAID retrieval (ref ``plaid.py:72``): queries (B, n_q, d) ->
    ``engine.RetrievalResult`` of (B, k) scores and doc ids, on CUDA unless
    ``device="cpu"``. ``cs`` (B, n_q, n_c) replaces the CS product."""
    q, _ = _queries(index, queries, device)
    cs, bitmap = _probe(index, q, cfg,
                        None if cs is None else _on(index, cs, device))
    sel2 = _filter(index, cs, bitmap, cfg)
    top, ids = _late(index, q, _decompress(index, sel2), sel2, cfg.k)
    return engine.RetrievalResult(top, ids)


# Phase-split entry points for the Fig. 1 breakdown (ref ``plaid.py:82``).

def phase_retrieval(index: PackedIndex, q, cfg: PlaidConfig, *, cs=None,
                    device=None):
    """PLAID phase 1 (ref ``:82``): the full top-nprobe probe -> (cs
    (n_q, n_c), candidate bitmap (n_docs,) bool) for one query (n_q, d), or
    with a leading B for a batch. ``cs`` replaces the CS product."""
    qb, single = _queries(index, q, device)
    if cs is not None:
        cs = _batch(_on(index, cs, device), single)
    cs, bitmap = _probe(index, qb, cfg, cs)
    return _unbatch(cs, single), _unbatch(bitmap, single)


def phase_filtering(index: PackedIndex, cs, bitmap, cfg: PlaidConfig, *,
                    device=None) -> torch.Tensor:
    """PLAID phase 2 (ref ``:92``): S̄ over every doc, non-candidates -inf
    -> the top ``n_docs`` ids (n_docs,) int32, or (B, n_docs) for a
    batch."""
    cs = _on(index, cs, device)
    single = cs.dim() == 2
    sel = _filter(index, _batch(cs, single),
                  _batch(_on(index, bitmap, device, torch.bool), single), cfg)
    return _unbatch(sel, single).to(torch.int32)


def phase_decompression(index: PackedIndex, sel2, *,
                        device=None) -> torch.Tensor:
    """PLAID phase 3 (ref ``:103``): the selected docs' tokens as centroid
    plus decoded b-bit residual -> (n_docs, cap, d), or with a leading B —
    the cost EMVB's PQ LUT removes."""
    return _decompress(index, _on(index, sel2, device).long())


def phase_late_interaction(index: PackedIndex, q, emb, sel2, k: int, *,
                           device=None):
    """PLAID phase 4 (ref ``:117``): exact MaxSim on the decompressed
    embeddings -> (top scores (k,), doc ids (k,) int32), or with a leading
    B."""
    qb, single = _queries(index, q, device)
    emb = _batch(_on(index, emb, device), single)
    top, ids = _late(index, qb, emb,
                     _batch(_on(index, sel2, device).long(), single), k)
    return _unbatch(top, single), _unbatch(ids, single)
