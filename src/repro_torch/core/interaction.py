"""Column-wise centroid interaction (EMVB C2) and PQ late interaction with
the dynamic term filter (C3+C4), paper §4.3-4.4 — counterpart of
``repro/core/interaction.py``.

Every function takes one query (``cs_t (n_c, n_q)``, ``lut (n_q, m, K)``)
or a batch of queries with a leading axis on every operand (``cs_t
(B, n_c, n_q)``, ``lut (B, n_q, m, K)``, ``codes (B, docs, cap)``, ...). The
sums follow the reference's order exactly: :func:`term_sum` is a
left-to-right chain over the terms and the residual LUT sum runs over
s = 0..m-1, so scores agree to the bit.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e9


def term_sum(colmax: torch.Tensor) -> torch.Tensor:
    """Sum (..., n_q) per-term maxima over the term axis in a fixed
    left-to-right chain (ref ``:23``) — never ``torch.sum``, whose
    reduction tree could change the last bit."""
    out = colmax[..., 0]
    for i in range(1, colmax.shape[-1]):
        out = out + colmax[..., i]
    return out


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` ((R, n_q) or (B, R, n_q)) at ``idx``
    ((...) or (B, ...)) -> idx.shape + (n_q,)."""
    if table.dim() == 2:
        return table[idx.long()]
    b = torch.arange(table.shape[0], device=table.device)
    b = b.reshape((-1,) + (1,) * (idx.dim() - 1))
    return table[b, idx.long()]


def gather_centroid_scores(cs_t: torch.Tensor,
                           codes: torch.Tensor) -> torch.Tensor:
    """P̃^T for a batch of docs: rows of CS^T at the token codes, clipped
    (ref ``:51``). cs_t (n_c, n_q), codes (docs, cap) -> (docs, cap, n_q);
    batched with a leading B on both."""
    return _rows(cs_t, torch.clamp(codes, 0, cs_t.shape[-2] - 1))


def _live(q_mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a (n_q,) or (B, n_q) term mask against (..., docs, n_q)."""
    if q_mask.dim() == 1:
        return q_mask
    return q_mask.reshape(q_mask.shape[0], *([1] * (ndim - 2)),
                          q_mask.shape[-1])


def centroid_interaction(cs_t: torch.Tensor, codes: torch.Tensor,
                         token_mask: torch.Tensor,
                         q_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Approximate passage score S̄ (paper Eq. 2; ref ``:61``): per term the
    max over valid tokens of the centroid score (invalid tokens are
    ``-1e9``), masked terms 0.0, then :func:`term_sum`. -> (docs,) or
    (B, docs)."""
    pt = gather_centroid_scores(cs_t, codes)
    pt = torch.where(token_mask[..., None], pt, torch.full_like(pt, NEG))
    colmax = torch.amax(pt, dim=-2)
    if q_mask is not None:
        colmax = torch.where(_live(q_mask, colmax.dim()), colmax,
                             torch.zeros_like(colmax))
    return term_sum(colmax)


def _lut_gather(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lut (n_q, m, K), idx (docs, cap, m) -> (docs, cap, n_q) (ref
    ``:143``); batched with a leading B on both. Per-subspace gathers over
    the transposed flat (m*K, n_q) table, accumulated s = 0..m-1."""
    n_q, m, k = lut.shape[-3:]
    flat = lut.reshape(*lut.shape[:-3], n_q, m * k).transpose(-1, -2)
    idx = idx.to(torch.int64)
    out = _rows(flat, idx[..., 0])
    for s in range(1, m):
        out = out + _rows(flat, idx[..., s] + s * k)
    return out


def late_interaction_pq(cs_t: torch.Tensor, lut: torch.Tensor,
                        codes: torch.Tensor, res_codes: torch.Tensor,
                        token_mask: torch.Tensor, th_r: Optional[float],
                        q_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """PQ late interaction (ref ``:96``): Eq. 5 when ``th_r`` is None, else
    Eq. 6 — per term, the max over tokens whose centroid score beats
    ``th_r``, falling back to the max over all tokens when none does.
    Invalid tokens are ``-1e9``; masked terms contribute 0.0.
    -> (docs,) or (B, docs)."""
    centroid = gather_centroid_scores(cs_t, codes)
    full = centroid + _lut_gather(lut, res_codes)
    neg = torch.full_like(full, NEG)
    valid = token_mask[..., None]
    full = torch.where(valid, full, neg)
    if th_r is None:
        colmax = torch.amax(full, dim=-2)
    else:
        keep = (centroid > th_r) & valid
        masked_max = torch.amax(torch.where(keep, full, neg), dim=-2)
        full_max = torch.amax(full, dim=-2)
        colmax = torch.where(keep.any(dim=-2), masked_max, full_max)
    if q_mask is not None:
        colmax = torch.where(_live(q_mask, colmax.dim()), colmax,
                             torch.zeros_like(colmax))
    return term_sum(colmax)


def scored_term_fraction(cs_t: torch.Tensor, codes: torch.Tensor,
                         token_mask: torch.Tensor, th_r: float,
                         q_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Share of (term, token) residual evaluations the Eq. 6 filter keeps
    (paper Fig. 5, right; ref ``:213``): one query's cs_t (n_c, n_q),
    codes/token_mask (docs, cap) -> a float32 scalar in [0, 1]. Masked terms
    count in neither the numerator nor the denominator."""
    keep = (gather_centroid_scores(cs_t, codes) > th_r) & token_mask[..., None]
    n_terms = torch.tensor(cs_t.shape[-1])
    if q_mask is not None:
        keep = keep & q_mask
        n_terms = q_mask.sum()
    den = torch.clamp(token_mask.sum() * n_terms, min=1)
    return keep.sum().to(torch.float32) / den.to(torch.float32)
