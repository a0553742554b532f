"""Column-wise centroid interaction (EMVB C2) and PQ late interaction with
the dynamic term filter (C3+C4), paper §4.3-4.4 — counterpart of
``repro/core/interaction.py``.

Every function takes one query (``cs_t (n_c, n_q)``, ``lut (n_q, m, K)``)
or a batch of queries with a leading axis on every operand (``cs_t
(B, n_c, n_q)``, ``lut (B, n_q, m, K)``, ``codes (B, docs, cap)``, ...). The
sums follow the reference's order exactly: :func:`term_sum` is a
left-to-right chain over the terms and the residual LUT sum runs over
s = 0..m-1, so scores agree to the bit.

CS may be float32 or bf16 (``cs_dtype="bfloat16"``, paper §6). On bf16 the
functions keep the reference's dtypes: S̄ is bf16 (per-term bf16 maxima,
:func:`term_sum` in float32 rounded once), Eq. 5/6 adds the widened bf16
centroid score to the float32 residual, and every threshold is compared in
the dtype the reference's promotion gives it (``precision.greater``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .precision import greater
from .topk import topk

NEG = -1e9


def term_sum(colmax: torch.Tensor) -> torch.Tensor:
    """Sum (..., n_q) per-term maxima over the term axis in a fixed
    left-to-right chain (ref ``:23``) — never ``torch.sum``, whose
    reduction tree could change the last bit. Half-precision maxima are
    widened to float32, chained, and the sum rounded once to their dtype."""
    acc = colmax
    if colmax.dtype in (torch.bfloat16, torch.float16):
        acc = colmax.float()
    out = acc[..., 0]
    for i in range(1, acc.shape[-1]):
        out = out + acc[..., i]
    return out.to(colmax.dtype)


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
    ``-1e9`` in the CS dtype), masked terms 0.0, then :func:`term_sum`.
    -> (docs,) or (B, docs), in the CS dtype."""
    pt = gather_centroid_scores(cs_t, codes)
    pt = torch.where(token_mask[..., None], pt, torch.full_like(pt, NEG))
    colmax = torch.amax(pt, dim=-2)
    if q_mask is not None:
        colmax = torch.where(_live(q_mask, colmax.dim()), colmax,
                             torch.zeros_like(colmax))
    return term_sum(colmax)


def centroid_interaction_batch(cs_t: torch.Tensor, codes: torch.Tensor,
                               token_mask: torch.Tensor) -> torch.Tensor:
    """S̄ of a batch of queries (ref ``:80``): cs_t (B, n_c, n_q),
    codes/token_mask (B, docs, cap) -> (B, docs);
    :func:`centroid_interaction` with its leading batch axis."""
    return centroid_interaction(cs_t, codes, token_mask)


def maxsim(q: torch.Tensor, doc_emb: torch.Tensor,
           token_mask: torch.Tensor) -> torch.Tensor:
    """Exact late interaction (paper Eq. 3; ref ``:86``) on full-precision
    embeddings: per term the max over valid tokens of ``q . emb`` (invalid
    tokens ``-1e9``), summed over the terms. q (n_q, d), doc_emb
    (docs, cap, d), token_mask (docs, cap) -> (docs,); batched with a
    leading B on all three. An einsum, as the reference's: its float32 bits
    differ from XLA's (hazard 3), so its scores agree at rtol 1e-5."""
    sim = torch.einsum("...qd,...ntd->...nqt", q, doc_emb)
    sim = torch.where(token_mask[..., None, :], sim, torch.full_like(sim, NEG))
    return torch.amax(sim, dim=-1).sum(dim=-1)


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
                        centroid: Optional[torch.Tensor] = None,
                        q_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """PQ late interaction (ref ``:96``): Eq. 5 when ``th_r`` is None, else
    Eq. 6 — per term, the max over tokens whose centroid score beats
    ``th_r``, falling back to the max over all tokens when none does.
    ``centroid`` (docs, cap, n_q), when given, is the centroid term in place
    of the CS^T gather (the engine's exact float32 term under bf16 CS);
    Eq. 6 tests it. Invalid tokens are ``-1e9``; masked terms contribute
    0.0. -> (docs,) or (B, docs) float32."""
    if centroid is None:
        centroid = gather_centroid_scores(cs_t, codes)
    full = centroid.float() + _lut_gather(lut, res_codes)
    neg = torch.full_like(full, NEG)
    valid = token_mask[..., None]
    full = torch.where(valid, full, neg)
    if th_r is None:
        colmax = torch.amax(full, dim=-2)
    else:
        keep = greater(centroid, th_r) & valid
        masked_max = torch.amax(torch.where(keep, full, neg), dim=-2)
        full_max = torch.amax(full, dim=-2)
        colmax = torch.where(keep.any(dim=-2), masked_max, full_max)
    if q_mask is not None:
        colmax = torch.where(_live(q_mask, colmax.dim()), colmax,
                             torch.zeros_like(colmax))
    return term_sum(colmax)


def _f32(v: float) -> float:
    """A constant rounded to float32."""
    return float(np.float32(v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (the float64
    product of two floats is exact); b and c are float32 values."""
    return (a.double() * b + c).float()


_F32_TINY = _f32(1.1754943508222875e-38)   # the smallest normal float32
_EXP_POLY = tuple(_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 results to zero."""
    return torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)


def _reference_exp(t: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` with XLA's CPU bits: the Cephes polynomial with fused
    multiply-adds, the input clamped to +-88.8, subnormal results flushed
    to zero."""
    t = torch.clamp(t, _f32(-88.8), _f32(88.8))
    fx = torch.floor(t * _f32(1.44269504088896341) + 0.5)
    r = _fma(-fx, _f32(-2.12194440e-4), _fma(-fx, 0.693359375, t))
    y = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for p in _EXP_POLY[2:]:
        y = _fma(y, r, p)
    y = _fma(y, (r * r).double(), r) + 1.0
    return _flush(y * torch.pow(2.0, fx))


def reference_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic with the reference's bits, in float32: ``jax.nn.sigmoid``
    lowers to ``1 / (1 + exp(-x))`` on XLA's CPU, and XLA flushes subnormal
    results to zero. ``torch.sigmoid`` differs from it in the last bit on
    some inputs, which changes ties in the ranking of
    :func:`late_interaction_pq_compact`. float32 ``x`` is computed in
    float32. bf16 ``x`` as XLA computes it, each step in float32 rounded to
    bf16 but the last: ``1 / bf16(1 + bf16(exp(-x)))``. That is what XLA
    feeds a float32 sum inside a jitted function (the rank of
    :func:`late_interaction_pq_compact`); rounded to bf16 it is
    ``jax.nn.sigmoid``'s own bf16 result."""
    if x.dtype == torch.bfloat16:
        e = _reference_exp((-x).float()).to(torch.bfloat16)
        d = (1.0 + e.float()).to(torch.bfloat16)
        return _flush(1.0 / d.float())
    return _flush(1.0 / (1.0 + _reference_exp(-x)))


def late_interaction_pq_compact(cs_t: torch.Tensor, lut: torch.Tensor,
                                codes: torch.Tensor, res_codes: torch.Tensor,
                                token_mask: torch.Tensor, th_r: float,
                                cap_c: int,
                                q_mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Eq. 6 over a per-token compaction (ref ``:164``): a token is kept
    when its centroid's largest live term score beats ``th_r`` (keymax);
    each doc's ``cap_c`` buffer holds its kept tokens first, then the rest
    by keymax (a lax-order selection on ``2 * keep + sigmoid(keymax)``),
    and Eq. 6 runs on the buffer, a term with no kept token falling back to
    the max over it. On bf16 CS keymax is bf16, and its logistic is the
    bf16 one of :func:`reference_sigmoid`, as the reference's jitted engine
    computes it. Batched with a leading B on every operand."""
    n_c = cs_t.shape[-2]
    if q_mask is not None:
        live = q_mask[..., None, :]
        cs_live = torch.where(live, cs_t, torch.full_like(cs_t, NEG))
    else:
        cs_live = cs_t
    row_max = torch.amax(cs_live, dim=-1)                   # (..., n_c)
    idx = torch.clamp(codes, 0, n_c - 1).long()
    if row_max.dim() == 1:
        keymax = row_max[idx]
    else:
        keymax = torch.gather(row_max, 1, idx.reshape(idx.shape[0], -1)
                              ).reshape(idx.shape)
    keep = greater(keymax, th_r) & token_mask
    rank = torch.where(token_mask,
                       keep.to(torch.float32) * 2.0
                       + reference_sigmoid(keymax),
                       torch.full(keymax.shape, -1.0, device=keymax.device))
    sel = topk(rank, cap_c)[1]                         # (..., docs, cap_c)
    codes_c = torch.gather(codes, -1, sel)
    mask_c = torch.gather(token_mask, -1, sel)
    res_c = torch.gather(res_codes, -2, sel[..., None].expand(
        *sel.shape, res_codes.shape[-1]))
    centroid = gather_centroid_scores(cs_t, codes_c)
    full = centroid.float() + _lut_gather(lut, res_c)
    neg = torch.full_like(full, NEG)
    full = torch.where(mask_c[..., None], full, neg)
    keep_t = greater(centroid, th_r) & mask_c[..., None]
    masked_max = torch.amax(torch.where(keep_t, full, neg), dim=-2)
    comp_max = torch.amax(full, dim=-2)
    colmax = torch.where(keep_t.any(dim=-2), masked_max, comp_max)
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
    keep = greater(gather_centroid_scores(cs_t, codes), th_r) \
        & token_mask[..., None]
    n_terms = torch.tensor(cs_t.shape[-1])
    if q_mask is not None:
        keep = keep & q_mask
        n_terms = q_mask.sum()
    den = torch.clamp(token_mask.sum() * n_terms, min=1)
    return keep.sum().to(torch.float32) / den.to(torch.float32)


def token_compaction_mask(cs_t: torch.Tensor, codes: torch.Tensor,
                          token_mask: torch.Tensor, th_r: float
                          ) -> torch.Tensor:
    """Tokens whose residuals must be scored under the per-token filter
    (ref ``:230``): a valid token whose centroid's largest term score beats
    ``th_r`` (compared in the reference's dtype, ``precision.greater``).
    cs_t (n_c, n_q), codes/token_mask (docs, cap) -> (docs, cap) bool;
    batched with a leading B."""
    centroid = gather_centroid_scores(cs_t, codes)
    return greater(torch.amax(centroid, dim=-1), th_r) & token_mask
