"""Plain reference of EMVB retrieval (Nardini et al., ECIR 2024, §4), in
PyTorch, written from the paper and from the data the benchmark made.

It imports torch and numpy only: nothing of the program under test, of
``jax`` or of the JAX package. It takes the planted data (centroids, token
codes, lengths, residual codes, PQ codebooks, the predicate plane) and the
queries, and works every step out again, one query at a time:

1. CS = q C^T in float32 with TF32 off, one product a query.
2. Each term's top-``nprobe`` centroids among those with CS > th, the rest
   offset by -1e6 (ties: the lower centroid id first).
3. The candidate bitmap: the union of the probed centroids' inverted
   lists, each list the ascending ids of the docs with a token on that
   centroid, cut at ``list_cap`` (its own IVF, taken from the codes).
   A filter drops the docs whose predicate bit is clear.
4. Eq. 4: F = the number of terms lit (CS > th) by some valid token of the
   doc; the top ``n_filter`` of F over the candidates, ties by the lower
   doc id, filled with the lowest non-candidate ids when short.
5. Eq. 2: S̄ = the terms' maxima of CS over the doc's valid tokens, summed
   term by term in order; failing docs -inf; the top ``n_docs``.
6. Eq. 5/6: a token's score for a term is its CS plus its residual's LUT
   sum (subspaces in order); a term's score is the max over the tokens
   whose CS beats ``th_r``, or over all valid tokens when none does; the
   terms summed in order; the top ``k``.

Ties in every cut go to the earlier position, as the paper's ranking of a
stable order does. ``precision="tf32"`` rounds the operands of the CS and
LUT products to TF32 (10-bit mantissa): the benchmark's control, the
nearest precision below the float32 the configuration states.

With ``counts=True`` it also reports the work the prefilter and the
late-interaction kernel need on these inputs (``harness/yardstick.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

NEG = -1e9           # a padding token's score (the paper's -inf stand-in)
IVF_BLOCK_DOCS = 1 << 20
EQ6_BLOCK_DOCS = 4096


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero (the tensor cores' input conversion)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def _exact_products():
    """TF32 and reduced-precision reductions off around the products, the
    caller's flags restored after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


def term_sum(colmax: torch.Tensor) -> torch.Tensor:
    """(..., n_q) -> (...): the terms added one after another, in order."""
    out = colmax[..., 0]
    for t in range(1, colmax.shape[-1]):
        out = out + colmax[..., t]
    return out


def stable_top(x: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the ``n`` largest entries of a 1-D tensor, descending,
    the earlier position first among equals."""
    return torch.sort(x, descending=True, stable=True).indices[:n]


class Reference:
    """The reference over one planted corpus and configuration."""

    def __init__(self, data, plane, config: dict, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision={precision!r}")
        eng = config["engine"]
        self.centroids, self.codes, self.lens, self.res, self.cb = data
        self.n_docs, self.cap = self.codes.shape
        self.n_c, self.d = self.centroids.shape
        self.m, self.ksub, self.dsub = self.cb.shape
        self.list_cap = config["list_cap"]
        self.th = float(np.float32(eng["th"]))
        self.th_r = None if eng["th_r"] is None \
            else float(np.float32(eng["th_r"]))
        self.nprobe, self.n_filter = eng["nprobe"], eng["n_filter"]
        self.n_win, self.k = eng["n_docs"], eng["k"]
        self.words = None if plane is None else plane.view(torch.int32)
        self.round = tf32 if precision == "tf32" else (lambda x: x)
        self.dev = self.codes.device
        self.tok = torch.arange(self.cap, device=self.dev)

    # -- step 1 and the LUT -------------------------------------------------
    def products(self, q: torch.Tensor):
        """-> (cs (B, n_q, n_c), lut (B, n_q, m, K)) for queries (B, n_q,
        d)."""
        r = self.round
        with _exact_products():
            table = r(self.centroids).T
            cs = torch.stack([r(x) @ table for x in q])
            qs = r(q).reshape(*q.shape[:2], self.m, self.dsub)
            lut = torch.einsum("btsd,skd->btsk", qs, r(self.cb))
        return cs, lut

    # -- steps 2 and 3 ------------------------------------------------------
    def probes(self, cs: torch.Tensor) -> torch.Tensor:
        """(B, n_q, n_c) -> (B, n_q, nprobe) centroid ids."""
        out = []
        for c in cs:
            masked = torch.where(c > self.th, c, c - 1e6)
            out.append(torch.sort(masked, dim=-1, descending=True,
                                  stable=True).indices[:, :self.nprobe])
        return torch.stack(out)

    def candidates(self, probes: torch.Tensor) -> torch.Tensor:
        """(B, n_q, nprobe) -> (B, n_docs) bool: the probed lists' union."""
        nb = probes.shape[0]
        probed, slot_of_probe = torch.unique(probes.reshape(nb, -1),
                                             return_inverse=True)
        slot_of = torch.full((self.n_c + 1,), -1, dtype=torch.int32,
                             device=self.dev)
        slot_of[probed] = torch.arange(probed.numel(), dtype=torch.int32,
                                       device=self.dev)
        keys = []
        for s in range(0, self.n_docs, IVF_BLOCK_DOCS):
            sl = slot_of[self.codes[s:s + IVF_BLOCK_DOCS].long()]
            doc, tok = (sl >= 0).nonzero(as_tuple=True)
            keys.append(sl[doc, tok].long() * self.n_docs + doc + s)
        keys = torch.unique(torch.cat(keys))          # by slot, then doc
        slot, doc = keys // self.n_docs, keys % self.n_docs
        count = torch.bincount(slot, minlength=probed.numel())
        start = torch.cumsum(count, 0) - count
        keep = torch.arange(slot.numel(), device=self.dev) - start[slot] \
            < self.list_cap
        slot, doc = slot[keep], doc[keep]
        bitmap = torch.zeros((nb, self.n_docs), dtype=torch.bool,
                             device=self.dev)
        for b in range(nb):
            member = torch.zeros(probed.numel(), dtype=torch.bool,
                                 device=self.dev)
            member[slot_of_probe[b]] = True
            bitmap[b, doc[member[slot]]] = True
        return bitmap

    def doc_pass(self, predicate) -> torch.Tensor | None:
        """(n_docs,) bool: the docs whose bit ``predicate`` is set."""
        if predicate is None:
            return None
        return ((self.words >> predicate) & 1) == 1

    # -- per-doc math -------------------------------------------------------
    def _valid(self, ids: torch.Tensor) -> torch.Tensor:
        return self.tok < self.lens[ids, None]

    def _gather_cs(self, cs_t: torch.Tensor, ids: torch.Tensor):
        codes = self.codes[ids].clamp(max=self.n_c - 1).long()
        return cs_t[codes]                                # (n, cap, n_q)

    def eq4(self, cs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """F of the docs ``ids`` for one query's CS (n_q, n_c)."""
        n_q = cs.shape[0]
        shifts = torch.arange(n_q, device=self.dev, dtype=torch.int64)
        words = ((cs > self.th).to(torch.int64) << shifts[:, None]).sum(0)
        w = words[self.codes[ids].clamp(max=self.n_c - 1).long()]
        w = torch.where(self._valid(ids), w, 0)
        acc = w[:, 0].clone()
        for j in range(1, self.cap):
            acc |= w[:, j]
        return ((acc[:, None] >> shifts) & 1).sum(1)

    def sbar(self, cs_t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Eq. 2 of the docs ``ids`` for one query's CS^T (n_c, n_q)."""
        g = self._gather_cs(cs_t, ids)
        g = torch.where(self._valid(ids)[..., None], g, NEG)
        return term_sum(torch.amax(g, dim=1))

    def eq6_parts(self, cs_t, flat_lut, ids):
        """The Eq. 5/6 scores of the docs ``ids`` and, per doc and term, the
        tokens kept by th_r (n, n_q) and the valid tokens (n,)."""
        cent = self._gather_cs(cs_t, ids)
        rc = self.res[ids].long()
        r = flat_lut[rc[..., 0]]
        for s in range(1, self.m):
            r = r + flat_lut[rc[..., s] + s * self.ksub]
        valid = self._valid(ids)[..., None]
        full = torch.where(valid, cent + r, NEG)
        if self.th_r is None:
            return term_sum(torch.amax(full, dim=1)), None, valid
        keep = (cent > self.th_r) & valid
        kept = torch.amax(torch.where(keep, full, NEG), dim=1)
        colmax = torch.where(keep.any(1), kept, torch.amax(full, dim=1))
        return term_sum(colmax), keep, valid

    # -- one batch ----------------------------------------------------------
    def run(self, q: torch.Tensor, predicate=None, score_ids=None,
            counts: bool = False) -> dict:
        """One batch (B, n_q, d) under the filter on ``predicate`` (or
        none). -> {"scores" (B, k) float32, "ids" (B, k) int64, on the
        host; "eq6_of" (B, K): the Eq. 5/6 score of each id of
        ``score_ids`` (B, K), -inf for an id out of range; "counts"}."""
        nb, n_q, _ = q.shape
        cs, lut = self.products(q)
        bitmap = self.candidates(self.probes(cs))
        dp = self.doc_pass(predicate)
        cand = bitmap if dp is None else bitmap & dp
        scores, ids, eq6_of, per_query = [], [], [], []
        for b in range(nb):
            cs_t = cs[b].T.contiguous()
            flat = lut[b].reshape(n_q, -1).T.contiguous()   # (m K, n_q)
            c_ids = cand[b].nonzero()[:, 0]
            f = self.eq4(cs[b], c_ids)
            sel1 = c_ids[torch.sort(f, descending=True, stable=True)
                         .indices[:self.n_filter]]
            if sel1.numel() < self.n_filter:
                fill = (~cand[b]).nonzero()[:self.n_filter - sel1.numel(), 0]
                sel1 = torch.cat([sel1, fill])
            sb = self.sbar(cs_t, sel1)
            if dp is not None:
                sb = torch.where(dp[sel1], sb, -torch.inf)
            win = stable_top(sb, self.n_win)
            sel2 = sel1[win]
            sc, keep, valid = self._eq6_with_parts(cs_t, flat, sel2)
            if dp is not None:
                sc = torch.where(dp[sel2], sc, -torch.inf)
            top = stable_top(sc, self.k)
            scores.append(sc[top])
            ids.append(sel2[top])
            if score_ids is not None:
                eq6_of.append(self._score_given(cs_t, flat,
                                                score_ids[b].to(self.dev)))
            if counts:
                per_query.append(self._query_counts(
                    cs_t, sel1, sel2, sb[win], keep, valid, dp))
        out = {"scores": torch.stack(scores).float().cpu(),
               "ids": torch.stack(ids).cpu()}
        if score_ids is not None:
            out["eq6_of"] = torch.stack(eq6_of).cpu()
        if counts:
            out["counts"] = self._batch_counts(cs, bitmap, dp, per_query)
        return out

    def _eq6_with_parts(self, cs_t, flat, ids):
        """:meth:`eq6_parts` in blocks of docs."""
        parts = [self.eq6_parts(cs_t, flat, ids[s:s + EQ6_BLOCK_DOCS])
                 for s in range(0, ids.numel(), EQ6_BLOCK_DOCS)]
        sc = torch.cat([p[0] for p in parts])
        keep = None if parts[0][1] is None else torch.cat([p[1] for p in parts])
        return sc, keep, torch.cat([p[2] for p in parts])

    def _score_given(self, cs_t, flat, ids):
        """Eq. 5/6 scores of served ids; -inf for an id out of range."""
        ok = (ids >= 0) & (ids < self.n_docs)
        sc = self._eq6_with_parts(cs_t, flat,
                                  ids.clamp(0, self.n_docs - 1).long())[0]
        return torch.where(ok, sc, -torch.inf)

    # -- the work the kernels need ------------------------------------------
    def _query_counts(self, cs_t, sel1, sel2, sb_win, keep, valid, dp):
        """One query's survivors and winners, as the yardstick counts them:
        tokens of the survivors the pqinter reads (passing ones only under
        a filter), the CS^T rows those tokens touch, the winners' tokens,
        and what Eq. 6 needs of the winners: the tokens whose residuals it
        reads and the (token, term) pairs it scores."""
        lens = self.lens[sel1].long()
        if dp is not None:
            lens = torch.where(dp[sel1], lens, 0)
        valid1 = self.tok < lens[:, None]
        codes = self.codes[sel1].clamp(max=self.n_c - 1).long()
        rows = torch.zeros(self.n_c, dtype=torch.bool, device=self.dev)
        rows[codes[valid1]] = True
        real = torch.isfinite(sb_win)
        v = valid[..., 0] & real[:, None]                   # (n_win, cap)
        out = {"survivor_tokens": int(lens.sum()),
               "rows_touched": int(rows.sum()),
               "winner_tokens": int(v.sum())}
        if keep is None:
            n_q = cs_t.shape[1]
            out["eq6_tokens"] = out["winner_tokens"]
            out["eq6_pairs"] = out["winner_tokens"] * n_q
            return out
        kept = keep & real[:, None, None]                   # (n, cap, n_q)
        per_term = kept.sum(1)                              # (n, n_q)
        falls_back = (per_term == 0).any(1) & real          # a term keeps none
        tokens = torch.where(falls_back[:, None], v, kept.any(2))
        pairs = torch.where(per_term > 0, per_term, v.sum(1, keepdim=True))
        out["eq6_tokens"] = int(tokens.sum())
        out["eq6_pairs"] = int((pairs * real[:, None]).sum())
        return out

    def _batch_counts(self, cs, bitmap, dp, per_query) -> dict:
        nb, n_q, n_c = cs.shape
        any_cand = bitmap.any(0)
        words_docs = 0
        if dp is not None:
            words_docs = int(any_cand.sum())
            any_cand = (bitmap & dp).any(0)
        pre = {"batch": nb, "n_q": n_q, "n_c": n_c, "n_docs": self.n_docs,
               "cs_bytes": cs.element_size(), "n_filter": self.n_filter,
               "words_docs": words_docs,
               "cand_docs": int(any_cand.sum()),
               "cand_tokens": int(self.lens[any_cand].long().sum())}
        late = {"batch": nb, "n_q": n_q, "n_filter": self.n_filter,
                "n_docs": self.n_win, "k": self.k, "m": self.m,
                "ksub": self.ksub, "cs_bytes": cs.element_size(),
                "filtered": dp is not None}
        for key in per_query[0]:
            late[key] = sum(p[key] for p in per_query)
        return {"prefilter": pre, "pqinter": late}
