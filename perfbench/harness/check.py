"""The comparison that decides ``correct``.

Each checked query's served top-k (doc ids and scores, as they reached the
host) is held against the plain reference's top-k of the same query, and
each served doc against the reference's own score for that doc:

* ``score_err``: the widest gap between a served score and the
  reference's Eq. 5/6 score of the doc served with it. It catches an
  answer altered where it is made: a wrong doc id or a wrong score.
* ``topk_gap``: the widest gap, rank by rank, between the served scores
  and the reference's top-k scores; infinite when the two hold a different
  number of finite scores. It catches a doc that should have been served
  and was not: a layer that lost candidates, survivors or winners, a
  query of the batch left out. Two docs swapped at a near-tie give a gap
  no wider than their scores' difference.
* ``filter_fail`` (filtered mixes): served docs with a finite score that
  fail their batch's filter, held to 0.

Each number is held to its cell's limit (``perfbench/limits/<cell>.json``).
"""
from __future__ import annotations

import math

import torch


def numbers(served: list, ref: list, fails_filter: list | None) -> dict:
    """``served`` and ``ref``: per checked batch, (scores (B, k), ids
    (B, k)) on the host, and the reference's Eq. 5/6 score of each served
    id under ``ref[i]["eq6_of"]``; ``fails_filter``: per batch, (B, k) bool
    of served ids failing its filter, or None."""
    score_err = topk_gap = 0.0
    fail = 0
    for i, ((sc, ids), r) in enumerate(zip(served, ref)):
        sc = sc.double()
        fin = torch.isfinite(sc)
        rs = r["scores"].double()
        rfin = torch.isfinite(rs)
        d = (sc - r["eq6_of"].double()).abs()
        score_err = max(score_err, float(torch.where(fin, d, 0.0).max())
                        if fin.any() else 0.0)
        if not torch.isfinite(d[fin]).all():
            score_err = math.inf
        if (fin != rfin).any():
            topk_gap = math.inf
        else:
            g = (sc - rs).abs()
            if fin.any():
                topk_gap = max(topk_gap, float(g[fin].max()))
        if fails_filter is not None:
            fail += int((fails_filter[i] & fin).sum())
    out = {"score_err": score_err, "topk_gap": topk_gap}
    if fails_filter is not None:
        out["filter_fail"] = fail
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    return all(v <= limits[k] for k, v in nums.items()), checks
