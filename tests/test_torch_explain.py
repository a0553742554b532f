"""The port's retrieval explain (``repro_torch.obs.explain``) against the
reference's (``repro.obs.explain``), case for case with tests/test_obs.py.

* In every dispatch mode of tests/test_obs.py (the reference math in both
  candidate modes, each megakernel alone, both fused, fused compact; plus
  the unfused kernel lane) every count field of ``explain`` equals the
  reference's, and so do the top-k ids and score bits: the reference's CS
  and LUT are injected (patched over ``engine.centroid_scores`` and
  ``engine._query_lut``), because the frameworks' matmul bits differ
  (hazard 3) and would move the probes, the funnel and the scores;
* without injection the port's explained top-k is the port's ``retrieve``,
  ids and score bits, in every mode;
* masked and filtered queries, the input checks, and ``explain_timeline``
  on the reference's saved timeline (loaded by the port): merged top-k,
  contributions summing to k, every generation's fingerprint and funnel
  equal to the reference's, with and without a raw ``FilterExpr``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import (ShardedTimeline, build_index, new_generation)
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.bitvector import Pred as RPred
from repro.core.bitvector import compile_filter as rcompile
from repro.core.pq import PQCodebooks as RPQ
from repro.core.pq import build_lut as ref_build_lut
from repro.data.synthetic import make_corpus
from repro_torch import obs as tobs
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.core.bitvector import Pred as TPred
from repro_torch.core.bitvector import compile_filter as tcompile

torch.set_num_threads(1)

# tests/test_obs.py's constants
CFG = teng.EngineConfig(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48,
                        k=10)
RETRIEVAL_CFGS = {
    "ref-score_all": CFG,
    "ref-compact": dataclasses.replace(CFG, candidate_mode="compact",
                                       cand_cap=600),
    "prefilter-megakernel": dataclasses.replace(
        CFG, use_kernels=True, fused_late_interaction=False),
    "pqinter-megakernel": dataclasses.replace(
        CFG, use_kernels=True, fused_prefilter=False),
    "unfused": dataclasses.replace(CFG, use_kernels=True,
                                   fused_prefilter=False,
                                   fused_late_interaction=False),
    "fused-score_all": dataclasses.replace(CFG, use_kernels=True),
    "fused-compact": dataclasses.replace(CFG, use_kernels=True,
                                         candidate_mode="compact",
                                         cand_cap=600),
}
COUNTS = ("n_q", "live_terms", "n_centroids", "centroids_probed",
          "probe_budget", "n_docs_corpus", "docs_passing_filter",
          "filter_selectivity", "candidates", "candidate_mode",
          "candidate_cap", "n_filter_budget", "n_filter_survivors",
          "phase3_docs_scored", "phase4_docs_scored", "scored_term_fraction",
          "k")


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def rcfg_of(cfg, doc_filter=None):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["doc_filter"] = doc_filter
    return reng.EngineConfig(**fields)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(5, n_docs=400, cap=24, min_len=8, n_queries=16,
                       n_topics=32)


@pytest.fixture(scope="module")
def preds(corpus):
    rng = np.random.default_rng(7)
    n = corpus.doc_embs.shape[0]
    return {"lang_en": rng.random(n) < 0.7, "recent": rng.random(n) < 0.4}


@pytest.fixture(scope="module")
def indexes(corpus, preds, tmp_path_factory):
    """The reference's obs index and the port's load of its saved bytes."""
    idx, meta = build_index(jax.random.PRNGKey(0), corpus.doc_embs,
                            corpus.doc_lens, n_centroids=128, m=8, nbits=4,
                            kmeans_iters=3, predicates=preds)
    path = rstore.save_index(str(tmp_path_factory.mktemp("ex") / "ix"), idx,
                             meta)
    tidx, tmeta = tstore.load_index(path, device="cpu")
    return (idx, meta), (tidx, tmeta)


@pytest.fixture(scope="module")
def timelines(corpus, preds, tmp_path_factory):
    c = corpus
    idx0, m0 = build_index(
        jax.random.PRNGKey(0), c.doc_embs[:200], c.doc_lens[:200],
        n_centroids=128, m=8, nbits=4, kmeans_iters=3,
        predicates={k: v[:200] for k, v in preds.items()})
    tl = ShardedTimeline.of((idx0, m0)).append(*new_generation(
        idx0, m0, c.doc_embs[200:], c.doc_lens[200:],
        predicates={k: v[200:] for k, v in preds.items()}))
    path = rstore.save_timeline(str(tmp_path_factory.mktemp("ex") / "tl"),
                                tl)
    return tl, tstore.load_timeline(path, device="cpu")


@jax.jit
def _ref_cs(centroids, q):
    return jax.vmap(lambda x: reng.centroid_scores(x, centroids))(q)


@jax.jit
def _ref_lut(rotation, codebooks, q):
    q_rot = jax.vmap(lambda x: x @ rotation)(q)
    return jax.vmap(lambda x: ref_build_lut(x, RPQ(codebooks)))(q_rot)


def _jnp(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


@pytest.fixture
def inject(monkeypatch):
    """The reference's CS and LUT in place of the port's two matmuls."""
    def cs(q, centroids, dtype="float32"):
        assert dtype == "float32"
        return torch.from_numpy(np.array(_ref_cs(*_jnp(centroids, q))))

    def lut(index, q):
        return torch.from_numpy(np.array(_ref_lut(*_jnp(
            index.opq_rotation, index.pq_codebooks, q))))
    monkeypatch.setattr(teng, "centroid_scores", cs)
    monkeypatch.setattr(teng, "_query_lut", lut)


def assert_same_explain(got, want):
    for f in COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.topk_ids, np.asarray(want.topk_ids))
    np.testing.assert_array_equal(bits(got.topk_scores),
                                  bits(want.topk_scores))
    assert set(got.phase_ms) == set(want.phase_ms)
    assert set(got.to_dict()) == set(want.to_dict())
    json.dumps(got.to_dict())


@pytest.mark.parametrize("name", sorted(RETRIEVAL_CFGS))
def test_explain_equals_reference(corpus, indexes, inject, name):
    (ridx, rmeta), (tidx, _) = indexes
    cfg = teng.adapt_config_to_corpus(RETRIEVAL_CFGS[name], rmeta.n_docs,
                                      rmeta.cap)
    q = corpus.queries[0]
    want = robs.explain.explain(ridx, q, rcfg_of(cfg))
    got = tobs.explain.explain(tidx, q, cfg, device="cpu")
    assert_same_explain(got, want)


@pytest.mark.parametrize("name", sorted(RETRIEVAL_CFGS))
def test_explain_topk_is_retrieve(corpus, indexes, name):
    """The port's own products: the explained top-k is the port's
    retrieve's, ids and score bits, and the funnel is consistent."""
    (_, rmeta), (tidx, _) = indexes
    cfg = teng.adapt_config_to_corpus(RETRIEVAL_CFGS[name], rmeta.n_docs,
                                      rmeta.cap)
    q = corpus.queries[0]
    rpt = tobs.explain.explain(tidx, q, cfg, device="cpu")
    ref = teng.retrieve(tidx, torch.from_numpy(q)[None], cfg, device="cpu")
    np.testing.assert_array_equal(rpt.topk_ids, ref.doc_ids[0].numpy())
    np.testing.assert_array_equal(bits(rpt.topk_scores),
                                  bits(ref.scores[0].numpy()))
    assert 0 < rpt.centroids_probed <= min(rpt.probe_budget,
                                           rpt.n_centroids)
    assert 0 < rpt.n_filter_survivors <= min(rpt.n_filter_budget,
                                             rpt.candidates)
    assert rpt.phase4_docs_scored == cfg.n_docs
    assert all(v >= 0 for v in rpt.phase_ms.values())


def test_explain_masked_and_filtered(corpus, indexes, inject):
    (ridx, rmeta), (tidx, tmeta) = indexes
    q = corpus.queries[1].copy()
    mask = np.ones(CFG.n_q, bool)
    mask[20:] = False
    q[20:] = 0.0
    want = robs.explain.explain(ridx, q, rcfg_of(CFG), q_mask=mask)
    got = tobs.explain.explain(tidx, q, CFG, q_mask=mask, device="cpu")
    assert_same_explain(got, want)
    assert got.live_terms == 20 and got.probe_budget == 20 * CFG.nprobe
    rplan = rcompile(RPred("lang_en") & ~RPred("recent"), rmeta.pred_names)
    tplan = tcompile(TPred("lang_en") & ~TPred("recent"), tmeta.pred_names)
    q = corpus.queries[2]
    for name in ("ref-score_all", "fused-score_all", "fused-compact"):
        cfg = teng.adapt_config_to_corpus(RETRIEVAL_CFGS[name],
                                          rmeta.n_docs, rmeta.cap)
        want = robs.explain.explain(ridx, q, rcfg_of(cfg), doc_filter=rplan)
        got = tobs.explain.explain(tidx, q, cfg, doc_filter=tplan,
                                   device="cpu")
        assert_same_explain(got, want)
        assert got.docs_passing_filter is not None


def test_explain_input_validation(corpus, indexes):
    _, (tidx, _) = indexes
    with pytest.raises(ValueError, match="per-query"):
        tobs.explain.explain(tidx, corpus.queries[:2], CFG, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tobs.explain.explain(tidx, corpus.queries[0][:5], CFG, device="cpu")
    with pytest.raises(ValueError, match="compiled FilterPlan"):
        tobs.explain.explain(tidx, corpus.queries[0], CFG,
                             doc_filter=TPred("lang_en"), device="cpu")
    with pytest.raises(ValueError, match="entries"):
        tobs.explain.explain(tidx, corpus.queries[0], CFG,
                             q_mask=np.ones(5, bool), device="cpu")


@pytest.mark.parametrize("name,filtered", [("ref-score_all", False),
                                           ("fused-score_all", True),
                                           ("unfused", False)])
def test_explain_timeline_equals_reference(corpus, timelines, inject, name,
                                           filtered):
    rtl, ttl = timelines
    cfg = RETRIEVAL_CFGS[name]
    q = corpus.queries[3 + filtered]
    want = robs.explain.explain_timeline(
        rtl, q, rcfg_of(cfg), doc_filter=RPred("lang_en") if filtered
        else None)
    got = tobs.explain.explain_timeline(
        ttl, q, cfg, doc_filter=TPred("lang_en") if filtered else None,
        device="cpu")
    for f in ("k", "n_generations", "n_epochs"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.topk_ids, np.asarray(want.topk_ids))
    np.testing.assert_array_equal(bits(got.topk_scores),
                                  bits(want.topk_scores))
    assert sum(g.contribution for g in got.generations) == cfg.k
    for g, w in zip(got.generations, want.generations):
        for f in ("epoch", "generation", "fingerprint", "offset", "n_docs",
                  "contribution"):
            assert getattr(g, f) == getattr(w, f), f
        assert_same_explain(g.funnel, w.funnel)
    assert set(got.to_dict()) == set(want.to_dict())
    json.dumps(got.to_dict())


def test_explain_timeline_topk_is_retrieve_timeline(corpus, timelines):
    _, ttl = timelines
    cfg = RETRIEVAL_CFGS["fused-score_all"]
    q = corpus.queries[5]
    rpt = tobs.explain.explain_timeline(ttl, q, cfg, device="cpu")
    ref = teng.retrieve_timeline(ttl, torch.from_numpy(q)[None], cfg,
                                 device="cpu")
    np.testing.assert_array_equal(rpt.topk_ids, ref.doc_ids[0].numpy())
    np.testing.assert_array_equal(bits(rpt.topk_scores),
                                  bits(ref.scores[0].numpy()))
    assert sum(g.contribution for g in rpt.generations) == cfg.k
    assert rpt.merge_ms >= 0


def test_explain_loads_lazily():
    """``repro_torch.obs`` imports without the engine; ``obs.explain``
    loads it on first access (in a fresh interpreter)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch.obs "
            "as o; assert 'repro_torch.obs.explain' not in sys.modules; "
            "assert 'repro_torch.core.engine' not in sys.modules; "
            "assert o.explain.QueryExplain.__name__ == 'QueryExplain'; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    with pytest.raises(AttributeError):
        tobs.no_such_thing
