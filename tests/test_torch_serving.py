"""The port's serving subsystem (``repro_torch.serving``), case for case
with tests/test_serving.py, and against the reference's service.

* ``RetrievalService(timeline, cfg, device="cpu").query(q)`` returns the
  port's ``retrieve_timeline(timeline, q, cfg)`` ids and float32 score
  bits — cold and warm, on the reference-math lane and both kernel lanes,
  in both candidate modes, on bf16 CS, with masks, with filters (a compiled
  plan and a raw expression), across partial-warm batches, staged swaps,
  ``add_passages`` and ``new_generation``;
* every ticket of ``submit``/``flush`` equals ``retrieve_timeline`` on the
  same padded batch (the reference's own padded == prefix does not hold to
  the score bit on its service path: ROADMAP Queue 3);
* the port's service equals the reference's service on the reference's
  saved timeline, the reference's CS and LUT injected through
  ``plan_factory`` (the frameworks' matmul bits differ in general);
* ``query_fingerprint`` and ``config_fingerprint`` give the reference's
  strings; the cache, batcher and metrics behave as the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import build_index as ref_build_index
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.pq import PQCodebooks as RPQ
from repro.core.pq import build_lut as ref_build_lut
from repro.data.synthetic import make_corpus
from repro import serving as rserving
from repro_torch.core import (EngineConfig, ShardedTimeline, build_index,
                              bytes_per_embedding, generation_footprint,
                              new_generation, prune_queries,
                              retrieve_timeline, timeline_footprint)
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.serving import (LatencyStats, MicroBatcher, ResultCache,
                                 RetrievalService, ServiceMetrics,
                                 config_fingerprint, pad_query,
                                 query_fingerprint)

torch.set_num_threads(1)

# The reference's tests/test_serving.py constants.
CFG = EngineConfig(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48, k=10)
BUILD = dict(n_centroids=128, m=8, nbits=4, kmeans_iters=3)

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
    "fused-bf16": dataclasses.replace(CFG, use_kernels=True,
                                      cs_dtype="bfloat16"),
}
NAMES = ("lang_en", "recent")


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def assert_same(got, want):
    """ids and float32 score bits (got: port tensors or numpy; want: any)."""
    gi = got.doc_ids.numpy() if torch.is_tensor(got.doc_ids) \
        else np.asarray(got.doc_ids)
    wi = want.doc_ids.numpy() if torch.is_tensor(want.doc_ids) \
        else np.asarray(want.doc_ids)
    np.testing.assert_array_equal(gi, wi)
    gs = got.scores.numpy() if torch.is_tensor(got.scores) else got.scores
    ws = want.scores.numpy() if torch.is_tensor(want.scores) \
        else want.scores
    np.testing.assert_array_equal(bits(gs), bits(ws))


def preds(lo, hi):
    rng = np.random.default_rng(7)
    cols = {"lang_en": rng.random(800) < 0.7, "recent": rng.random(800) < 0.4}
    return {n: cols[n][lo:hi] for n in NAMES}


@pytest.fixture(scope="module")
def serve_corpus():
    # 800 docs: 500 in the initial timeline, 100 for add_passages, 200 for
    # new_generation; queries plant ground truth across the whole range.
    return make_corpus(3, n_docs=800, cap=24, min_len=8, n_queries=32,
                       n_topics=32)


def port_timeline(c, predicates=False):
    """Generations of 200/200/100 docs built by the port on the CPU (the
    last one small and still growing — the add_passages target)."""
    p = preds if predicates else (lambda lo, hi: None)
    idx0, m0 = build_index(0, c.doc_embs[:200], c.doc_lens[:200],
                           predicates=p(0, 200), device="cpu", **BUILD)
    tl = ShardedTimeline.of((idx0, m0))
    for lo, hi in ((200, 400), (400, 500)):
        tl = tl.append(*new_generation(idx0, m0, c.doc_embs[lo:hi],
                                       c.doc_lens[lo:hi], p(lo, hi),
                                       device="cpu"))
    return tl


@pytest.fixture(scope="module")
def base_timeline(serve_corpus):
    return port_timeline(serve_corpus)


@pytest.fixture(scope="module")
def filtered_timeline(serve_corpus):
    return port_timeline(serve_corpus, predicates=True)


# ---------------------------------------------------------------------------
# The acceptance contract: service == uncached retrieve_timeline, bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RETRIEVAL_CFGS))
def test_service_matches_timeline_cold_and_warm(serve_corpus, base_timeline,
                                                name):
    cfg = RETRIEVAL_CFGS[name]
    q = serve_corpus.queries[:8]
    ref = retrieve_timeline(base_timeline, q, cfg, device="cpu")
    svc = RetrievalService(base_timeline, cfg, device="cpu")
    cold = svc.query(q)
    warm = svc.query(q)
    for res in (cold, warm):
        assert_same(res, ref)
    assert svc.cache.hits == (len(base_timeline) - 1) * 8
    assert svc.metrics.warm_queries == 8


def test_service_masked_pruned_queries(serve_corpus, base_timeline):
    qp, qm = prune_queries(torch.from_numpy(serve_corpus.queries[:8]),
                           keep=16, device="cpu")
    ref = retrieve_timeline(base_timeline, qp, CFG, qm, device="cpu")
    svc = RetrievalService(base_timeline, CFG, device="cpu")
    for _ in range(2):  # cold, then warm
        assert_same(svc.query(qp.numpy(), qm.numpy()), ref)
    assert svc.cache.hits > 0


@pytest.mark.parametrize("pad_miss_lane", [True, False],
                         ids=["padded-miss-lane", "tight-miss-lane"])
def test_service_partial_warm_batch(serve_corpus, base_timeline,
                                    pad_miss_lane):
    c = serve_corpus
    svc = RetrievalService(base_timeline, CFG, pad_miss_lane=pad_miss_lane,
                           device="cpu")
    svc.query(c.queries[:8])                                  # cache 0..7
    mix = np.concatenate([c.queries[4:8], c.queries[8:12]])   # half warm
    assert_same(svc.query(mix),
                retrieve_timeline(base_timeline, mix, CFG, device="cpu"))
    assert svc.metrics.warm_queries == 4


# ---------------------------------------------------------------------------
# Cache correctness under mutation
# ---------------------------------------------------------------------------

def test_warm_cache_add_passages_not_stale(serve_corpus, base_timeline):
    c = serve_corpus
    q = c.queries[:8]
    svc = RetrievalService(base_timeline, CFG, device="cpu")
    svc.query(q)                                              # cold fill
    svc.query(q)                                              # warm
    hits_before = svc.cache.hits
    assert hits_before == 16                                  # 2 gens x 8

    svc.add_passages(c.doc_embs[500:600], c.doc_lens[500:600])
    res = svc.query(q)
    assert_same(res, retrieve_timeline(svc.timeline, q, CFG, device="cpu"))
    assert svc.cache.hits - hits_before == 16
    new_q = np.nonzero((c.gt_doc >= 500) & (c.gt_doc < 600))[0][:4]
    assert new_q.size >= 2
    ids = svc.query(c.queries[new_q]).doc_ids.numpy()
    hits = [g in ids[i] for i, g in enumerate(c.gt_doc[new_q])]
    assert np.mean(hits) >= 0.5, (hits, ids, c.gt_doc[new_q])


def test_warm_cache_new_generation_reuses_old_entries(serve_corpus,
                                                      base_timeline):
    c = serve_corpus
    q = c.queries[:8]
    svc = RetrievalService(base_timeline, CFG, device="cpu")
    svc.query(q)                                              # cold fill
    svc.new_generation(c.doc_embs[600:800], c.doc_lens[600:800])
    assert len(svc.timeline) == 4

    h0, m0 = svc.cache.hits, svc.cache.misses
    res = svc.query(q)
    assert svc.cache.hits - h0 == 16
    assert svc.cache.misses - m0 == 8
    assert_same(res, retrieve_timeline(svc.timeline, q, CFG, device="cpu"))
    h1 = svc.cache.hits
    svc.query(q)
    assert svc.cache.hits - h1 == 24


# ---------------------------------------------------------------------------
# Filters, staged swaps
# ---------------------------------------------------------------------------

def port_filters(kind):
    expr = tbv.Pred("recent") & ~tbv.Pred("lang_en")
    return expr if kind == "expr" else tbv.compile_filter(expr, NAMES)


@pytest.mark.parametrize("kind", ["plan", "expr"])
@pytest.mark.parametrize("name", ["ref-score_all", "fused-score_all",
                                  "unfused", "fused-compact"])
def test_service_filtered_matches_timeline(serve_corpus, filtered_timeline,
                                           name, kind):
    """Filtered cold and warm results equal the filtered timeline; the
    filter joins the cache key, so unfiltered partials of the same queries
    never answer a filtered batch (and the reverse)."""
    cfg = RETRIEVAL_CFGS[name]
    tl = filtered_timeline
    q = serve_corpus.queries[:6]
    filt = port_filters(kind)
    ref = retrieve_timeline(tl, q, cfg, doc_filter=filt, device="cpu")
    plain = retrieve_timeline(tl, q, cfg, device="cpu")
    svc = RetrievalService(tl, cfg, device="cpu")
    assert_same(svc.query(q), plain)
    for _ in range(2):
        assert_same(svc.query(q, doc_filter=filt), ref)
    assert_same(svc.query(q), plain)
    assert svc.metrics.filtered_queries == 12
    ok = preds(0, 500)
    ok = ok["recent"] & ~ok["lang_en"]
    ids, sc = ref.doc_ids.numpy(), ref.scores.numpy()
    assert ok[ids[np.isfinite(sc)]].all()


def test_submit_batches_filters_homogeneously(serve_corpus,
                                              filtered_timeline):
    """Alternating filters close batches early (FIFO); every ticket equals
    retrieve_timeline on the same padded batch under its filter."""
    c = serve_corpus
    tl = filtered_timeline
    filt = port_filters("plan")
    svc = RetrievalService(tl, CFG, max_batch=4, device="cpu")
    plan = [None, None, filt, filt, None]
    tickets = [svc.submit(c.queries[i][:12 + 4 * i], doc_filter=f)
               for i, f in enumerate(plan)]
    svc.flush()
    assert svc.metrics.batches == 3
    for run in ((0, 2), (2, 4), (4, 5)):
        rows = range(*run)
        qs, ms = zip(*(pad_query(c.queries[i][:12 + 4 * i], CFG.n_q)
                       for i in rows))
        want = retrieve_timeline(tl, np.stack(qs), CFG, np.stack(ms),
                                 doc_filter=plan[run[0]], device="cpu")
        for j, i in enumerate(rows):
            s, ids = tickets[i].result()
            np.testing.assert_array_equal(ids, want.doc_ids.numpy()[j])
            np.testing.assert_array_equal(bits(s),
                                          bits(want.scores.numpy()[j]))


def test_staged_swap_answers_pending_against_old_snapshot(serve_corpus,
                                                          base_timeline):
    """A swap staged behind pending tickets installs at the flush boundary:
    the tickets are answered against the snapshot they were accepted
    under, later queries against the new one."""
    c = serve_corpus
    svc = RetrievalService(base_timeline, CFG, max_batch=8, device="cpu")
    tickets = [svc.submit(c.queries[i]) for i in range(5)]
    svc.new_generation(c.doc_embs[600:800], c.doc_lens[600:800])
    assert len(svc.timeline) == 3 and svc.latest_timeline.n_generations == 4
    svc.flush()
    assert len(svc.timeline) == 4
    assert svc.metrics.deferred_swaps == 1
    old = retrieve_timeline(base_timeline, c.queries[:5], CFG, device="cpu")
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(t.result()[1], old.doc_ids.numpy()[i])
        np.testing.assert_array_equal(bits(t.result()[0]),
                                      bits(old.scores.numpy()[i]))
    q = c.queries[:5]
    assert_same(svc.query(q),
                retrieve_timeline(svc.timeline, q, CFG, device="cpu"))


def test_swaps_hash_only_changed_generations(serve_corpus, base_timeline,
                                             monkeypatch):
    """A swap's new snapshot hashes only the generations it changed (the
    content fingerprints stay index_fingerprint's); a tensor changed in
    place is hashed anew."""
    c = serve_corpus
    tl = ShardedTimeline(tuple(g._replace(**{f: getattr(g, f).clone()
                                             for f in g._fields})
                               for g in base_timeline.generations),
                         base_timeline.metas)
    want = base_timeline.fingerprints
    calls = []
    real = tstore.index_fingerprint
    monkeypatch.setattr(tstore, "index_fingerprint",
                        lambda g, **kw: calls.append(1) or real(g, **kw))
    assert tstore.ShardedTimeline(tl.generations, tl.metas).fingerprints \
        == want and len(calls) == 3
    calls.clear()
    svc = RetrievalService(tl, CFG, device="cpu")
    assert len(calls) == 3
    svc.add_passages(c.doc_embs[500:520], c.doc_lens[500:520])
    svc.new_generation(c.doc_embs[600:700], c.doc_lens[600:700])
    assert len(calls) == 5
    assert svc.timeline.fingerprints == tuple(
        real(g) for g in svc.timeline.generations)
    gen = svc.timeline.generations[1]
    gen.codes.add_(0)                               # in place: version + 1
    svc.update_timeline(ShardedTimeline(svc.timeline.generations,
                                        svc.timeline.metas))
    assert len(calls) == 6
    assert svc._gen_fps[0][1] == real(gen)
    # a service over a timeline whose fingerprints are known hashes nothing
    other = RetrievalService(svc.timeline, CFG, device="cpu")
    other.add_passages(c.doc_embs[700:720], c.doc_lens[700:720])
    assert len(calls) == 7


def test_service_refuses_a_timeline_elsewhere(base_timeline):
    with pytest.raises(ValueError, match="lives on cpu"):
        RetrievalService(base_timeline, CFG, device="meta")


# ---------------------------------------------------------------------------
# Port against the reference's service, CS and LUT injected
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_timeline(serve_corpus):
    c = serve_corpus
    idx0, m0 = ref_build_index(jax.random.PRNGKey(0), c.doc_embs[:200],
                               c.doc_lens[:200], predicates=preds(0, 200),
                               **BUILD)
    tl = rstore.ShardedTimeline.of((idx0, m0))
    for lo, hi in ((200, 400), (400, 500)):
        tl = tl.append(*rstore.new_generation(
            idx0, m0, c.doc_embs[lo:hi], c.doc_lens[lo:hi], preds(lo, hi)))
    return tl


@pytest.fixture(scope="module")
def loaded_timeline(ref_timeline, tmp_path_factory):
    path = rstore.save_timeline(str(tmp_path_factory.mktemp("svc") / "tl"),
                                ref_timeline)
    return tstore.load_timeline(path, device="cpu")


@jax.jit
def _ref_cs_lut(centroids, rotation, codebooks, q):
    cs = jax.vmap(lambda x: reng.centroid_scores(x, centroids))(q)
    q_rot = jax.vmap(lambda x: x @ rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, RPQ(codebooks)))(q_rot)
    return cs, lut


def injecting_plans(cfg):
    """A plan_factory: each generation's plan runs the port's pipeline on
    the reference's CS and LUT for the batch it is handed."""
    def factory(tl):
        def plan(gen, meta, off):
            def run(q, m, f=None):
                def operands(index):
                    cs, lut = _ref_cs_lut(*(jnp.asarray(t.numpy()) for t in (
                        index.centroids, index.opq_rotation,
                        index.pq_codebooks)), jnp.asarray(q.numpy()))
                    return (torch.from_numpy(np.array(cs)),
                            torch.from_numpy(np.array(lut)))
                return teng._generation_topk(gen, meta, off, q,
                                             teng._with_filter(cfg, f), m,
                                             operands)
            return run
        return [plan(g, m, o) for g, m, o in tl]
    return factory


@pytest.mark.parametrize("name", ["ref-score_all", "fused-score_all",
                                  "unfused"])
def test_port_service_matches_reference_service(serve_corpus, ref_timeline,
                                                loaded_timeline, name):
    """The same traffic through both services: query() cold and warm, a
    partial-warm batch, a filtered batch, and heterogeneous submit/flush
    tickets (a 16-term query padded into a micro-batch) — ids and score
    bits equal, as are the cache counters."""
    c = serve_corpus
    cfg = RETRIEVAL_CFGS[name]
    rcfg = reng.EngineConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})
    ref = rserving.RetrievalService(ref_timeline, rcfg, max_batch=4)
    got = RetrievalService(loaded_timeline, cfg, max_batch=4,
                           plan_factory=injecting_plans(cfg), device="cpu")
    q = c.queries[:6]
    mix = np.concatenate([c.queries[3:6], c.queries[6:9]])
    for batch in (q, q, mix):
        assert_same(got.query(batch), ref.query(batch))
    rf = rbv.Pred("recent") & ~rbv.Pred("lang_en")
    tf = tbv.Pred("recent") & ~tbv.Pred("lang_en")
    assert_same(got.query(q, doc_filter=tf), ref.query(q, doc_filter=rf))
    lens = (16, 32, 9, 32, 24, 30)
    rt = [ref.submit(c.queries[10 + i][:n]) for i, n in enumerate(lens)]
    tt = [got.submit(c.queries[10 + i][:n]) for i, n in enumerate(lens)]
    ref.flush()
    got.flush()
    for a, b in zip(tt, rt):
        np.testing.assert_array_equal(a.result()[1], b.result()[1])
        np.testing.assert_array_equal(bits(a.result()[0]),
                                      bits(b.result()[0]))
    assert got.cache.stats() == ref.cache.stats()
    assert got.metrics.warm_queries == ref.metrics.warm_queries


# ---------------------------------------------------------------------------
# Cache unit behavior: keys equal the reference's, LRU under the budget
# ---------------------------------------------------------------------------

def test_query_fingerprint_semantics():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    assert query_fingerprint(q) == query_fingerprint(q, np.ones(8, bool))
    mask = np.ones(8, bool)
    mask[3] = False
    assert query_fingerprint(q, mask) != query_fingerprint(q)
    q2 = q.copy()
    q2[0, 0] += 1e-7
    assert query_fingerprint(q2) != query_fingerprint(q)
    padded = np.zeros((12, 16), np.float32)
    padded[:8] = q
    pm = np.arange(12) < 8
    assert query_fingerprint(padded, pm) != query_fingerprint(q)
    for args in ((q,), (q, mask), (padded, pm), (q2, None)):
        assert query_fingerprint(*args) == rserving.query_fingerprint(*args)


def test_config_fingerprint_covers_every_field():
    base = config_fingerprint(CFG)
    for change in ({"k": 5}, {"th": 0.3}, {"use_kernels": True},
                   {"candidate_mode": "compact"}, {"cs_dtype": "bfloat16"}):
        assert config_fingerprint(dataclasses.replace(CFG, **change)) != base
    assert config_fingerprint(dataclasses.replace(CFG)) == base


FINGERPRINT_CASES = {
    "default": ({}, None),
    "serving": (dict(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48),
                None),
    "filtered": (dict(doc_filter="plan"), None),
    "bf16": (dict(cs_dtype="bfloat16", use_kernels=True), None),
    "compact": (dict(candidate_mode="compact", cand_cap=600), None),
    "compact_cap": (dict(compact_cap=16), None),
    "unfused_no_th_r": (dict(use_kernels=True, fused_prefilter=False,
                             fused_late_interaction=False, th_r=None), None),
    "doc_budget": ({}, 12),
    "doc_budgets_per_epoch": (dict(k=5), (None, 12)),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINT_CASES))
def test_config_fingerprint_equals_reference(case):
    """The port's config has no ``kernel_interpret``; its fingerprint folds
    the reference's default in, so both packages key a config alike."""
    over, budget = FINGERPRINT_CASES[case]
    rover, tover = dict(over), dict(over)
    if over.get("doc_filter") == "plan":
        rover["doc_filter"] = rbv.compile_filter(
            rbv.Pred("recent") & ~rbv.Pred("lang_en"), NAMES)
        tover["doc_filter"] = tbv.compile_filter(
            tbv.Pred("recent") & ~tbv.Pred("lang_en"), NAMES)
    want = rserving.config_fingerprint(reng.EngineConfig(**rover),
                                       doc_budget=budget)
    got = config_fingerprint(teng.EngineConfig(**tover), doc_budget=budget)
    assert got == want


def test_cache_lru_eviction_under_byte_budget():
    entry = (np.zeros(10, np.float32), np.zeros(10, np.int32))  # 80 B
    cache = ResultCache(max_bytes=3 * 80)
    for i in range(4):
        cache.put((f"q{i}", "g", "c"), *entry)
    assert len(cache) == 3 and cache.bytes == 3 * 80
    assert cache.evictions == 1
    assert cache.get(("q0", "g", "c")) is None
    assert cache.get(("q3", "g", "c")) is not None
    assert cache.get(("q1", "g", "c")) is not None
    cache.put(("q4", "g", "c"), *entry)
    assert cache.get(("q2", "g", "c")) is None
    assert cache.get(("q1", "g", "c")) is not None
    big = (np.zeros(1000, np.float32), np.zeros(1000, np.int32))
    cache.put(("huge", "g", "c"), *big)
    assert cache.get(("huge", "g", "c")) is None
    assert cache.bytes <= cache.max_bytes


# ---------------------------------------------------------------------------
# Batcher: padding, tickets, size/deadline semantics
# ---------------------------------------------------------------------------

def test_pad_query_validation():
    q16 = np.ones((16, 8), np.float32)
    padded, mask = pad_query(q16, 32)
    assert padded.shape == (32, 8) and mask.sum() == 16
    np.testing.assert_array_equal(padded[16:], 0.0)
    with pytest.raises(ValueError, match="prune it first"):
        pad_query(np.ones((40, 8), np.float32), 32)
    with pytest.raises(ValueError, match="one bool per"):
        pad_query(q16, 32, np.ones(9, bool))
    m = np.ones(16, bool)
    m[2] = False
    _, full = pad_query(q16, 32, m)
    assert not full[2] and full[:16].sum() == 15


def test_submit_flush_tickets(serve_corpus, base_timeline):
    """Heterogeneous-length queries batch through submit/flush; each ticket
    equals retrieve_timeline on the same padded batch (ids and score bits)
    and has the ids of its unpadded prefix's retrieval."""
    c = serve_corpus
    svc = RetrievalService(base_timeline, CFG, max_batch=4, device="cpu")
    t_short = svc.submit(c.queries[0][:16])                   # 16 terms
    t_full = svc.submit(c.queries[1])                         # all 32
    with pytest.raises(RuntimeError, match="still pending"):
        t_short.result()
    svc.flush()
    assert t_short.done and t_full.done
    qs, ms = zip(pad_query(c.queries[0][:16], 32), pad_query(c.queries[1],
                                                             32))
    batch = retrieve_timeline(base_timeline, np.stack(qs), CFG, np.stack(ms),
                              device="cpu")
    for i, t in enumerate((t_short, t_full)):
        np.testing.assert_array_equal(t.result()[1],
                                      batch.doc_ids.numpy()[i])
        np.testing.assert_array_equal(bits(t.result()[0]),
                                      bits(batch.scores.numpy()[i]))
    ref_short = retrieve_timeline(base_timeline, c.queries[0:1, :16], CFG,
                                  device="cpu")
    np.testing.assert_array_equal(t_short.result()[1],
                                  ref_short.doc_ids.numpy()[0])


def test_batcher_size_and_deadline_triggers(serve_corpus, base_timeline):
    c = serve_corpus
    now = [0.0]
    svc = RetrievalService(base_timeline, CFG, max_batch=2,
                           max_delay_s=0.01, clock=lambda: now[0],
                           device="cpu")
    t1 = svc.submit(c.queries[0])
    svc.poll()
    assert not t1.done
    now[0] += 0.02
    svc.poll()
    assert t1.done
    t2 = svc.submit(c.queries[1])
    t3 = svc.submit(c.queries[2])
    assert t2.done and t3.done
    mb = MicroBatcher(n_q=32, max_batch=2, max_delay_s=0.01,
                      clock=lambda: now[0])
    mb.submit(c.queries[0])
    assert not mb.due()
    now[0] += 0.02
    assert mb.due()


def test_batcher_overflow_keeps_original_deadline(serve_corpus):
    c = serve_corpus
    now = [0.0]
    mb = MicroBatcher(n_q=32, max_batch=2, max_delay_s=0.01,
                      clock=lambda: now[0])
    for i in range(3):
        mb.submit(c.queries[i])
    now[0] = 0.008
    qb, _, _ = mb.drain()
    assert qb.q.shape[0] == 2 and len(mb) == 1
    now[0] = 0.012
    assert mb.due()
    mb.drain()
    mb.submit(c.queries[0])
    now[0] = 0.0215
    assert not mb.due()
    now[0] = 0.023
    assert mb.due()
    assert mb.deadline_misses == 1      # the overflow query, drained at 12 ms


def test_query_empty_batch_raises_actionable(base_timeline):
    svc = RetrievalService(base_timeline, CFG, device="cpu")
    with pytest.raises(ValueError, match="empty query batch"):
        svc.query(np.zeros((0, 32, 128), np.float32))
    with pytest.raises(ValueError, match="empty query batch"):
        svc._execute(np.zeros((0, 32, 128), np.float32),
                     np.zeros((0, 32), bool))
    with pytest.raises(ValueError, match="expected"):
        svc.query(np.zeros((32, 128), np.float32))


# ---------------------------------------------------------------------------
# Metrics + footprint accounting
# ---------------------------------------------------------------------------

def test_latency_stats_percentiles():
    ls = LatencyStats(window=100)
    for v in range(1, 101):
        ls.record(v / 1e3)
    snap = ls.snapshot()
    assert snap["count"] == 100
    assert abs(snap["p50_ms"] - 50.5) < 1.0
    assert snap["p99_ms"] > 98.0
    for _ in range(100):
        ls.record(0.2)
    assert abs(ls.snapshot()["p50_ms"] - 200.0) < 1e-6
    assert ls.count == 200


def test_service_metrics_warm_cold_split():
    m = ServiceMetrics()
    m.record_batch(8, 8, 0.001)
    m.record_batch(8, 4, 0.010)
    snap = m.snapshot()
    assert snap["queries"] == 16 and snap["warm_queries"] == 12
    assert snap["warm_latency"]["count"] == 1
    assert snap["cold_latency"]["count"] == 1
    assert snap["warm_fraction"] == 0.75


def test_footprint_accounting(base_timeline):
    tl = base_timeline
    fp = timeline_footprint(tl)
    gens = [generation_footprint(g, m) for g, m, _ in tl]
    assert fp["n_generations"] == len(tl) and fp["n_docs"] == tl.n_docs
    assert fp["index_bytes"] == sum(g["index_bytes"] for g in gens)
    assert fp["manifest_bytes"] > sum(g["manifest_bytes"] for g in gens)
    assert fp["total_bytes"] == fp["index_bytes"] + fp["manifest_bytes"]
    assert fp["n_tokens"] == int(sum(int(g.doc_lens.sum())
                                     for g in tl.generations))
    assert fp["bytes_per_embedding"] == bytes_per_embedding(tl.metas[0],
                                                            "emvb")
    assert fp["bytes_per_embedding_actual"] > fp["bytes_per_embedding"]
    per_gen = gens[0]
    assert per_gen["index_bytes"] == sum(per_gen["array_bytes"].values())


def test_stats_snapshot_shape(serve_corpus, base_timeline):
    svc = RetrievalService(base_timeline, CFG, device="cpu")
    svc.query(serve_corpus.queries[:4])
    snap = svc.stats()
    assert snap["cache"]["entries"] == 8
    assert snap["timeline"]["n_generations"] == 3
    assert snap["timeline"]["total_bytes"] > 0
    assert snap["latency"]["count"] == 1
    assert snap["queries"] == 4


def test_latency_stats_ring_wrap_window():
    ls = LatencyStats(window=8)
    for v in range(1, 21):
        ls.record(v / 1e3)
    snap = ls.snapshot()
    assert snap["count"] == 20
    assert snap["max_ms"] == pytest.approx(20.0)
    assert snap["p50_ms"] == pytest.approx(16.5)
    assert snap["p95_ms"] == pytest.approx(np.percentile(
        np.arange(13, 21), 95))
    assert ls.max() == pytest.approx(0.020)
    assert snap["mean_ms"] == pytest.approx(10.5)
    assert set(snap) == {"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms",
                         "max_ms"}


def test_service_metrics_mixed_filtered_accounting():
    m = ServiceMetrics()
    m.record_batch(8, 8, 0.001, n_filtered=3)
    snap = m.snapshot()
    assert snap["filtered_queries"] == 3
    assert snap["unfiltered_queries"] == 5
    assert m.filtered_queries + m.unfiltered_queries == m.queries


def test_service_metrics_rejects_unknown_maintenance_kind():
    m = ServiceMetrics()
    m.record_maintenance("merge")
    m.record_maintenance("reepoch")
    with pytest.raises(ValueError, match="unknown maintenance action kind"):
        m.record_maintenance("compact")
    assert m.merges == 1 and m.reepochs == 1


def test_service_metrics_warm_reservoir_routing():
    m = ServiceMetrics()
    m.record_batch(4, 4, 0.001)
    m.record_batch(4, 3, 0.010)
    m.record_batch(4, 0, 0.020)
    assert m.warm_latency.count == 1
    assert m.cold_latency.count == 2
    assert m.batch_latency.count == 3
    assert m.warm_latency.max() == pytest.approx(0.001)
    assert m.cold_latency.max() == pytest.approx(0.020)


def test_service_metrics_registry_equivalence():
    m = ServiceMetrics()
    m.record_batch(8, 8, 0.001)
    m.record_batch(8, 4, 0.010, n_filtered=8)
    m.record_swap()
    m.record_swap(deferred=True)
    m.record_maintenance("merge")
    m.record_deadline_misses(2)
    m.set_queue_depth(3)
    m.record_generation_lookups("abcdef0123456789", hits=6, misses=2)
    snap = m.snapshot()
    assert snap["batches"] == m.batches == 2
    assert snap["queries"] == m.queries == 16
    assert snap["warm_queries"] == m.warm_queries == 12
    assert snap["cold_queries"] == m.cold_queries == 4
    assert snap["warm_fraction"] == 0.75
    assert snap["filtered_queries"] == m.filtered_queries == 8
    assert snap["maintenance"] == {"swaps": 2, "deferred_swaps": 1,
                                   "merges": 1, "reepochs": 0}
    assert snap["batcher"] == {"queue_depth": 3, "deadline_misses": 2}
    assert snap["generations"] == {
        "abcdef012345": {"hits": 6, "misses": 2, "hit_ratio": 0.75}}
    assert snap["latency"]["count"] == 2
    with pytest.raises(AttributeError):
        m.queries = 99


def test_snapshot_rejects_partial_footprint(base_timeline):
    m = ServiceMetrics()
    with pytest.raises(KeyError, match="predicate_bytes"):
        m.snapshot(timeline_footprint={"n_generations": 1, "n_docs": 10})
    full = timeline_footprint(base_timeline)
    snap = m.snapshot(timeline_footprint=full)
    assert snap["timeline"]["n_docs"] == base_timeline.n_docs
    with_opt = dict(full, n_epochs=2)
    assert m.snapshot(timeline_footprint=with_opt)["timeline"][
        "n_epochs"] == 2
