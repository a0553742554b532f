"""Multi-generation timelines through the port against ``repro.core``.

The reference builds a stream corpus's base index (with a predicate plane)
and two generations from ``new_generation`` (the second grown by
``add_passages`` and swapped in with ``with_newest``), as
tests/test_store.py does, and saves the timeline with ``save_timeline``.
The port loads it with ``load_timeline(device="cpu")``: fingerprints equal,
and ``retrieve_timeline`` returns the reference's doc ids and float32 score
bits on the reference-math lane and both kernel lanes, unfiltered, with a
compiled ``FilterPlan`` and a raw ``FilterExpr``, in compact mode, with a
masked query, and on bf16 CS on the fused lane. The reference's CS and LUT
are injected per generation through ``engine._timeline_topk(...,
operands=)``, as ``_retrieve_batch(cs=, lut=)`` takes them for one index
(the frameworks' matmul bits differ in general, ROADMAP hazard 3); the
public path runs once with the matmul bits held first. An
``EpochedTimeline`` of two codebook epochs matches the reference's merge by
rank, and the merges match the reference's on hand-made partials.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import build_index
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.pq import PQCodebooks as RPQ
from repro.core.pq import build_lut as ref_build_lut
from repro.data.synthetic import make_corpus
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.core.index import index_from_arrays

torch.set_num_threads(1)

NAMES = ("lang_en", "recent", "rare")
BUILD = dict(n_centroids=128, m=8, nbits=4, kmeans_iters=3)
# tight budgets (the phases cut), as tests/test_store.py's CFG
KW = dict(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48, k=10)
LANES = {
    "math": {},
    "fused": dict(use_kernels=True),
    "unfused": dict(use_kernels=True, fused_prefilter=False,
                    fused_late_interaction=False),
}


def predicates(lo, hi):
    """The stream's predicate plane for docs [lo, hi): numpy from a seed."""
    rng = np.random.default_rng(3)
    cols = {n: rng.random(600) < p for n, p in zip(NAMES, (0.7, 0.5, 0.005))}
    return {n: c[lo:hi] for n, c in cols.items()}


def stream_timeline(c, build_key=0, lo=0):
    """The reference's three-generation timeline over docs [lo, lo + 600)
    of corpus c: a base of 200 docs, a generation of 200, and one of 160
    grown by 40 and swapped in with ``with_newest``."""
    idx0, m0 = build_index(jax.random.PRNGKey(build_key),
                           c.doc_embs[lo:lo + 200], c.doc_lens[lo:lo + 200],
                           predicates=predicates(lo, lo + 200), **BUILD)

    def gen(a, b):
        return c.doc_embs[lo + a:lo + b], c.doc_lens[lo + a:lo + b], \
            predicates(lo + a, lo + b)

    tl = rstore.ShardedTimeline.of((idx0, m0))
    tl = tl.append(*rstore.new_generation(idx0, m0, *gen(200, 400)))
    tl = tl.append(*rstore.new_generation(idx0, m0, *gen(400, 560)))
    return tl.with_newest(*rstore.add_passages(tl.generations[-1],
                                               tl.metas[-1], *gen(560, 600)))


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(0, n_docs=600, cap=24, min_len=8, n_queries=24,
                       n_topics=24)


@pytest.fixture(scope="module")
def ref_tl(corpus):
    return stream_timeline(corpus)


@pytest.fixture(scope="module")
def saved(ref_tl, tmp_path_factory):
    return rstore.save_timeline(str(tmp_path_factory.mktemp("tl") / "tl"),
                                ref_tl)


@pytest.fixture(scope="module")
def port_tl(saved):
    return tstore.load_timeline(saved, device="cpu")


def to_torch(x):
    """A jax or numpy array as a torch tensor (bf16 through its bits)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@functools.partial(jax.jit, static_argnames="dtype")
def _ref_cs_lut(centroids, rotation, codebooks, q, dtype):
    """CS and LUT as the reference's batched pipeline builds them."""
    cs = jax.vmap(lambda x: reng.centroid_scores(x, centroids, dtype))(q)
    q_rot = jax.vmap(lambda x: x @ rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, RPQ(codebooks)))(q_rot)
    return cs, lut


def ref_operands(q, dtype="float32"):
    """``operands`` for the port: a generation's index -> the reference's
    (cs, lut) from that generation's own centroids, rotation and PQ
    codebooks."""
    def fn(index):
        cs, lut = _ref_cs_lut(*(jnp.asarray(t.numpy()) for t in (
            index.centroids, index.opq_rotation, index.pq_codebooks)),
            jnp.asarray(q), dtype)
        return to_torch(cs), to_torch(lut)
    return fn


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def assert_same(got, want):
    assert got.doc_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(bits(got.scores), bits(want.scores))


def queries(c, rows, pad=0):
    q = np.array(c.queries[rows], np.float32)
    if not pad:
        return q, None
    qm = np.ones(q.shape[:2], bool)
    qm[:, -pad:] = False
    q[~qm] = 0.0
    return q, qm


def port_meta(meta):
    return tstore.IndexMeta(**dataclasses.asdict(meta))


def port_index(index):
    return index_from_arrays({f: np.asarray(getattr(index, f))
                              for f in index._fields}, device="cpu")


def port_timeline_of(ref_tl):
    """The port's copy of a reference timeline, array for array."""
    return tstore.ShardedTimeline(
        tuple(port_index(g) for g in ref_tl.generations),
        tuple(port_meta(m) for m in ref_tl.metas))


def run_both(ref_tl, port_tl, q, qm, kw, ref_filter=None, port_filter=None):
    """(port, reference) retrieve_timeline on the same queries, the
    reference's CS and LUT injected into the port."""
    want = reng.retrieve_timeline(
        ref_tl, jnp.asarray(q), reng.EngineConfig(**kw),
        None if qm is None else jnp.asarray(qm), doc_filter=ref_filter)
    got = teng._timeline_topk(
        port_tl, torch.from_numpy(q), teng.EngineConfig(**kw),
        None if qm is None else torch.from_numpy(qm), port_filter,
        ref_operands(q, kw.get("cs_dtype", "float32")))
    return got, want


def test_port_reads_the_reference_timeline(ref_tl, port_tl):
    assert len(port_tl) == len(ref_tl) == 3
    assert port_tl.offsets == ref_tl.offsets == (0, 200, 400)
    assert port_tl.n_docs == ref_tl.n_docs == 600
    assert [dataclasses.asdict(m) for m in port_tl.metas] == \
        [dataclasses.asdict(m) for m in ref_tl.metas]
    # the seeded fingerprints, and a fresh hash of the port's tensors
    assert port_tl.fingerprints == ref_tl.fingerprints
    fresh = tstore.ShardedTimeline(port_tl.generations, port_tl.metas)
    assert fresh.fingerprints == ref_tl.fingerprints
    for rg, pg in zip(ref_tl.generations, port_tl.generations):
        for f in rg._fields:
            a, b = np.asarray(getattr(rg, f)), getattr(pg, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# name: (lane, config overrides, filter kind, pad of the query mask)
CASES = {f"{lane}_{name}": (lane, over, filt, pad)
         for lane in LANES
         for name, over, filt, pad in (
             ("plain", {}, None, 0),
             ("plan", {}, "plan", 0),
             ("expr", {}, "expr", 0),
             ("compact", dict(candidate_mode="compact", cand_cap=150), None,
              0),
             ("masked", {}, None, 9),
             ("rare", {}, "rare", 0))}
CASES["fused_bf16"] = ("fused", dict(cs_dtype="bfloat16"), None, 0)
CASES["fused_compact_plan_masked"] = (
    "fused", dict(candidate_mode="compact", cand_cap=150), "plan", 5)


def filters(kind):
    """(reference filter, port filter) of a kind: a compiled plan, a raw
    expression, or none."""
    if kind is None:
        return None, None
    if kind == "rare":      # fewer than k passing docs: -inf fillers
        return (rbv.compile_filter(rbv.Pred("rare"), NAMES),
                tbv.compile_filter(tbv.Pred("rare"), NAMES))
    r = rbv.Pred("recent") & ~rbv.Pred("lang_en")
    t = tbv.Pred("recent") & ~tbv.Pred("lang_en")
    if kind == "expr":
        return r, t
    return rbv.compile_filter(r, NAMES), tbv.compile_filter(t, NAMES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_retrieve_timeline_matches_reference(corpus, ref_tl, port_tl, case):
    lane, over, filt, pad = CASES[case]
    q, qm = queries(corpus, slice(0, 4), pad)
    kw = {**KW, **LANES[lane], **over}
    got, want = run_both(ref_tl, port_tl, q, qm, kw, *filters(filt))
    assert_same(got, want)
    ids = got.doc_ids.numpy()
    assert ((ids >= 0) & (ids < 600)).all()
    if filt is not None:    # every finite result passes the filter
        pw = predicates(0, 600)
        ok = pw["rare"] if filt == "rare" else pw["recent"] & ~pw["lang_en"]
        fin = np.isfinite(got.scores.numpy())
        assert ok[ids[fin]].all()
        assert filt != "rare" or not fin.all()


def test_public_path_holds_the_matmuls_then_the_result(corpus, ref_tl,
                                                       port_tl):
    """``retrieve_timeline(..., device="cpu")`` with the port's own CS and
    LUT: the matmul bits first (0 differences at these shapes), then ids
    and score bits; and ``retrieve_generation_topk`` per generation with
    the reference's."""
    q, _ = queries(corpus, slice(4, 8))
    kw = {**KW, **LANES["fused"]}
    cs, lut = ref_operands(q)(port_tl.generations[1])
    g = port_tl.generations[1]
    np.testing.assert_array_equal(
        bits(teng.centroid_scores(torch.from_numpy(q), g.centroids)),
        bits(cs))
    np.testing.assert_array_equal(
        bits(teng._query_lut(g, torch.from_numpy(q))), bits(lut))
    want = reng.retrieve_timeline(ref_tl, jnp.asarray(q),
                                  reng.EngineConfig(**kw))
    got = teng.retrieve_timeline(port_tl, q, teng.EngineConfig(**kw),
                                 device="cpu")
    assert_same(got, want)
    for (rg, rm, off), (pg, pm, _) in zip(ref_tl, port_tl):
        assert_same(
            teng.retrieve_generation_topk(pg, pm, off, q,
                                          teng.EngineConfig(**kw),
                                          device="cpu"),
            reng.retrieve_generation_topk(rg, rm, off, jnp.asarray(q),
                                          reng.EngineConfig(**kw)))


@pytest.fixture(scope="module")
def epochs(corpus, ref_tl):
    """Two codebook epochs: the stream's first two generations, and a
    second stream trained with another key over the corpus' last docs."""
    other = make_corpus(1, n_docs=600, cap=24, min_len=8, n_queries=4,
                        n_topics=24)
    e1 = stream_timeline(other, build_key=7)
    ref = rstore.EpochedTimeline((rstore.ShardedTimeline(
        ref_tl.generations[:2], ref_tl.metas[:2]), e1))
    port = tstore.EpochedTimeline(tuple(port_timeline_of(e)
                                        for e in ref.epochs))
    return ref, port


@pytest.mark.parametrize("lane", ["math", "fused"])
@pytest.mark.parametrize("filt", [None, "expr"])
def test_epoched_timeline_merges_by_rank_as_reference(corpus, epochs, lane,
                                                      filt):
    ref, port = epochs
    assert port.epoch_offsets == ref.epoch_offsets == (0, 400)
    assert port.n_generations == ref.n_generations == 5
    q, _ = queries(corpus, slice(8, 12))
    got, want = run_both(ref, port, q, None, {**KW, **LANES[lane]},
                         *filters(filt))
    assert_same(got, want)


def test_single_epoch_equals_its_timeline(corpus, port_tl):
    q, _ = queries(corpus, slice(12, 16))
    cfg = teng.EngineConfig(**KW)
    a = teng.retrieve_timeline(port_tl, q, cfg, device="cpu")
    b = teng.retrieve_timeline(tstore.EpochedTimeline.of(port_tl), q, cfg,
                               device="cpu")
    assert torch.equal(a.doc_ids, b.doc_ids)
    assert torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32))
    assert tstore.EpochedTimeline.of(tstore.EpochedTimeline.of(port_tl)) \
        .epochs == (port_tl,)


def _partials(seed, n_parts, k, ties):
    """Per-generation partial results (B = 3): descending scores, global
    ids; ``ties`` repeats scores across parts."""
    rng = np.random.default_rng(seed)
    parts = []
    for g in range(n_parts):
        s = -np.sort(-rng.integers(0, 4 if ties else 10 ** 6, size=(3, k)),
                     axis=1).astype(np.float32)
        s[0, -2:] = -np.inf                       # fillers
        ids = (g * 1000 + rng.permutation(50)[:k][None] + np.zeros(
            (3, 1), np.int64)).astype(np.int32)
        parts.append((s, ids))
    return parts


@pytest.mark.parametrize("ties", [False, True])
def test_merges_match_reference(ties):
    parts = _partials(5, 3, 6, ties)
    rp = [reng.RetrievalResult(jnp.asarray(s), jnp.asarray(i))
          for s, i in parts]
    tp = [teng.RetrievalResult(torch.from_numpy(s), torch.from_numpy(i))
          for s, i in parts]
    for k in (1, 6, 10):
        assert_same(teng.merge_partial_topk(tp, k, device="cpu"),
                    reng.merge_partial_topk(rp, k))
        assert_same(teng.merge_partial_topk_by_rank(tp, k, device="cpu"),
                    reng.merge_partial_topk_by_rank(rp, k))
    local = [teng.RetrievalResult(p.scores, p.doc_ids % 1000) for p in tp]
    rlocal = [reng.RetrievalResult(p.scores, p.doc_ids % 1000) for p in rp]
    assert_same(teng.merge_generation_topk(local, (0, 7, 20), 8,
                                           device="cpu"),
                reng.merge_generation_topk(rlocal, (0, 7, 20), 8))
    assert teng.merge_partial_topk_by_rank(tp[:1], 4, device="cpu") is tp[0]


@pytest.mark.parametrize("over", [
    dict(n_filter=700, n_docs=300, cand_cap=50, compact_cap=40),
    dict(n_filter=64, n_docs=64, cand_cap=4096, compact_cap=None),
    dict(n_filter=64, n_docs=16, cand_cap=100, compact_cap=5)])
@pytest.mark.parametrize("n_docs,cap", [(200, 24), (40, None), (10, 24)])
def test_adapt_config_to_corpus_matches_reference(over, n_docs, cap):
    kw = {**KW, **over, "th_r": 0.4}
    want = reng.adapt_config_to_corpus(reng.EngineConfig(**kw), n_docs, cap)
    got = teng.adapt_config_to_corpus(teng.EngineConfig(**kw), n_docs, cap)
    for f in ("n_filter", "n_docs", "cand_cap", "compact_cap", "k", "th_r"):
        assert getattr(got, f) == getattr(want, f), f


def test_tiny_generation_serves_and_k_refuses(corpus, ref_tl, port_tl):
    """A generation smaller than n_filter/cand_cap serves (budgets clamp);
    one smaller than k refuses with the reference's message."""
    c = corpus
    idx0, m0 = ref_tl.generations[0], ref_tl.metas[0]
    tiny = rstore.new_generation(idx0, m0, c.doc_embs[560:600],
                                 c.doc_lens[560:600], predicates(560, 600))
    ref = rstore.ShardedTimeline.of((idx0, m0), tiny)
    port = port_timeline_of(ref)
    q, _ = queries(c, slice(0, 4))
    got, want = run_both(ref, port, q, None, {**KW, **LANES["fused"]})
    assert_same(got, want)
    cfg = dataclasses.replace(reng.EngineConfig(**KW), k=41, n_docs=48)
    with pytest.raises(ValueError) as r:
        reng.retrieve_timeline(ref, jnp.asarray(q), cfg)
    with pytest.raises(ValueError) as t:
        teng.retrieve_timeline(port, q, teng.EngineConfig(
            **{**KW, "k": 41}), device="cpu")
    assert str(t.value) == str(r.value)
