"""The store's write side and lifecycle through the port against
``repro.core.store``: growth against frozen codebooks (``new_generation``,
``add_passages``, ``pool_documents``), compaction (``merge_generations``),
persistence (``save_index``, ``save_timeline``), footprints, and every
refusal message.

Encoding is held two ways. With the port's own matmuls, the codes equal the
reference's except at near-ties: tokens whose two best centroids (or PQ
codewords) lie within ``kmeans.NEAR_TIE_EPS`` of each other in exact
arithmetic. Each mismatch is counted and its gap measured; padding tokens
(all-zero rows, whose assignment is the argmin of the centroids' float32
squared norms, all about 1) are the usual ones, and they reach only the
padding slots' residual codes. Everything else (real tokens' codes and
residual codes, the IVF, the meta floats) equals the reference's. With the
reference's distance matrix injected in place of the port's
(``kmeans._pairwise_sq_dists``, the one matmul of the encode, ROADMAP
hazard 3), every array, the meta and the fingerprint equal the reference's.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index
from repro.core import engine as reng
from repro.core import index as rindex
from repro.core import kmeans as rkmeans
from repro.core import store as rstore
from repro.core.bitvector import PredicateSet as RPredicateSet
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from repro_torch.core import index as tindex
from repro_torch.core import kmeans as tkmeans
from repro_torch.core import store as tstore
from test_torch_timeline import corpus  # noqa: F401  (a fixture)
from test_torch_timeline import (BUILD, KW, LANES, NAMES, port_index,
                                 port_meta, port_timeline_of, predicates,
                                 queries, stream_timeline)

torch.set_num_threads(1)

LOSSLESS = dict(KW, n_filter=600, n_docs=600, cand_cap=600)


@pytest.fixture(scope="module")
def base(corpus):
    """The reference's base (predicate plane) and the port's copy."""
    idx, meta = build_index(jax.random.PRNGKey(0), corpus.doc_embs[:200],
                            corpus.doc_lens[:200],
                            predicates=predicates(0, 200), **BUILD)
    return idx, meta, port_index(idx), port_meta(meta)


@pytest.fixture(scope="module")
def opq(corpus):
    """A base with an OPQ rotation (not the identity: PQ encodes rotated
    residuals)."""
    idx, meta = build_index(jax.random.PRNGKey(0), corpus.doc_embs[:200],
                            corpus.doc_lens[:200], use_opq=True,
                            predicates=predicates(0, 200), **BUILD)
    return idx, meta, port_index(idx), port_meta(meta)


@pytest.fixture(scope="module")
def budgeted(corpus):
    """A budgeted base (doc_budget 10: every doc pooled, cap 10)."""
    idx, meta = build_index(jax.random.PRNGKey(0), corpus.doc_embs[:200],
                            corpus.doc_lens[:200], doc_budget=10, **BUILD)
    return idx, meta, port_index(idx), port_meta(meta)


def ref_dists(x, c):
    """The reference's distance block on the port's operands."""
    return torch.from_numpy(np.array(rkmeans._pairwise_sq_dists(
        jnp.asarray(x.numpy()), jnp.asarray(c.numpy()))))


def near_ties(meta, centroids, embs, lens):
    """Raw (unpadded) assignments of the rows ``quantize_tokens`` sees, by
    the reference and by the port; every mismatch must be a near tie.
    -> (rows (n, d), ref codes, mismatch mask, real-token mask)."""
    embs, lens, _ = tstore._pool_new_docs(meta, embs, lens)
    normed = embs / np.maximum(np.linalg.norm(embs, axis=-1, keepdims=True),
                               1e-12)
    flat = torch.from_numpy(normed.reshape(-1, meta.d))
    cent = torch.from_numpy(np.array(centroids))
    want = torch.from_numpy(np.array(rkmeans.assign(
        jnp.asarray(flat.numpy()), jnp.asarray(cent.numpy()))))
    got = tkmeans.assign(flat, cent)
    diff = got != want
    gap = tkmeans.choice_gap(flat[diff], cent, want[diff], got[diff])
    assert (gap <= tkmeans.NEAR_TIE_EPS).all(), gap.max()
    real = (np.arange(embs.shape[1])[None] < lens[:, None]).reshape(-1)
    return flat, want, diff.numpy(), real


def hold_encoding(ref, port, flat, want, diff, real, n_old=0):
    """The port's (index, meta) against the reference's where the raw
    assignments agree (the first ``n_old`` docs are the grown index's
    own). -> (assignment mismatches on padding, on real tokens, PQ codes
    that differ at agreeing tokens, each a near tie)."""
    (ri, rm), (pi, pm) = ref, port
    cap = rm.cap
    cb = np.asarray(ri.pq_codebooks)
    rotation = torch.from_numpy(np.array(ri.opq_rotation)).double()
    agree = np.concatenate([np.ones(n_old * cap, bool), ~diff])
    rc, pc = np.asarray(ri.res_codes), pi.res_codes.numpy()
    rc, pc = rc.reshape(-1, rc.shape[-1]), pc.reshape(-1, pc.shape[-1])
    pq_diff = (rc != pc) & agree[:, None]
    rows, subs = np.nonzero(pq_diff)
    for r, s in zip(rows, subs):          # each a PQ near tie
        x = (flat[r - n_old * cap] - torch.from_numpy(
            np.array(ri.centroids))[want[r - n_old * cap]]).double() \
            @ rotation
        dsub = x.shape[0] // rc.shape[-1]
        gap = tkmeans.choice_gap(
            x[None, s * dsub:(s + 1) * dsub], torch.from_numpy(cb[s]),
            torch.tensor([rc[r, s]]), torch.tensor([pc[r, s]]))
        assert gap.item() <= tkmeans.NEAR_TIE_EPS
    tok_ok = agree & ~pq_diff.any(1)
    np.testing.assert_array_equal(
        np.asarray(ri.res_codes).reshape(len(agree), -1)[tok_ok],
        pi.res_codes.numpy().reshape(len(agree), -1)[tok_ok])
    np.testing.assert_array_equal(
        np.asarray(ri.plaid_res).reshape(len(agree), -1)[agree],
        pi.plaid_res.numpy().reshape(len(agree), -1)[agree])
    codes_ok = agree.reshape(-1, cap).all(1)
    np.testing.assert_array_equal(np.asarray(ri.codes)[codes_ok],
                                  pi.codes.numpy()[codes_ok])
    n_real = int((diff & real).sum())
    if n_real == 0:       # equal codes: equal IVF and drift floats
        for f in ("codes", "doc_lens", "ivf", "ivf_lens", "pred_words",
                  "centroids", "pq_codebooks", "plaid_cutoffs",
                  "plaid_weights", "opq_rotation"):
            a, b = np.asarray(getattr(ri, f)), getattr(pi, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    return int((diff & ~real).sum()), n_real, len(rows)


def hold_equal(ref, port):
    (ri, rm), (pi, pm) = ref, port
    for f in ri._fields:
        # the kernels read raw pointers: every field contiguous
        assert getattr(pi, f).is_contiguous(), f
        a, b = np.asarray(getattr(ri, f)), getattr(pi, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    assert tstore.index_fingerprint(pi) == rstore.index_fingerprint(ri)


# name: (base fixture, docs, predicates)
GROWTH = {
    "plain": ("base", (200, 400), True),
    "one_doc": ("base", (399, 400), True),
    "all_padding": ("base", None, True),
    "budgeted": ("budgeted", (200, 400), False),
    "opq": ("opq", (200, 400), True),
}


def _docs(c, span, cap=24, d=128):
    if span is None:                  # legal: no real token at all
        return np.zeros((3, cap, d), np.float32), np.zeros(3, np.int32), \
            (400, 403)
    return c.doc_embs[span[0]:span[1]], c.doc_lens[span[0]:span[1]], span


@pytest.mark.parametrize("inject", [False, True], ids=["own", "injected"])
@pytest.mark.parametrize("case", sorted(GROWTH))
def test_new_generation_matches_reference(request, monkeypatch, corpus,
                                          case, inject):
    which, span, with_pred = GROWTH[case]
    ri, rm, pi, pm = request.getfixturevalue(which)
    embs, lens, span = _docs(corpus, span)
    pred = predicates(*span) if with_pred else None
    want = rstore.new_generation(ri, rm, embs, lens, pred)
    if inject:
        monkeypatch.setattr(tkmeans, "_pairwise_sq_dists", ref_dists)
        hold_equal(want, tstore.new_generation(pi, pm, embs, lens, pred,
                                               device="cpu"))
        return
    got = tstore.new_generation(pi, pm, embs, lens, pred, device="cpu")
    flat, assigned, diff, real = near_ties(rm, ri.centroids, embs, lens)
    pads, reals, pqs = hold_encoding(want, got, flat, assigned, diff, real)
    assert reals == 0 and pqs == 0      # at these inputs: padding only
    assert pads <= int((~real).sum())


@pytest.mark.parametrize("inject", [False, True], ids=["own", "injected"])
@pytest.mark.parametrize("case", sorted(GROWTH))
def test_add_passages_matches_reference(request, monkeypatch, corpus, case,
                                        inject):
    """Growth of a grown generation (n_grown > 0, so the drift mean
    merges) and of the trained base (budgeted)."""
    which, span, with_pred = GROWTH[case]
    ri, rm, pi, pm = request.getfixturevalue(which)
    embs, lens, span = _docs(corpus, span)
    pred = predicates(*span) if with_pred else None
    if with_pred:            # grow a generation first, both sides alike
        ri, rm = rstore.new_generation(ri, rm, corpus.doc_embs[400:440],
                                       corpus.doc_lens[400:440],
                                       predicates(400, 440))
        pi, pm = port_index(ri), port_meta(rm)
    want = rstore.add_passages(ri, rm, embs, lens, pred)
    if inject:
        monkeypatch.setattr(tkmeans, "_pairwise_sq_dists", ref_dists)
        hold_equal(want, tstore.add_passages(pi, pm, embs, lens, pred,
                                             device="cpu"))
        return
    got = tstore.add_passages(pi, pm, embs, lens, pred, device="cpu")
    flat, assigned, diff, real = near_ties(rm, ri.centroids, embs, lens)
    pads, reals, pqs = hold_encoding(want, got, flat, assigned, diff, real,
                                     n_old=rm.n_docs)
    assert reals == 0 and pqs == 0


@pytest.mark.parametrize("budget", [1, 6, 10, 24, 40])
def test_pool_documents_matches_reference(corpus, budget):
    """Budgeted pooling, and pass-through at budget >= the longest doc."""
    embs, lens = corpus.doc_embs[:60], corpus.doc_lens[:60]
    want = rindex.pool_documents(embs, lens, budget)
    got = tindex.pool_documents(embs, lens, budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if budget >= int(lens.max()):
        np.testing.assert_array_equal(got[0], embs[:, :min(24, budget)])


def test_quantize_tokens_and_codecs_match_reference(base, corpus):
    ri, _, pi, _ = base
    embs, lens = corpus.doc_embs[200:260], corpus.doc_lens[200:260]
    rc, rres, rmask = rindex.quantize_tokens(ri.centroids, embs, lens)
    pc, pres, pmask = tindex.quantize_tokens(pi.centroids, embs, lens)
    np.testing.assert_array_equal(pmask, rmask)
    np.testing.assert_array_equal(pc.numpy()[rmask], rc[rmask])
    np.testing.assert_array_equal(pres.numpy()[rmask.reshape(-1)],
                                  rres[rmask.reshape(-1)])
    from repro.core import pq as rpq
    from repro.core import residual as rres_mod
    from repro_torch.core import pq as tpq
    from repro_torch.core import residual as tres
    want = np.asarray(rpq.encode_pq(jnp.asarray(rres), ri.pq))
    np.testing.assert_array_equal(
        tpq.encode_pq(torch.from_numpy(rres), pi.pq).numpy(), want)
    packed = np.asarray(rres_mod.encode_residual(jnp.asarray(rres),
                                                 ri.plaid_codec))
    got = tres.encode_residual(torch.from_numpy(rres), pi.plaid_codec)
    np.testing.assert_array_equal(got.numpy(), packed)
    np.testing.assert_array_equal(
        tres.decode_residual(got, pi.plaid_codec, 128).numpy(),
        np.asarray(rres_mod.decode_residual(jnp.asarray(packed),
                                            ri.plaid_codec, 128)))
    for b in (1, 2, 4):
        codes = np.random.default_rng(b).integers(
            0, 1 << b, size=(5, 32)).astype(np.uint8)
        p = tres.pack_codes(torch.from_numpy(codes), b)
        np.testing.assert_array_equal(
            p.numpy(), np.asarray(rres_mod.pack_codes(jnp.asarray(codes),
                                                      b)))
        np.testing.assert_array_equal(tres.unpack_codes(p, b, 32).numpy(),
                                      codes)
    for method in ("emvb", "plaid"):
        for n_c in (100, 1 << 16, 1 << 18):
            m = dataclasses.replace(base[1], n_centroids=n_c)
            assert tindex.bytes_per_embedding(port_meta(m), method) == \
                rindex.bytes_per_embedding(m, method)


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_assign_in_blocks_matches_reference(base, corpus, monkeypatch, rows):
    """assign's blocks of rows (ASSIGN_BLOCK_BYTES cut to ``rows`` rows of
    distances) give the one-block assignment, and that is the reference's
    on the rows normalized_tokens makes, but for near ties."""
    ri, _, pi, _ = base
    embs = corpus.doc_embs[200:210]
    flat = torch.from_numpy(tindex.normalized_tokens(embs))
    whole = tkmeans.assign(flat, pi.centroids)
    monkeypatch.setattr(tkmeans, "ASSIGN_BLOCK_BYTES",
                        rows * 4 * pi.centroids.shape[0])
    torch.testing.assert_close(tkmeans.assign(flat, pi.centroids), whole,
                               rtol=0, atol=0)
    want = torch.from_numpy(np.array(rkmeans.assign(
        jnp.asarray(flat.numpy()), jnp.asarray(np.array(ri.centroids)))))
    diff = whole != want
    gap = tkmeans.choice_gap(flat[diff], pi.centroids, want[diff],
                             whole[diff])
    assert (gap <= tkmeans.NEAR_TIE_EPS).all(), gap.max()


# ---------------------------------------------------------------------------
# Compaction, timeline contracts on the port itself, persistence, footprints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def timelines(corpus):
    ref = stream_timeline(corpus)
    return ref, port_timeline_of(ref)


@pytest.mark.parametrize("lo,hi", [(0, 3), (0, 2), (1, 3)])
def test_merge_generations_matches_reference(timelines, lo, hi):
    ref, port = timelines
    want = rstore.merge_generations(ref, lo, hi)
    got = tstore.merge_generations(port, lo, hi)
    assert got.offsets == want.offsets
    for rg, rm, pg, pm in zip(want.generations, want.metas, got.generations,
                              got.metas):
        hold_equal((rg, rm), (pg, pm))
    assert got.fingerprints == want.fingerprints
    assert got.fingerprints[:lo] == port.fingerprints[:lo]


@pytest.fixture(scope="module")
def port_grown(corpus, base):
    """The port's own timeline and the monolithic index grown over the same
    union corpus (its own encode: the contract needs no reference)."""
    _, _, pi, pm = base
    c = corpus
    tl = tstore.ShardedTimeline.of((pi, pm))
    mono = (pi, pm)
    for lo in (200, 400):
        args = (c.doc_embs[lo:lo + 200], c.doc_lens[lo:lo + 200],
                predicates(lo, lo + 200))
        tl = tl.append(*tstore.new_generation(pi, pm, *args, device="cpu"))
        mono = tstore.add_passages(*mono, *args, device="cpu")
    return tl, mono


def _same(a, b):
    assert torch.equal(a.doc_ids, b.doc_ids)
    assert torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_port_timeline_equals_monolithic(corpus, port_grown, lane):
    tl, (mono, _) = port_grown
    q, qm = queries(corpus, slice(0, 6), 4)
    cfg = teng.EngineConfig(**LOSSLESS, **LANES[lane])
    _same(teng.retrieve_timeline(tl, q, cfg, qm, device="cpu"),
          teng.retrieve(mono, q, cfg, qm, device="cpu"))


@pytest.mark.parametrize("lo,hi", [(0, 3), (1, 3)])
@pytest.mark.parametrize("lane", sorted(LANES))
def test_port_merged_equals_its_timeline(corpus, port_grown, lane, lo, hi):
    tl, _ = port_grown
    q, _ = queries(corpus, slice(6, 12))
    cfg = teng.EngineConfig(**LOSSLESS, **LANES[lane])
    merged = tstore.merge_generations(tl, lo, hi)
    assert len(merged) == 3 - (hi - lo) + 1
    _same(teng.retrieve_timeline(merged, q, cfg, device="cpu"),
          teng.retrieve_timeline(tl, q, cfg, device="cpu"))


def test_port_save_index_reads_in_the_reference(corpus, base, tmp_path):
    """The port writes what the reference reads: the manifest byte for byte
    as the reference writes it, the arrays (uint32 predicate words
    included), and the reference's retrieve on the loaded index unchanged;
    a port save_timeline loads in the reference with equal fingerprints."""
    ri, rm, pi, pm = base
    gen = tstore.new_generation(pi, pm, corpus.doc_embs[200:300],
                                corpus.doc_lens[200:300],
                                predicates(200, 300), device="cpu")
    a = tstore.save_index(str(tmp_path / "port"), *gen)
    loaded, lmeta = rstore.load_index(a)
    assert dataclasses.asdict(lmeta) == dataclasses.asdict(gen[1])
    assert loaded.pred_words.dtype == jnp.uint32
    assert rstore.index_fingerprint(loaded) == tstore.index_fingerprint(
        gen[0])
    b = rstore.save_index(str(tmp_path / "ref"), loaded, lmeta)
    for name in ("manifest.json", "arrays.npz"):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    q = jnp.asarray(corpus.queries[:4])
    in_memory = type(ri)(**{f: jnp.asarray(getattr(gen[0], f).numpy())
                            for f in ri._fields})
    cfg = reng.EngineConfig(**{**KW, "n_filter": 64}, use_kernels=True)
    want = reng.retrieve(in_memory, q, cfg)
    got = reng.retrieve(loaded, q, cfg)
    np.testing.assert_array_equal(np.asarray(got.doc_ids),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(np.asarray(got.scores),
                                  np.asarray(want.scores))
    tl = tstore.ShardedTimeline.of((pi, pm), gen)
    rtl = rstore.load_timeline(tstore.save_timeline(str(tmp_path / "tl"),
                                                    tl))
    assert rtl.fingerprints == tl.fingerprints


def test_timeline_round_trip_on_the_port(corpus, timelines, tmp_path):
    _, port = timelines
    path = tstore.save_timeline(str(tmp_path / "tl"), port)
    back = tstore.load_timeline(path, device="cpu")
    assert back.fingerprints == port.fingerprints
    assert back.offsets == port.offsets
    q, _ = queries(corpus, slice(0, 4))
    cfg = teng.EngineConfig(**KW, use_kernels=True)
    _same(teng.retrieve_timeline(back, q, cfg, device="cpu"),
          teng.retrieve_timeline(port, q, cfg, device="cpu"))


def test_footprints_match_reference(timelines, budgeted, corpus):
    ref, port = timelines
    for (rg, rm, _), (pg, pm, _) in zip(ref, port):
        assert tstore.generation_footprint(pg, pm) == \
            rstore.generation_footprint(rg, rm)
    assert tstore.timeline_footprint(port) == rstore.timeline_footprint(ref)
    ri, rm, pi, pm = budgeted
    rb = rstore.ShardedTimeline.of((ri, rm))
    pb = tstore.ShardedTimeline.of((pi, pm))
    assert tstore.timeline_footprint(pb) == rstore.timeline_footprint(rb)
    # an epoch under a budget beside the unbudgeted one
    rb = rstore.ShardedTimeline.of((ref.generations[0], dataclasses.replace(
        ref.metas[0], doc_budget=24)))
    pb = tstore.ShardedTimeline.of((port.generations[0], dataclasses.replace(
        port.metas[0], doc_budget=24)))
    want = rstore.timeline_footprint(rstore.EpochedTimeline((ref, rb)))
    got = tstore.timeline_footprint(tstore.EpochedTimeline((port, pb)))
    assert got == want and got["doc_budget"] == "mixed"


# ---------------------------------------------------------------------------
# Refusals: the reference's message, word for word
# ---------------------------------------------------------------------------

def _refusals(c, base, timelines, other, path):
    """name -> (reference call, port call), each raising ValueError."""
    ri, rm, pi, pm = base
    rtl, ptl = timelines
    rep = dataclasses.replace
    embs, lens = c.doc_embs[200:210], c.doc_lens[200:210]
    pred = predicates(200, 210)

    cases = {}

    def case(name, r, t):
        cases[name] = (r, t)

    case("timeline_geometry",
         lambda: rstore.ShardedTimeline.of((ri, rm), (ri, rep(
             rm, n_centroids=256))),
         lambda: tstore.ShardedTimeline.of((pi, pm), (pi, rep(
             pm, n_centroids=256))))
    case("timeline_predicates",
         lambda: rstore.ShardedTimeline.of((ri, rm), (ri, rep(
             rm, pred_names=("recent",)))),
         lambda: tstore.ShardedTimeline.of((pi, pm), (pi, rep(
             pm, pred_names=("recent",)))))
    case("timeline_codebooks",
         lambda: rstore.ShardedTimeline.of((ri, rm), other),
         lambda: tstore.ShardedTimeline.of(
             (pi, pm), (port_index(other[0]), port_meta(other[1]))))
    case("timeline_pairing",
         lambda: rstore.ShardedTimeline((ri,), (rm, rm)),
         lambda: tstore.ShardedTimeline((pi,), (pm, pm)))
    case("timeline_empty", lambda: rstore.ShardedTimeline((), ()),
         lambda: tstore.ShardedTimeline((), ()))
    for lo, hi in ((1, 2), (2, 5), (2, 1), (-1, 1)):
        case(f"merge_range_{lo}_{hi}",
             lambda lo=lo, hi=hi: rstore.merge_generations(rtl, lo, hi),
             lambda lo=lo, hi=hi: tstore.merge_generations(ptl, lo, hi))
    case("merge_mixed_budgets",
         lambda: rstore.merge_generations(rstore.ShardedTimeline(
             rtl.generations, rtl.metas[:2] + (rep(rtl.metas[2],
                                                   doc_budget=24),)), 0, 3),
         lambda: tstore.merge_generations(tstore.ShardedTimeline(
             ptl.generations, ptl.metas[:2] + (rep(ptl.metas[2],
                                                   doc_budget=24),)), 0, 3))
    case("merge_placeholder_plaid",
         lambda: rstore.merge_generations(rstore.ShardedTimeline(
             (rtl.generations[0]._replace(
                 plaid_res=jnp.zeros((1, 1, 1), jnp.uint8)),)
             + rtl.generations[1:], rtl.metas), 0, 2),
         lambda: tstore.merge_generations(tstore.ShardedTimeline(
             (ptl.generations[0]._replace(
                 plaid_res=torch.zeros((1, 1, 1), dtype=torch.uint8)),)
             + ptl.generations[1:], ptl.metas), 0, 2))
    case("k_over_generation",
         lambda: reng.adapt_config_to_corpus(reng.EngineConfig(**KW), 9),
         lambda: teng.adapt_config_to_corpus(teng.EngineConfig(**KW), 9))
    q = c.queries[:2]
    case("filter_names",
         lambda: reng.retrieve_generation_topk(
             ri, rm, 0, jnp.asarray(q), reng.EngineConfig(**KW),
             doc_filter=reng.bitvector.compile_filter(
                 reng.bitvector.Pred("recent"), NAMES[::-1])),
         lambda: teng.retrieve_generation_topk(
             pi, pm, 0, q, teng.EngineConfig(**KW),
             doc_filter=tbv.compile_filter(tbv.Pred("recent"), NAMES[::-1]),
             device="cpu"))
    case("timeline_filter_names",
         lambda: reng.retrieve_timeline(
             rtl, jnp.asarray(q), reng.EngineConfig(**KW),
             doc_filter=reng.bitvector.compile_filter(
                 reng.bitvector.Pred("recent"), ("recent",))),
         lambda: teng.retrieve_timeline(
             ptl, q, teng.EngineConfig(**KW),
             doc_filter=tbv.compile_filter(tbv.Pred("recent"), ("recent",)),
             device="cpu"))
    bad = np.zeros((4, rm.cap + 3, rm.d), np.float32)
    grow = {
        "geometry": (bad, np.full(4, 5, np.int32), None),
        "ragged": (embs[:, :, :], lens[:4], None),
        "empty": (np.zeros((0, rm.cap, rm.d), np.float32),
                  np.zeros(0, np.int32), pred),
        "missing_predicates": (embs, lens, None),
        "wrong_names": (embs, lens, {"recent": pred["recent"]}),
        "wrong_count": (embs, lens, predicates(200, 205)),
    }
    for name, (e, ln, p) in grow.items():
        for op in ("new_generation", "add_passages"):
            case(f"{op}_{name}",
                 lambda e=e, ln=ln, p=p, op=op: getattr(rstore, op)(
                     ri, rm, e, ln, p),
                 lambda e=e, ln=ln, p=p, op=op: getattr(tstore, op)(
                     pi, pm, e, ln, p, device="cpu"))
    case("predicates_without_plane",
         lambda: rstore.new_generation(ri, rep(rm, pred_names=()), embs,
                                       lens, pred),
         lambda: tstore.new_generation(pi, rep(pm, pred_names=()), embs,
                                       lens, pred, device="cpu"))
    order = {"recent": pred["recent"], "lang_en": pred["lang_en"]}
    case("predicate_set_order",
         lambda: rstore.add_passages(ri, rm, embs, lens,
                                     RPredicateSet.pack(order)),
         lambda: tstore.add_passages(pi, pm, embs, lens,
                                     tbv.PredicateSet.pack(order),
                                     device="cpu"))
    raw = np.random.default_rng(1).normal(size=(2, 40, rm.d)).astype(
        np.float32)
    raw[:, 35:] = 0.0
    case("budget_over_cap",
         lambda: rstore.new_generation(ri, rep(rm, doc_budget=30), raw,
                                       np.array([35, 35]), pred_two(pred)),
         lambda: tstore.new_generation(pi, rep(pm, doc_budget=30), raw,
                                       np.array([35, 35]), pred_two(pred),
                                       device="cpu"))
    case("epoched_empty", lambda: rstore.EpochedTimeline(()),
         lambda: tstore.EpochedTimeline(()))
    case("epoched_type", lambda: rstore.EpochedTimeline((rtl, "x")),
         lambda: tstore.EpochedTimeline((ptl, "x")))
    case("epoched_geometry",
         lambda: rstore.EpochedTimeline((rtl, rstore.ShardedTimeline.of(
             (ri, rep(rm, cap=30))))),
         lambda: tstore.EpochedTimeline((ptl, tstore.ShardedTimeline.of(
             (pi, rep(pm, cap=30))))))
    for name in _DIRS:
        case(f"load_{name}",
             lambda name=name: rstore.load_timeline(
                 os.path.join(path, name)),
             lambda name=name: tstore.load_timeline(
                 os.path.join(path, name), device="cpu"))
    return cases


def pred_two(pred):
    return {n: v[:2] for n, v in pred.items()}


# timeline directories the loader refuses: name -> edit of a good save
_DIRS = {
    "missing": None,
    "corrupt_json": "{not json",
    "wrong_format": {"format": "emvb-packed-index"},
    "future_schema": {"schema_version": rstore.SCHEMA_VERSION + 1},
    "no_generations": {"generations": []},
    "no_fingerprints": {"fingerprints": None},
    "short_fingerprints": {"fingerprints": ["0" * 64]},
    "swapped": "swap",
}


def _make_dirs(root, rtl):
    good = rstore.save_timeline(os.path.join(root, "good"), rtl)
    for name, edit in _DIRS.items():
        p = os.path.join(root, name)
        if edit is None:
            continue
        shutil.copytree(good, p)
        tj = os.path.join(p, "timeline.json")
        if edit == "swap":
            shutil.rmtree(os.path.join(p, "gen-0002"))
            shutil.copytree(os.path.join(p, "gen-0001"),
                            os.path.join(p, "gen-0002"))
        elif isinstance(edit, str):
            with open(tj, "w") as f:
                f.write(edit)
        else:
            with open(tj) as f:
                man = json.load(f)
            man.update(edit)
            if man["fingerprints"] is None:
                del man["fingerprints"]
            with open(tj, "w") as f:
                json.dump(man, f)


@pytest.fixture(scope="module")
def refusals(corpus, base, timelines, tmp_path_factory):
    other = build_index(jax.random.PRNGKey(7), corpus.doc_embs[200:400],
                        corpus.doc_lens[200:400],
                        predicates=predicates(200, 400), **BUILD)
    root = str(tmp_path_factory.mktemp("refusals"))
    _make_dirs(root, timelines[0])
    return _refusals(corpus, base, timelines, other, root)


REFUSALS = sorted(
    ["timeline_geometry", "timeline_predicates", "timeline_codebooks",
     "timeline_pairing", "timeline_empty", "merge_mixed_budgets",
     "merge_placeholder_plaid", "k_over_generation", "filter_names",
     "timeline_filter_names", "predicates_without_plane",
     "predicate_set_order", "budget_over_cap", "epoched_empty",
     "epoched_type", "epoched_geometry"]
    + [f"merge_range_{lo}_{hi}"
       for lo, hi in ((1, 2), (2, 5), (2, 1), (-1, 1))]
    + [f"{op}_{n}" for op in ("new_generation", "add_passages")
       for n in ("geometry", "ragged", "empty", "missing_predicates",
                 "wrong_names", "wrong_count")]
    + [f"load_{n}" for n in _DIRS])


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_reference(refusals, name):
    ref_call, port_call = refusals[name]
    with pytest.raises(ValueError) as r:
        ref_call()
    with pytest.raises(ValueError) as t:
        port_call()
    assert str(t.value) == str(r.value)
