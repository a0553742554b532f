"""The trained index build of the port against ``repro.core``.

The port cannot replay ``jax.random`` keys, so training is held step by
step: ``kmeans._update`` on the same rows and assignment gives the
reference's bits on every non-empty cluster (empty ones reseed from each
package's own draws); Lloyd's loop from the same initial centroids gives the
reference's centroids; ``train_residual_codec`` on the same sample gives the
reference's cutoffs and weights (to the bit under the test lane's
unoptimized XLA backend, within one ulp under XLA's FMA contraction), and
the quantile takes inputs beyond ``torch.quantile``'s 2^24 elements. Whole builds are held to
retrieval quality (MRR@10 within ``MRR_TOL`` of the reference build's) and
to every deterministic field; one seed gives one index fingerprint. OPQ's
rotation is held orthonormal and its reconstruction error against plain
PQ's, never to the reference's bits (sign flips of singular vectors leave
the rotation unchanged).
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as ref_build_index
from repro.core import engine as reng
from repro.core import kmeans as rkm
from repro.core import pq as rpq
from repro.core import residual as rres
from repro.core import store as rstore
from repro.data.synthetic import make_corpus, mrr_at_k
from repro_torch.core import build_index, index_fingerprint
from repro_torch.core import engine as teng
from repro_torch.core import kmeans as tkm
from repro_torch.core import pq as tpq
from repro_torch.core import residual as tres

torch.set_num_threads(1)

BUILD = dict(n_centroids=128, m=8, nbits=4, kmeans_iters=3)
KW = dict(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48, k=10)
MRR_TOL = 0.05   # a trained build's MRR@10 against the reference build's


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(3, n_docs=800, cap=24, min_len=8, n_queries=32,
                       n_topics=32)


def unit_rows(seed, n, d, clusters, labels=False):
    """n unit rows around ``clusters`` random directions (and each row's
    direction)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d))
    lab = rng.integers(0, clusters, n)
    x = centers[lab] + 0.3 * rng.normal(size=(n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return (x, lab) if labels else x


# ---------------------------------------------------------------------------
# k-means, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,empty", [(3000, 128, 64, 5), (2000, 8, 16, 0),
                                         (500, 16, 256, 0)])
def test_update_matches_reference(n, d, k, empty):
    """``_update`` on the same rows and assignment: the reference's bits on
    every non-empty cluster; an empty cluster (``empty``, and at k = 256
    over 500 rows many more) takes one of the rows."""
    x = unit_rows(n + k, n, d, 12)
    a = np.random.default_rng(k).integers(0, k, n).astype(np.int32)
    a[a == empty] = (empty + 1) % k          # cluster ``empty`` is empty
    old = x[:k]
    want = np.asarray(rkm._update(jnp.asarray(x), jnp.asarray(a), k,
                                  jnp.asarray(old), jax.random.PRNGKey(1)))
    got = tkm._update(torch.from_numpy(x), torch.from_numpy(a), k,
                      torch.from_numpy(old), tkm.generator(1)).numpy()
    live = np.bincount(a, minlength=k) > 0
    assert not live[empty]
    np.testing.assert_array_equal(bits(got[live]), bits(want[live]))
    for c in np.flatnonzero(~live):
        assert (got[c] == x).all(axis=1).any()


def test_update_is_deterministic():
    x = torch.from_numpy(unit_rows(0, 4000, 32, 9))
    a = torch.from_numpy(np.random.default_rng(2).integers(0, 40, 4000))
    one = tkm._update(x, a, 48, x[:48], tkm.generator(3))
    two = tkm._update(x, a, 48, x[:48], tkm.generator(3))
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))


@pytest.mark.parametrize("d,k,iters", [(128, 32, 4), (8, 16, 6)])
def test_lloyd_from_the_same_start_matches_reference(d, k, iters):
    """Lloyd's loop from the same initial centroids: the reference's own
    assign and _update driven in a loop against the port's ``_lloyd``, to
    the bit (no cluster empties on this data, so no reseed is drawn from
    either package's generator)."""
    x, lab = unit_rows(d, 2500, d, k, labels=True)
    c0 = x[[np.flatnonzero(lab == c)[0] for c in range(k)]]  # one a cluster
    c = jnp.asarray(c0)
    for step in range(iters):
        a = rkm.assign(jnp.asarray(x), c)
        assert (np.bincount(np.asarray(a), minlength=k) > 0).all()
        c = rkm._update(jnp.asarray(x), a, k, c, jax.random.PRNGKey(step))
    got = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(c0), iters,
                     tkm.generator(0))
    np.testing.assert_array_equal(bits(got), bits(c))


def test_kmeans_seeds_distinct_rows_and_refuses_too_few():
    x = unit_rows(1, 300, 16, 6)
    c, a = tkm.kmeans(5, x, 24, iters=3, device="cpu")
    c2, a2 = tkm.kmeans(torch.Generator().manual_seed(5), x, 24, iters=3,
                        device="cpu")
    assert torch.equal(c, c2) and torch.equal(a, a2)
    assert c.shape == (24, 16) and a.dtype == torch.int32
    assert torch.equal(a, tkm.assign(torch.from_numpy(x), c))
    cs, _ = tkm.kmeans_spherical(5, x, 24, iters=3, device="cpu")
    assert torch.allclose(cs.norm(dim=1), torch.ones(24))
    with pytest.raises(ValueError, match="cannot seed k=301"):
        tkm.kmeans(0, x, 301, device="cpu")


def test_kmeans_quality_against_reference():
    """Same data, different draws: the port's and the reference's k-means
    reach the same mean squared distance to the nearest centroid, within
    5 %."""
    x = unit_rows(9, 3000, 32, 20)

    def inertia(c, a):
        return float(np.mean(np.sum((x - np.asarray(c)[np.asarray(a)]) ** 2,
                                    axis=1)))
    ref = inertia(*rkm.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), 20,
                              iters=8))
    got = inertia(*tkm.kmeans(0, x, 20, iters=8, device="cpu"))
    assert got <= ref * 1.05


# ---------------------------------------------------------------------------
# PQ, OPQ and the PLAID codec
# ---------------------------------------------------------------------------

def residuals(seed, n=4000, d=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * 0.2).astype(np.float32)


def test_train_pq_quality_and_shape():
    x = residuals(0)
    cb = tpq.train_pq(1, x, 8, nbits=4, iters=6, device="cpu")
    assert cb.codebooks.shape == (8, 16, 4)
    ref = rpq.train_pq(jax.random.PRNGKey(1), jnp.asarray(x), 8, nbits=4,
                       iters=6)
    got_mse = float(tpq.pq_reconstruction_mse(torch.from_numpy(x), cb))
    ref_mse = float(rpq.pq_reconstruction_mse(jnp.asarray(x), ref))
    assert got_mse <= ref_mse * 1.05
    again = tpq.train_pq(1, x, 8, nbits=4, iters=6, device="cpu")
    assert torch.equal(cb.codebooks, again.codebooks)


def test_pq_reconstruction_mse_and_lut_score_match_reference():
    """On the same codebooks: the reconstruction error (a mean, rtol 1e-6)
    and the LUT scores (summed s = 0..m-1, to the bit)."""
    x = residuals(1)
    cb = np.array(rpq.train_pq(jax.random.PRNGKey(2), jnp.asarray(x), 8,
                               nbits=4, iters=3).codebooks)
    tcb, rcb = tpq.PQCodebooks(torch.from_numpy(cb)), rpq.PQCodebooks(
        jnp.asarray(cb))
    np.testing.assert_allclose(
        float(tpq.pq_reconstruction_mse(torch.from_numpy(x), tcb)),
        float(rpq.pq_reconstruction_mse(jnp.asarray(x), rcb)), rtol=1e-6)
    codes = np.array(rpq.encode_pq(jnp.asarray(x[:300]), rcb))
    q = residuals(2, 1, 32)[0]
    lut = np.array(rpq.build_lut(jnp.asarray(q), rcb))
    want = rpq.lut_score(jnp.asarray(lut), jnp.asarray(codes))
    got = tpq.lut_score(torch.from_numpy(lut), torch.from_numpy(codes))
    assert got.shape == (300,)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_train_opq_rotation_orthonormal_and_beats_pq():
    rng = np.random.default_rng(3)
    # correlated dimensions: a rotation helps
    x = (rng.normal(size=(3000, 16)) @ rng.normal(size=(16, 16)) * 0.05
         ).astype(np.float32)
    opq = tpq.train_opq(0, x, 4, nbits=4, kmeans_iters=4, opq_iters=3,
                        device="cpu")
    r = opq.rotation.double()
    assert torch.allclose(r @ r.T, torch.eye(16, dtype=torch.float64),
                          atol=1e-5)
    xt = torch.from_numpy(x)
    opq_mse = float(tpq.pq_reconstruction_mse(xt @ opq.rotation, opq.cb))
    pq_mse = float(tpq.pq_reconstruction_mse(
        xt, tpq.train_pq(0, x, 4, nbits=4, iters=4, device="cpu")))
    ref = rpq.train_opq(jax.random.PRNGKey(0), jnp.asarray(x), 4, nbits=4,
                        kmeans_iters=4, opq_iters=3)
    ref_mse = float(rpq.pq_reconstruction_mse(jnp.asarray(x) @ ref.rotation,
                                              ref.cb))
    assert opq_mse <= pq_mse * 1.02
    assert opq_mse <= ref_mse * 1.10


def assert_quantiles(got, want):
    """Equal bits when the reference's XLA backend runs unoptimized (the
    test lane's flag, tests/conftest.py); at most one ulp apart when it
    fuses the interpolation's last product and sum into an FMA."""
    g = bits(got).astype(np.int64)
    w = bits(want).astype(np.int64)
    if "--xla_backend_optimization_level=0" in os.environ.get("XLA_FLAGS",
                                                              ""):
        np.testing.assert_array_equal(g, w)
    assert np.abs(g - w).max() <= 1


@pytest.mark.parametrize("n", [1000, 12_345, 65_536 * 8])
@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_train_residual_codec_matches_reference(n, b):
    x = (np.random.default_rng(n + b).normal(size=n) * 0.1).astype(
        np.float32)
    want = rres.train_residual_codec(jnp.asarray(x), b)
    got = tres.train_residual_codec(torch.from_numpy(x), b)
    assert got.b == b
    assert_quantiles(got.cutoffs, want.cutoffs)
    assert_quantiles(got.bucket_weights, want.bucket_weights)


def test_quantile_beyond_torch_quantile_limit():
    """2^24 + 3 elements, which ``torch.quantile`` refuses: the port's
    quantile still equals the reference's."""
    x = (np.random.default_rng(0).normal(size=(1 << 24) + 3) * 0.1).astype(
        np.float32)
    q = np.array([0.25, 0.5, 0.75, 0.125], np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x), torch.from_numpy(q))
    got = tres.quantile(torch.from_numpy(x), torch.from_numpy(q))
    assert_quantiles(got, jnp.quantile(jnp.asarray(x), jnp.asarray(q)))
    nan = x[:100].copy()
    nan[7] = np.nan
    assert torch.isnan(tres.quantile(torch.from_numpy(nan),
                                     torch.from_numpy(q))).all()


# ---------------------------------------------------------------------------
# build_index: quality and deterministic fields
# ---------------------------------------------------------------------------

def predicates(n):
    rng = np.random.default_rng(11)
    return {"lang_en": rng.random(n) < 0.7, "recent": rng.random(n) < 0.3}


BUILDS = {
    "plain": {},
    "list_cap": dict(list_cap=40),
    "predicates_budget": dict(doc_budget=12),
    "opq": dict(use_opq=True),
}


@pytest.fixture(scope="module")
def builds(corpus):
    """name -> ((reference index, meta), (port index, meta))."""
    c = corpus
    out = {}
    for name, over in BUILDS.items():
        kw = {**BUILD, **over}
        if name == "predicates_budget":
            kw["predicates"] = predicates(len(c.doc_lens))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = ref_build_index(jax.random.PRNGKey(0), c.doc_embs,
                                  c.doc_lens, **kw)
            got = build_index(0, c.doc_embs, c.doc_lens, device="cpu", **kw)
        out[name] = ref, got
    return out


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_index_quality_and_fields_match_reference(corpus, builds,
                                                        name):
    (ri, rm), (ti, tm) = builds[name]
    for f in ("n_docs", "n_centroids", "d", "cap", "m", "nbits", "plaid_b",
              "n_raw_tokens", "doc_budget", "pred_names", "n_grown"):
        assert getattr(tm, f) == getattr(rm, f), f
    if "list_cap" in BUILDS[name]:
        assert tm.list_cap == rm.list_cap == BUILDS[name]["list_cap"]
    np.testing.assert_array_equal(ti.pred_words.numpy(),
                                  np.asarray(ri.pred_words))
    np.testing.assert_array_equal(ti.doc_lens.numpy(),
                                  np.asarray(ri.doc_lens))
    for f in ri._fields:
        if f != "ivf" or "list_cap" in BUILDS[name]:
            # an auto-sized list_cap is the longest trained list
            assert getattr(ti, f).shape == np.asarray(getattr(ri, f)).shape, f
        assert str(getattr(ti, f).dtype).split(".")[-1] == \
            str(np.asarray(getattr(ri, f)).dtype), f
        assert getattr(ti, f).is_contiguous(), f
    # padding sentinels where the reference has them
    np.testing.assert_array_equal(ti.codes.numpy() == tm.n_centroids,
                                  np.asarray(ri.codes) == rm.n_centroids)
    assert 0 < tm.train_quant_mse and abs(tm.train_quant_mse
                                          - rm.train_quant_mse) \
        < 0.05 * rm.train_quant_mse
    q = corpus.queries
    want = np.asarray(reng.retrieve(ri, jnp.asarray(q),
                                    reng.EngineConfig(**KW)).doc_ids)
    got = teng.retrieve(ti, q, teng.EngineConfig(**KW),
                        device="cpu").doc_ids.numpy()
    ref_mrr, mrr = mrr_at_k(want, corpus.gt_doc), mrr_at_k(got, corpus.gt_doc)
    assert mrr >= ref_mrr - MRR_TOL, (mrr, ref_mrr)
    if name == "opq":
        r = ti.opq_rotation.double()
        assert torch.allclose(r @ r.T, torch.eye(128, dtype=torch.float64),
                              atol=1e-5)


def test_build_index_train_quant_mse_in_reference_order(builds):
    """The drift baseline is numpy's mean over the real residuals' squared
    norms, recomputed here from the build's own centroids and codes."""
    (_, _), (ti, tm) = builds["plain"]
    c = make_corpus(3, n_docs=800, cap=24, min_len=8, n_queries=32,
                    n_topics=32)
    from repro_torch.core.index import normalized_tokens
    mask = (np.arange(tm.cap)[None] < c.doc_lens[:, None]).reshape(-1)
    res = normalized_tokens(c.doc_embs)[mask] - ti.centroids.numpy()[
        ti.codes.numpy().reshape(-1)[mask]]
    assert tm.train_quant_mse == float(np.mean(np.sum(res * res, axis=-1)))


def test_one_seed_one_fingerprint(corpus):
    c = corpus
    kw = dict(BUILD, device="cpu")
    a, am = build_index(7, c.doc_embs[:300], c.doc_lens[:300], **kw)
    b, bm = build_index(7, c.doc_embs[:300], c.doc_lens[:300], **kw)
    other, _ = build_index(8, c.doc_embs[:300], c.doc_lens[:300], **kw)
    assert index_fingerprint(a) == index_fingerprint(b)
    assert am == bm
    assert index_fingerprint(other) != index_fingerprint(a)


def test_build_index_refusals_and_warnings_match_reference(corpus):
    c = corpus
    bad = {"x": np.ones(5, bool)}
    with pytest.raises(ValueError) as r:
        ref_build_index(jax.random.PRNGKey(0), c.doc_embs[:50],
                        c.doc_lens[:50], predicates=bad, **BUILD)
    with pytest.raises(ValueError) as t:
        build_index(0, c.doc_embs[:50], c.doc_lens[:50], predicates=bad,
                    device="cpu", **BUILD)
    assert str(t.value) == str(r.value)
    with pytest.raises(ValueError, match="cannot seed k=128"):
        build_index(0, c.doc_embs[:3], c.doc_lens[:3], device="cpu",
                    **BUILD)
    with pytest.warns(UserWarning) as rw:
        ref_build_index(jax.random.PRNGKey(0), c.doc_embs[:300],
                        c.doc_lens[:300], **{**BUILD, "list_cap": 8})
    with pytest.warns(UserWarning) as tw:
        build_index(0, c.doc_embs[:300], c.doc_lens[:300], device="cpu",
                    **{**BUILD, "list_cap": 8})
    want, got = str(rw[0].message), str(tw[0].message)
    assert got.split(";")[0].startswith("build_index:")
    assert want.split(":")[0] == got.split(":")[0]
    assert "list_cap=8" in got and got.endswith(want[want.index(" Dropped"):])


def test_built_index_round_trips_through_the_reference(corpus, builds,
                                                       tmp_path):
    """A port build saved by the port's save_index loads in the reference
    and retrieves the same ids there as in the port (the matmul bits of the
    two frameworks agree at these shapes)."""
    from repro_torch.core import store as tstore
    (_, _), (ti, tm) = builds["predicates_budget"]
    path = tstore.save_index(str(tmp_path / "idx"), ti, tm)
    ri, rm = rstore.load_index(path)
    assert dataclasses.asdict(rm) == dataclasses.asdict(tm)
    q = corpus.queries[:8]
    want = reng.retrieve(ri, jnp.asarray(q), reng.EngineConfig(**KW))
    got = teng.retrieve(ti, q, teng.EngineConfig(**KW), device="cpu")
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
