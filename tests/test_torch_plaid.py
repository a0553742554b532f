"""The port's PLAID baseline (``repro_torch.core.plaid``) and the interaction
functions it adds, against the JAX reference on the CPU.

* ``interaction.maxsim`` (an einsum in both frameworks: scores at rtol
  1e-5, hazard 3), ``centroid_interaction_batch`` and
  ``token_compaction_mask`` (exact) against the reference's, on seeded
  tie-heavy inputs;
* PLAID on the reference's saved ``build_index`` (real b = 2 PLAID
  residuals), loaded by the port with ``load_index(device="cpu")``: phases
  1-3 bit-exact with the reference's CS injected (bitmap, the cut's ids,
  the decompressed embeddings' float32 bits), phase 4 and ``retrieve`` with
  the ids equal and the scores at rtol 1e-5 (MaxSim's einsum), one query
  and batched, and a config whose candidates are fewer than ``n_docs``
  (the lowest-index -inf docs fill the cut, as in the reference).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import interaction as rint
from repro.core import plaid as rplaid
from repro.core import store as rstore
from repro_torch.core import interaction as tint
from repro_torch.core import plaid as tplaid
from repro_torch.core import store as tstore
from repro_torch.core.plaid import PlaidConfig
from repro_torch.kernels import ops as tops
from torch_inputs import quant

torch.set_num_threads(1)

RTOL = 1e-5     # MaxSim's einsum: XLA's and torch's float32 bits differ

CFGS = {
    "default": PlaidConfig(),
    "k100": PlaidConfig(k=100, n_docs=100, nprobe=4),   # table1's k = 100
    "nprobe1": PlaidConfig(nprobe=1, n_docs=32, k=8),
}


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def saved(small_index, tmp_path_factory):
    """The reference's index, saved and loaded into the port."""
    idx, meta = small_index
    path = rstore.save_index(str(tmp_path_factory.mktemp("plaid") / "ix"),
                             idx, meta)
    return idx, tstore.load_index(path, device="cpu")[0]


@jax.jit
def _ref_cs(centroids, q):
    return jax.vmap(lambda x: reng.centroid_scores(x, centroids))(q)


def _rcfg(cfg):
    return rplaid.PlaidConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# interaction: maxsim, centroid_interaction_batch, token_compaction_mask
# ---------------------------------------------------------------------------

def _docs(seed, nb, docs, cap, n_c, n_q, d):
    rng = np.random.default_rng(seed)
    cs_t = quant(rng.normal(size=(nb, n_c, n_q)) * 0.5, 4)
    codes = rng.integers(0, n_c, size=(nb, docs, cap)).astype(np.int32)
    lens = rng.integers(0, cap + 1, size=(nb, docs))
    mask = np.arange(cap) < lens[..., None]
    codes[~mask] = n_c
    # unit rows, as ColBERT's query terms and token embeddings are
    q = rng.normal(size=(nb, n_q, d)).astype(np.float32)
    emb = rng.normal(size=(nb, docs, cap, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return cs_t, codes, mask, q, emb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maxsim_matches_reference(seed):
    _, _, mask, q, emb = _docs(seed, 3, 40, 12, 50, 16, 24)
    for b in range(3):
        want = np.asarray(rint.maxsim(jnp.asarray(q[b]), jnp.asarray(emb[b]),
                                      jnp.asarray(mask[b])))
        got = tint.maxsim(*map(torch.from_numpy, (q[b], emb[b], mask[b])))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
        # an all-padding doc scores n_q * -1e9 in both
        assert np.isfinite(got.numpy()).all()
    batched = tint.maxsim(*map(torch.from_numpy, (q, emb, mask)))
    for b in range(3):
        np.testing.assert_array_equal(bits(batched[b]), bits(tint.maxsim(
            *map(torch.from_numpy, (q[b], emb[b], mask[b])))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_centroid_interaction_batch_matches_reference(dtype):
    cs_t, codes, mask, _, _ = _docs(3, 4, 30, 10, 60, 16, 8)
    rcs = jnp.asarray(cs_t).astype(dtype)
    want = rint.centroid_interaction_batch(rcs, jnp.asarray(codes),
                                           jnp.asarray(mask))
    tcs = torch.from_numpy(cs_t).to(getattr(torch, dtype))
    got = tint.centroid_interaction_batch(tcs, torch.from_numpy(codes),
                                          torch.from_numpy(mask))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(bits(got.float()),
                                  bits(np.asarray(want, np.float32)))


@pytest.mark.parametrize("th_r", [0.0, 0.25, 0.5, 2.0])
def test_token_compaction_mask_matches_reference(th_r):
    cs_t, codes, mask, _, _ = _docs(4, 1, 50, 16, 70, 32, 8)
    want = rint.token_compaction_mask(jnp.asarray(cs_t[0]),
                                      jnp.asarray(codes[0]),
                                      jnp.asarray(mask[0]), th_r)
    got = tint.token_compaction_mask(*map(torch.from_numpy, (
        cs_t[0], codes[0], mask[0])), th_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batched = tint.token_compaction_mask(*map(torch.from_numpy, (
        cs_t, codes, mask)), th_r)
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())


# ---------------------------------------------------------------------------
# PLAID on the reference's saved index
# ---------------------------------------------------------------------------

def _ref_phases(ridx, q, cfg):
    """The reference's four phases for one query."""
    rcfg = _rcfg(cfg)
    cs, bitmap = rplaid.phase_retrieval(ridx, jnp.asarray(q), rcfg)
    sel2 = rplaid.phase_filtering(ridx, cs, bitmap, rcfg)
    emb = rplaid.phase_decompression(ridx, sel2)
    top = rplaid.phase_late_interaction(ridx, jnp.asarray(q), emb, sel2,
                                        cfg.k)
    return cs, bitmap, sel2, emb, top


@pytest.mark.parametrize("name", sorted(CFGS))
def test_phases_match_reference_one_query(small_corpus, saved, name):
    """Phases 1-3 bit-exact on the reference's CS; phase 4's ids equal and
    its scores at rtol 1e-5."""
    ridx, tidx = saved
    cfg = CFGS[name]
    for qi in (0, 5):
        q = np.array(small_corpus.queries[qi], np.float32)
        cs, bitmap, sel2, emb, (rsc, rids) = _ref_phases(ridx, q, cfg)
        tcs, tbm = tplaid.phase_retrieval(tidx, q, cfg,
                                          cs=np.array(cs), device="cpu")
        np.testing.assert_array_equal(bits(tcs), bits(cs))
        np.testing.assert_array_equal(tbm.numpy(), np.asarray(bitmap))
        tsel = tplaid.phase_filtering(tidx, tcs, tbm, cfg, device="cpu")
        assert tsel.dtype == torch.int32
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel2))
        temb = tplaid.phase_decompression(tidx, tsel, device="cpu")
        np.testing.assert_array_equal(bits(temb), bits(emb))
        tsc, tids = tplaid.phase_late_interaction(tidx, q, temb, tsel,
                                                  cfg.k, device="cpu")
        np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(rsc), rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_retrieve_matches_reference(small_corpus, saved, name):
    """retrieve at B = 4 with the reference's CS injected: ids equal,
    scores at rtol 1e-5; cinter runs its plain version on the CPU (no
    launch), and the batched phases equal retrieve."""
    ridx, tidx = saved
    cfg = CFGS[name]
    q = np.array(small_corpus.queries[:4], np.float32)
    want = rplaid.retrieve(ridx, jnp.asarray(q), _rcfg(cfg))
    cs = np.array(_ref_cs(ridx.centroids, jnp.asarray(q)))
    tops.reset_launches()
    got = tplaid.retrieve(tidx, q, cfg, cs=cs, device="cpu")
    assert set(tops.launch_counts().values()) == {0}
    assert got.doc_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=RTOL)
    tcs, bm = tplaid.phase_retrieval(tidx, q, cfg, cs=cs, device="cpu")
    sel2 = tplaid.phase_filtering(tidx, tcs, bm, cfg, device="cpu")
    emb = tplaid.phase_decompression(tidx, sel2, device="cpu")
    sc, ids = tplaid.phase_late_interaction(tidx, q, emb, sel2, cfg.k,
                                            device="cpu")
    np.testing.assert_array_equal(ids.numpy(), got.doc_ids.numpy())
    np.testing.assert_array_equal(bits(sc), bits(got.scores))


def test_retrieve_own_cs_finds_the_reference_ids(small_corpus, saved):
    """Without injection the port's own CS product: the same ids as the
    reference on these queries, scores at rtol 1e-5."""
    ridx, tidx = saved
    cfg = CFGS["default"]
    q = np.array(small_corpus.queries[4:12], np.float32)
    want = rplaid.retrieve(ridx, jnp.asarray(q), _rcfg(cfg))
    got = tplaid.retrieve(tidx, torch.from_numpy(q), cfg, device="cpu")
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=RTOL)


def test_fillers_when_fewer_candidates_than_n_docs(small_corpus, saved):
    """A query of one term repeated probes one IVF list (nprobe 1), fewer
    docs than n_docs = 200: the cut fills with the lowest-index
    non-candidates (-inf S̄), which are decompressed and scored as the
    reference does."""
    ridx, tidx = saved
    cfg = PlaidConfig(nprobe=1, n_docs=200, k=10)
    q = np.repeat(np.array(small_corpus.queries[7][:1], np.float32), 32, 0)
    cs, bitmap, sel2, emb, (rsc, rids) = _ref_phases(ridx, q, cfg)
    n_cand = int(np.asarray(bitmap).sum())
    assert n_cand < cfg.n_docs
    tcs, tbm = tplaid.phase_retrieval(tidx, q, cfg, cs=np.array(cs),
                                      device="cpu")
    tsel = tplaid.phase_filtering(tidx, tcs, tbm, cfg, device="cpu")
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel2))
    fill = tsel.numpy()[n_cand:]
    assert not np.asarray(bitmap)[fill].any()
    np.testing.assert_array_equal(fill, np.sort(fill))
    got = tplaid.retrieve(tidx, q[None], cfg, cs=np.array(cs)[None],
                          device="cpu")
    np.testing.assert_array_equal(got.doc_ids[0].numpy(), np.asarray(rids))
    np.testing.assert_allclose(got.scores[0].numpy(), np.asarray(rsc),
                               rtol=RTOL)


def test_plaid_is_exported_like_the_reference():
    import repro_torch.core as core
    assert core.PlaidConfig is PlaidConfig and core.plaid is tplaid
    assert dataclasses.asdict(PlaidConfig()) == dataclasses.asdict(
        rplaid.PlaidConfig())


def test_planted_plaid_residuals_find_their_docs():
    """synthetic.with_plaid_residuals: b = 2 codes of each token's planted
    residual, deterministic; decoded they lie within a bucket of it; PLAID
    finds the planted docs (chip_smoke.py's plaid data at a tiny width)."""
    from repro_torch.core.pq import PQCodebooks, decode_pq
    from repro_torch.core.residual import decode_residual
    from repro_torch.data import synthetic
    widths = dict(n_docs=600, cap=12, min_len=5, d=32, n_centroids=96, m=4,
                  nbits=4, list_cap=None, device="cpu")
    index, meta = synthetic.make_packed_index(3, **widths)
    a, ameta = synthetic.with_plaid_residuals(index, meta)
    b, _ = synthetic.with_plaid_residuals(index, meta)
    assert ameta.plaid_b == 2 and a.plaid_res.shape == (600, 12, 8)
    assert torch.equal(a.plaid_res, b.plaid_res)
    res = decode_pq(index.res_codes.reshape(-1, 4),
                    PQCodebooks(index.pq_codebooks))
    dec = decode_residual(a.plaid_res, a.plaid_codec, 32).reshape(-1, 32)
    span = float(a.plaid_weights[-1] - a.plaid_weights[0])
    assert float((dec - res).abs().mean()) < span / 4
    q, gt = synthetic.make_queries(a, 4, 8, 16)
    got = tplaid.retrieve(a, q, PlaidConfig(n_q=16, n_docs=32, k=10),
                          device="cpu")
    assert synthetic.success_at_k(got.doc_ids.numpy(), gt.numpy(), 10) >= 0.9
