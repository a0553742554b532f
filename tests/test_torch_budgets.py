"""Budgets above the CUDA kernels' old caps (n_filter 8,192 in the
prefilter, 4,096 survivors in pqinter) through the port's ``retrieve`` and
its fused kernels' entry points, against the reference.

The configurations are the two the reference's own benchmarks run past
those caps, scaled to a planted corpus of 10,240 docs (cap 12, d 32, 256
centroids, PQ 8 x 4 bits):

* fig9's post-filter lane (``benchmarks/fig9_selectivity.py:73-76``):
  k near n_docs, n_filter about twice n_docs (here 8,448 / 4,352 / 4,200);
* fig2's no-prefilter baseline (``benchmarks/fig2_threshold.py:34-37``):
  n_filter = the whole corpus, th = -1, th_r None, n_docs 128, k 100.

The port's fused and unfused lanes run with the reference's CS and LUT
injected (the two frameworks' matmuls differ in bits; hazard 3) and equal
the reference's retrieve in doc ids and float32 score bits: fig9's lane
against the reference's unfused kernel lane (its fused lane takes ~30 s in
interpret mode at this size, and the reference's lanes are equal here:
every cut keeps passing survivors only, and th, th_r are bf16 values, so
the lanes' float32 and bf16 comparisons agree), fig2's against both of the
reference's kernel lanes. On the CPU the port's wrappers run the kernels'
plain versions; tests/test_torch_cuda.py holds the CUDA kernels against
those at the same sizes. At kernel level the reference past the old caps
is ``repro.kernels.ref``, the oracles the reference's kernel tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.index import build_index
from repro.core.pq import build_lut as ref_build_lut
from repro.data.synthetic import make_corpus
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.kernels import ops as tops
from test_torch_bf16_kernels import cinter_body

torch.set_num_threads(1)

N_DOCS, CAP, D, N_Q = 10_240, 12, 32, 32
# th and th_r are bf16 values, so bf16 and float32 comparisons agree
FIG9 = dict(n_q=N_Q, nprobe=4, th=0.3125, th_r=0.375, n_filter=8448,
            n_docs=4352, k=4200)
FIG2 = dict(n_q=N_Q, nprobe=4, th=-1.0, th_r=None, n_filter=N_DOCS,
            n_docs=128, k=100)
FUSED = dict(use_kernels=True)
UNFUSED = dict(use_kernels=True, fused_prefilter=False,
               fused_late_interaction=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(reference index, meta, port index, queries): a planted corpus with
    two predicates (``lang_en`` on about 70 % of docs, ``rare`` on 5 %),
    built by the reference, saved and loaded into the port."""
    c = make_corpus(0, n_docs=N_DOCS, cap=CAP, min_len=4, d=D, n_topics=64,
                    n_queries=4, n_q=N_Q)
    rng = np.random.default_rng(0)
    preds = {"lang_en": rng.random(N_DOCS) < 0.7,
             "rare": rng.random(N_DOCS) < 0.05}
    ref, meta = build_index(jax.random.PRNGKey(0), c.doc_embs, c.doc_lens,
                            n_centroids=256, m=8, nbits=4, kmeans_iters=2,
                            predicates=preds)
    path = tmp_path_factory.mktemp("budgets") / "idx"
    port, _ = tstore.load_index(rstore.save_index(str(path), ref, meta),
                                device="cpu")
    return ref, meta, port, np.asarray(c.queries, np.float32)


@pytest.fixture(autouse=True)
def _reference_cinter(monkeypatch):
    """The reference's cinter kernel does not run on bf16 CS under jax 0.9.0
    (tests/test_torch_bf16_engine.py); its body stands in for it."""
    monkeypatch.setattr(rops, "cinter", cinter_body)


def _ref_cs_lut(index, q, cs_dtype):
    cs = jax.vmap(lambda x: reng.centroid_scores(x, index.centroids,
                                                 cs_dtype))(q)
    q_rot = jax.vmap(lambda x: x @ index.opq_rotation)(q)
    return cs, jax.vmap(lambda x: ref_build_lut(x, index.pq))(q_rot)


def _t(x):
    """A reference array (bf16 included) as a CPU tensor."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same(got, want):
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.scores.numpy().view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32))


def _port(corpus, q, kw, plan=None):
    """The port's fused and unfused lanes on the reference's CS and LUT."""
    ref, _, port, _ = corpus
    cs, lut = _ref_cs_lut(ref, jnp.asarray(q), kw.get("cs_dtype",
                                                      "float32"))
    tops.reset_launches()
    out = {lane: teng._retrieve_batch(
        port, torch.from_numpy(q), teng.EngineConfig(**kw, **over,
                                                     doc_filter=plan),
        None, cs=_t(cs), lut=_t(lut))
        for lane, over in (("fused", FUSED), ("unfused", UNFUSED))}
    assert set(tops.launch_counts().values()) == {0}   # no CPU launch
    return out


FIG9_CASES = {
    "float32": ({}, None),
    "bf16": ({"cs_dtype": "bfloat16"}, None),
    "filtered": ({}, "lang_en"),
    "compact": ({"candidate_mode": "compact", "cand_cap": 8448}, None),
}


@pytest.mark.parametrize("case", sorted(FIG9_CASES))
def test_fig9_post_filter_budgets_match_reference(corpus, case):
    over, pred = FIG9_CASES[case]
    ref, meta, _, queries = corpus
    q = queries[:2]
    kw = {**FIG9, **over}
    rplan = tplan = None
    if pred is not None:
        rplan = rbv.compile_filter(rbv.Pred(pred), meta.pred_names)
        tplan = tbv.compile_filter(tbv.Pred(pred), meta.pred_names)
    want = reng.retrieve(ref, jnp.asarray(q), reng.EngineConfig(
        **kw, **UNFUSED), doc_filter=rplan)
    assert want.doc_ids.shape == (2, FIG9["k"])
    assert np.isfinite(np.asarray(want.scores)).all()   # no filler slot
    for got in _port(corpus, q, kw, tplan).values():
        _same(got, want)


@pytest.mark.parametrize("cs_dtype", ["float32", "bfloat16"])
def test_fig2_no_prefilter_baseline_matches_reference(corpus, cs_dtype):
    ref, _, _, queries = corpus
    q = queries[2:3]
    kw = {**FIG2, "cs_dtype": cs_dtype}
    got = _port(corpus, q, kw)
    for lane, over in (("fused", FUSED), ("unfused", UNFUSED)):
        want = reng.retrieve(ref, jnp.asarray(q),
                             reng.EngineConfig(**kw, **over))
        _same(got[lane], want)


def test_fused_kernels_past_the_old_caps_match_reference_oracles(corpus):
    """ops.prefilter over the whole corpus and at n_filter 8,448, and
    ops.pqinter over 8,448 survivors keeping 4,352 then 4,200, against
    ``repro.kernels.ref`` on the reference's CS and LUT."""
    ref, _, port, queries = corpus
    q = jnp.asarray(queries[3:4])
    cs, lut = _ref_cs_lut(ref, q, "float32")
    cs, lut = cs[0], lut[0]
    mask = ref.token_mask()
    bitmap = jnp.ones((N_DOCS,), bool).at[::3].set(False)
    tcodes, tlens = port.codes, port.doc_lens
    for n_filter in (8448, N_DOCS):
        for th in (0.3125, -1.0):
            want = rref.prefilter(cs, th, ref.codes, mask, bitmap, n_filter)
            got = tops.prefilter(_t(cs), th, tcodes, tlens, _t(bitmap),
                                 n_filter)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sel1 = np.asarray(want[1][:8448])
    cs_t = cs.T
    codes, res = jnp.take(ref.codes, sel1, 0), jnp.take(ref.res_codes, sel1, 0)
    smask = jnp.take(mask, sel1, 0)
    want = rref.pqinter(cs_t, lut, codes, res, smask, FIG9["th_r"], 4352,
                        4200)
    got = tops.pqinter(_t(cs_t), _t(lut), _t(codes), _t(res), _t(smask),
                       FIG9["th_r"], 4352, 4200)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w)

