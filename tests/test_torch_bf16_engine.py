"""bf16 centroid scores (``cs_dtype="bfloat16"``, paper §6) through the
port's engine against ``repro.core.engine`` (Pallas interpret mode), lane
by lane: the fused megakernels, the unfused kernels (each half and both),
and the reference math with and without ``compact_cap``, at B = 1 and 3,
with a padded term mask, ``th_r`` set and None, ``doc_filter``, compact
candidate mode, and every phase entry point.

The reference's bf16 CS and float32 LUT are injected into the port
(``_retrieve_batch(..., cs=, lut=)``; at these shapes the two frameworks'
bf16 CS agree to the bit anyway, which the first test holds). Each kernel
lane and the compact_cap math then equal the reference's same lane: doc ids
and float32 score bits. The reference math without compact_cap scores with
an exact float32 centroid term, an einsum whose bits differ between the
frameworks, so its final scores are held at rtol 1e-5
(tests/test_engine_phases.py:80) and its ids equal except where the
reference's neighbouring scores lie within that tolerance (counted).

The lanes do not equal each other under bf16, in the reference either:
the unfused bitpack compares in float32 where the fused prefilter and the
reference math compare in bf16, and only the reference math adds the exact
centroid term. The reference's cinter kernel does not run on bf16 CS under
jax 0.9.0 (it stores bf16 into a float32 output), so its plain reference,
the kernel's body (``test_torch_bf16_kernels.cinter_body``), stands in for
it in the reference's unfused lane.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import engine as reng
from repro.core import interaction as rint
from repro.core.pq import build_lut as ref_build_lut
from repro.kernels import ops as rops
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from repro_torch.core import interaction as tint
from repro_torch.core.index import index_from_arrays
from repro_torch.core.precision import greater
from test_torch_bf16_kernels import cinter_body
from test_torch_filter import MODES, N_Q, build_filter_index
from test_torch_filter_engine import FILTERS, LOSSY

torch.set_num_threads(1)

KW = dict(n_q=32, nprobe=4, th=0.3, th_r=0.4, n_filter=64, n_docs=16, k=10,
          cs_dtype="bfloat16")
LANES = {
    "fused": dict(use_kernels=True),
    "unfused": dict(use_kernels=True, fused_prefilter=False,
                    fused_late_interaction=False),
    "unfused_prefilter": dict(use_kernels=True, fused_prefilter=False),
    "unfused_late": dict(use_kernels=True, fused_late_interaction=False),
    "math": {},
    "math_compact_cap": dict(compact_cap=6),
}
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reference_cinter(monkeypatch):
    monkeypatch.setattr(rops, "cinter", cinter_body)


@pytest.fixture(scope="module")
def port_index(small_index):
    ref, _ = small_index
    return index_from_arrays(
        {f: np.asarray(getattr(ref, f)) for f in ref._fields}, device="cpu")


@pytest.fixture(scope="module")
def findex(tmp_path_factory):
    return build_filter_index(tmp_path_factory.mktemp("bf16_filter") / "idx")


@jax.jit
def _ref_cs_lut(index, q):
    """bf16 CS and the LUT as the reference's batched pipeline builds
    them."""
    cs = jax.vmap(lambda x: reng.centroid_scores(x, index.centroids,
                                                 "bfloat16"))(q)
    q_rot = jax.vmap(lambda x: x @ index.opq_rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, index.pq))(q_rot)
    return cs, lut


def _t(x):
    """A reference array (bf16 included) or numpy array as a tensor."""
    if x is None:
        return None
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _queries(queries, rows, pad):
    q = np.array(queries[rows], np.float32)
    if not pad:
        return q, None
    qm = np.ones(q.shape[:2], bool)
    qm[:, -pad:] = False
    q[~qm] = 0.0
    return q, qm


def _same(got, want):
    assert got.doc_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.scores.numpy().view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32))


def _close(got, want) -> int:
    """The math lane's final scores at RTOL and its ids equal, except where
    the reference's neighbouring scores lie within RTOL (a near tie the two
    frameworks' einsums may order either way). -> how many ids differ."""
    ws = np.asarray(want.scores)
    gs = got.scores.numpy()
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=0)
    wi, gi = np.asarray(want.doc_ids), got.doc_ids.numpy()
    k = ws.shape[1]
    for b, j in zip(*np.nonzero(gi != wi)):
        near = [ws[b, i] for i in (j - 1, j + 1) if 0 <= i < k]
        tied = any(abs(v - ws[b, j]) <= RTOL * abs(ws[b, j]) for v in near)
        assert tied or j == k - 1, (b, j, ws[b])
    return int((gi != wi).sum())


def _check(lane, got, want, case):
    """Kernel lanes and compact_cap: equal. The math lane: close, its near
    ties reported (``pytest -s`` shows them)."""
    if lane != "math":
        _same(got, want)
    elif n := _close(got, want):
        print(f"{case}: {n} ids placed otherwise at near ties")


CASES = {
    "b3": (slice(0, 3), 0, {}),
    "b3_padded_mask": (slice(4, 7), 9, {}),
    "b3_eq5": (slice(8, 11), 0, {"th_r": None}),
    "b1": (slice(12, 13), 0, {}),
    "b1_padded_mask_eq5": (slice(13, 14), 5, {"th_r": None}),
}


def test_bf16_cs_and_lut_bits_match_reference(small_corpus, small_index,
                                              port_index):
    q = np.array(small_corpus.queries[:8], np.float32)
    ref_cs, ref_lut = _ref_cs_lut(small_index[0], jnp.asarray(q))
    tq = torch.from_numpy(q)
    cs = teng.centroid_scores(tq, port_index.centroids, "bfloat16")
    assert cs.dtype == torch.bfloat16
    np.testing.assert_array_equal(cs.view(torch.int16).numpy(),
                                  np.asarray(ref_cs).view(np.int16))
    np.testing.assert_array_equal(
        teng._query_lut(port_index, tq).numpy().view(np.uint32),
        np.asarray(ref_lut).view(np.uint32))


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_lane_matches_reference(small_corpus, small_index, port_index, lane,
                                case):
    rows, pad, over = CASES[case]
    if "compact_cap" in LANES[lane] and over.get("th_r", 0) is None:
        over = {**over, "th_r": KW["th_r"]}       # compact_cap needs th_r
    q, qm = _queries(small_corpus.queries, rows, pad)
    kw = {**KW, **over, **LANES[lane]}
    want = reng.retrieve(small_index[0], jnp.asarray(q),
                         reng.EngineConfig(**kw), _j(qm))
    cs, lut = _ref_cs_lut(small_index[0], jnp.asarray(q))
    got = teng._retrieve_batch(port_index, _t(q), teng.EngineConfig(**kw),
                               _t(qm), cs=_t(cs), lut=_t(lut))
    _check(lane, got, want, f"{lane}-{case}")
    # the port's own bf16 CS gives the same result at these shapes
    alone = teng.retrieve(port_index, _t(q), teng.EngineConfig(**kw), _t(qm),
                          device="cpu")
    assert torch.equal(alone.doc_ids, got.doc_ids)
    assert torch.equal(alone.scores.view(torch.int32),
                       got.scores.view(torch.int32))


FILTER_CASES = {
    "ref-score_all-sixth-b3-pad": ("ref-score_all", "sixth", 3, 1, None),
    "ref-compact48-rare-b1": ("ref-compact", "rare", 1, 0, 48),
    "unfused-score_all-rare-b3-pad": ("unfused-score_all", "rare", 3, 1,
                                      None),
    "unfused-compact48-sixth-b3": ("unfused-compact", "sixth", 3, 0, 48),
    "unfused-compact96-none-b1-pad": ("unfused-compact", "none", 1, 1, 96),
    "fused-score_all-sixth-b3": ("fused-score_all", "sixth", 3, 0, None),
    "fused-score_all-rare-b1-pad": ("fused-score_all", "rare", 1, 1, None),
    "fused-compact48-rare-b3-pad": ("fused-compact", "rare", 3, 1, 48),
    "fused-compact96-sixth-b1": ("fused-compact", "sixth", 1, 0, 96),
}


def _run_filtered(findex, mode, filt, nb, padded, cand_cap, **over):
    ref, meta, port, queries, _ = findex
    q, qm = _queries(queries, slice(0, nb), 3 if padded else 0)
    kw = {**LOSSY, **MODES[mode], "cs_dtype": "bfloat16", **over}
    if cand_cap is not None:
        kw["cand_cap"] = cand_cap
    rplan = tplan = None
    if FILTERS[filt] is not None:
        rplan = rbv.compile_filter(FILTERS[filt](rbv), meta.pred_names)
        tplan = tbv.compile_filter(FILTERS[filt](tbv), meta.pred_names)
    want = reng.retrieve(ref, jnp.asarray(q), reng.EngineConfig(**kw),
                         _j(qm), doc_filter=rplan)
    cs, lut = _ref_cs_lut(ref, jnp.asarray(q))
    got = teng._retrieve_batch(port, _t(q), teng.EngineConfig(
        **kw, doc_filter=tplan), _t(qm), cs=_t(cs), lut=_t(lut))
    return want, got, tplan


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filtered_and_compact_lanes_match_reference(findex, case):
    mode, filt, nb, padded, cand_cap = FILTER_CASES[case]
    want, got, plan = _run_filtered(findex, mode, filt, nb, padded, cand_cap)
    _check("math" if mode.startswith("ref") else "kernel", got, want, case)
    if plan is not None:
        finite = torch.isfinite(got.scores)
        passing = tbv.apply_filter_plan(plan, findex[2].pred_words)
        assert passing[got.doc_ids[finite].long()].all()


@pytest.mark.parametrize("filt", ["none", "sixth"])
def test_compact_cap_bf16_matches_reference(findex, filt):
    """compact_cap on bf16 CS: bf16 keymax, ranked by 2 * keep + the bf16
    logistic; bit for bit."""
    want, got, _ = _run_filtered(findex, "ref-score_all", filt, 3, True,
                                 None, compact_cap=5)
    _same(got, want)


def _boundary_th(cs) -> float:
    """A threshold just below a bf16 value v that the CS holds, so that
    bf16(th) = v while float32(th) < v: an entry equal to v fails a bf16
    comparison and passes a float32 one."""
    vals = np.asarray(cs).astype(np.float32).ravel()
    v = float(vals[np.argmin(np.abs(vals - 0.3))])
    th = v * (1 - 2.0 ** -10)
    assert float(torch.tensor(th).to(torch.bfloat16)) == v
    return th


@pytest.mark.parametrize("th_kind", ["python", "np_float32"])
@pytest.mark.parametrize("lane", ["fused", "unfused", "math_compact_cap"])
def test_threshold_type_follows_reference(small_corpus, small_index,
                                          port_index, lane, th_kind):
    """th given as a Python float compares in bf16 where the reference does
    (prefilter, build_bitvectors, the masked top-nprobe), as a numpy
    float32 in float32 where the reference's promotion gives float32; the
    unfused bitpack compares in float32 either way. On a threshold whose
    bf16 and float32 roundings bracket a CS value each lane still equals
    the reference's same lane."""
    q, qm = _queries(small_corpus.queries, slice(0, 3), 4)
    cs, lut = _ref_cs_lut(small_index[0], jnp.asarray(q))
    th = _boundary_th(cs)
    th = np.float32(th) if th_kind == "np_float32" else th
    kw = {**KW, **LANES[lane], "th": th}
    # jax's jit cache finds a config with np.float32(th) equal to one with
    # the Python float th (numpy compares them in float32) and would reuse
    # the other's trace, whichever ran first: trace this one afresh
    jax.clear_caches()
    want = reng.retrieve(small_index[0], jnp.asarray(q),
                         reng.EngineConfig(**kw), _j(qm))
    got = teng._retrieve_batch(port_index, _t(q), teng.EngineConfig(**kw),
                               _t(qm), cs=_t(cs), lut=_t(lut))
    _same(got, want)
    # the boundary entries pack differently in the two comparison dtypes
    words_bf16 = tbv.build_bitvectors(_t(cs), float(th))
    words_f32 = tbv.build_bitvectors(_t(cs), np.float32(th))
    assert not torch.equal(words_bf16, words_f32)
    rw = rbv.build_bitvectors(cs, th)
    np.testing.assert_array_equal(
        tbv.build_bitvectors(_t(cs), th).numpy().view(np.uint32),
        np.asarray(rw))
    np.testing.assert_array_equal(
        tbv.masked_topk_centroids(_t(cs), th, 4, _t(qm)).numpy(),
        np.asarray(rbv.masked_topk_centroids(cs, th, 4, _j(qm))))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_phases_compose_to_retrieve(small_corpus, port_index, lane):
    """phase1 + phase2 + phase3 + phase4 and phase12 + phase34 compose to
    retrieve under bf16, the handed-back CS staying bf16."""
    q, qm = (_t(x) for x in _queries(small_corpus.queries, slice(2, 5), 3))
    cfg = teng.EngineConfig(**KW, **LANES[lane])
    kw = dict(q_mask=qm, device="cpu")
    want = teng.retrieve(port_index, q, cfg, qm, device="cpu")
    cs, bits, bitmap = teng.phase1_candidates(port_index, q, cfg, **kw)
    assert cs.dtype == torch.bfloat16
    sel1 = teng.phase2_prefilter(port_index, q, cfg, bits=bits,
                                 bitmap=bitmap, **kw)
    sel2 = teng.phase3_centroid_interaction(port_index, q, cfg, cs=cs,
                                            sel1=sel1, **kw)
    split = teng.phase4_late_interaction(port_index, q, cfg, cs=cs,
                                         sel2=sel2, **kw)
    cs12, sel1_12 = teng.phase12_prefilter(port_index, q, cfg, **kw)
    assert cs12.dtype == torch.bfloat16
    fused = teng.phase34_late_interaction(port_index, q, cfg, cs=cs12,
                                          sel1=sel1_12, **kw)
    for got in ([fused, split] if not cfg.use_kernels
                or not cfg.fused_prefilter else [fused]):
        assert torch.equal(got.doc_ids, want.doc_ids)
        assert torch.equal(got.scores.view(torch.int32),
                           want.scores.view(torch.int32))
    if cfg.use_kernels and cfg.fused_prefilter:
        # the single-phase entry points run the unfused kernels, as the
        # reference's do; they compose to the unfused lane's retrieve
        ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                                   fused_late_interaction=False)
        unfused = teng.retrieve(port_index, q, ucfg, qm, device="cpu")
        assert torch.equal(split.doc_ids, unfused.doc_ids)


@pytest.mark.parametrize("lane", ["unfused", "math"])
@pytest.mark.parametrize("pad", [0, 6])
def test_single_phase_entry_points_match_reference(small_corpus, small_index,
                                                   port_index, lane, pad):
    """Each entry point on the reference's own bf16 intermediates, output
    by output."""
    ref_index, _ = small_index
    q, qm = _queries(small_corpus.queries, slice(0, 3), pad)
    kw = {**KW, **LANES[lane]}
    rcfg, tcfg = reng.EngineConfig(**kw), teng.EngineConfig(**kw)
    jq, tq = jnp.asarray(q), _t(q)
    tkw = dict(q_mask=_t(qm), device="cpu")

    r_cs, r_bits, r_bitmap = reng.phase1_candidates(ref_index, jq, rcfg,
                                                    q_mask=_j(qm))
    t_cs, t_bits, t_bitmap = teng.phase1_candidates(port_index, tq, tcfg,
                                                    **tkw)
    assert t_cs.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_cs.view(torch.int16).numpy(),
                                  np.asarray(r_cs).view(np.int16))
    np.testing.assert_array_equal(t_bits.numpy().view(np.uint32),
                                  np.asarray(r_bits))
    np.testing.assert_array_equal(t_bitmap.numpy(), np.asarray(r_bitmap))
    r_sel1 = reng.phase2_prefilter(ref_index, jq, rcfg, bits=r_bits,
                                   bitmap=r_bitmap)
    t_sel1 = teng.phase2_prefilter(
        port_index, tq, tcfg, bits=_t(np.asarray(r_bits).view(np.int32)),
        bitmap=_t(r_bitmap), **tkw)
    np.testing.assert_array_equal(t_sel1.numpy(), np.asarray(r_sel1))
    r_sel2 = reng.phase3_centroid_interaction(
        ref_index, jq, rcfg, q_mask=_j(qm), cs=r_cs, sel1=r_sel1)
    t_sel2 = teng.phase3_centroid_interaction(
        port_index, tq, tcfg, cs=_t(r_cs), sel1=_t(r_sel1), **tkw)
    np.testing.assert_array_equal(t_sel2.numpy(), np.asarray(r_sel2))
    want = reng.phase4_late_interaction(ref_index, jq, rcfg, q_mask=_j(qm),
                                        cs=r_cs, sel2=r_sel2)
    got = teng.phase4_late_interaction(port_index, tq, tcfg, cs=_t(r_cs),
                                       sel2=_t(r_sel2), **tkw)
    _check(lane, got, want, f"entry-{lane}-{pad}")
    want34 = reng.phase34_late_interaction(ref_index, jq, rcfg,
                                           q_mask=_j(qm), cs=r_cs,
                                           sel1=r_sel1)
    got34 = teng.phase34_late_interaction(port_index, tq, tcfg, cs=_t(r_cs),
                                          sel1=_t(r_sel1), **tkw)
    _check(lane, got34, want34, f"entry34-{lane}-{pad}")


# ---------------------------------------------------------------------------
# The reference math on bf16 CS, function by function
# ---------------------------------------------------------------------------

def _interaction_inputs(seed, n_c=90, docs=12, cap=10, m=8, ksub=16):
    rng = np.random.default_rng(seed)
    cs_t = np.round(rng.normal(size=(n_c, 32)) * 4) / 8 + 0.0
    cs_t = cs_t.astype(np.float32)
    cs_t[rng.random(cs_t.shape) < 0.15] = 0.400390625  # bf16(th_r = 0.4)
    lut = (np.round(rng.normal(size=(32, m, ksub)) * 4) / 16).astype(
        np.float32)
    codes = rng.integers(0, n_c, size=(docs, cap)).astype(np.int32)
    lens = rng.integers(0, cap + 1, size=docs)
    mask = np.arange(cap) < lens[:, None]
    codes[~mask] = n_c
    res = rng.integers(0, ksub, size=(docs, cap, m)).astype(np.uint8)
    qm = rng.random(32) < 0.75
    qm[0] = True
    return cs_t, lut, codes, res, mask, qm


def _bf(x):
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


def _bits_eq(port, ref):
    a, r = port.detach(), np.asarray(ref)
    if a.dtype == torch.bfloat16:
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      r.view(np.int16))
    else:
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      r.view(np.uint32))


@pytest.mark.parametrize("masked", [False, True])
def test_centroid_interaction_bf16(masked):
    """bf16 S̄: bf16 maxima with the bf16 -1e9 floor, term_sum widened,
    chained and rounded once."""
    cs_t, _, codes, _, mask, qm = _interaction_inputs(1)
    jc, tc = _bf(cs_t)
    ref = rint.centroid_interaction(jc, jnp.asarray(codes), jnp.asarray(mask),
                                    jnp.asarray(qm) if masked else None)
    port = tint.centroid_interaction(tc, torch.from_numpy(codes),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(qm) if masked else None)
    assert port.dtype == torch.bfloat16
    _bits_eq(port, ref)


def test_term_sum_bf16_rounds_once():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(1000, 32)) * 3).astype(np.float32)
    jx, tx = _bf(x)
    _bits_eq(tint.term_sum(tx), rint.term_sum(jx))
    chained = tx[:, 0]
    for i in range(1, 32):
        chained = chained + tx[:, i]          # a rounding after each add
    assert not torch.equal(chained, tint.term_sum(tx))


@pytest.mark.parametrize("th_r", [None, 0.4, np.float32(0.4)])
@pytest.mark.parametrize("masked", [False, True])
def test_late_interaction_pq_bf16(th_r, masked):
    """Eq. 5/6 on bf16 cs_t (the widened centroid score plus the float32
    residual), and with the same float32 centroid= term given to both."""
    cs_t, lut, codes, res, mask, qm = _interaction_inputs(3)
    jc, tc = _bf(cs_t)
    args_j = (jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(res),
              jnp.asarray(mask))
    args_t = (torch.from_numpy(lut), torch.from_numpy(codes),
              torch.from_numpy(res), torch.from_numpy(mask))
    jqm = jnp.asarray(qm) if masked else None
    tqm = torch.from_numpy(qm) if masked else None
    _bits_eq(tint.late_interaction_pq(tc, *args_t, th_r, q_mask=tqm),
             rint.late_interaction_pq(jc, *args_j, th_r, q_mask=jqm))
    rng = np.random.default_rng(4)
    cent = (np.round(rng.normal(size=(*codes.shape, 32)) * 8) / 20
            ).astype(np.float32)
    cent[rng.random(cent.shape) < 0.1] = np.float32(0.4)
    _bits_eq(tint.late_interaction_pq(tc, *args_t, th_r,
                                      centroid=torch.from_numpy(cent),
                                      q_mask=tqm),
             rint.late_interaction_pq(jc, *args_j, th_r,
                                      centroid=jnp.asarray(cent),
                                      q_mask=jqm))


@pytest.mark.parametrize("masked", [False, True])
def test_late_interaction_pq_compact_bf16(masked):
    """Held against the reference jitted, as its engine runs it: there XLA
    fuses the bf16 logistic into the float32 rank and drops its last
    rounding."""
    cs_t, lut, codes, res, mask, qm = _interaction_inputs(5)
    jc, tc = _bf(cs_t)
    ref = jax.jit(rint.late_interaction_pq_compact, static_argnums=(5, 6))(
        jc, jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(res),
        jnp.asarray(mask), 0.4, 4, q_mask=jnp.asarray(qm) if masked else None)
    port = tint.late_interaction_pq_compact(
        tc, torch.from_numpy(lut), torch.from_numpy(codes),
        torch.from_numpy(res), torch.from_numpy(mask), 0.4, 4,
        torch.from_numpy(qm) if masked else None)
    _bits_eq(port, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_scored_term_fraction_bf16(masked):
    cs_t, _, codes, _, mask, qm = _interaction_inputs(6)
    jc, tc = _bf(cs_t)
    ref = rint.scored_term_fraction(jc, jnp.asarray(codes), jnp.asarray(mask),
                                    0.4, jnp.asarray(qm) if masked else None)
    port = tint.scored_term_fraction(tc, torch.from_numpy(codes),
                                     torch.from_numpy(mask), 0.4,
                                     torch.from_numpy(qm) if masked else None)
    _bits_eq(port, ref)


def test_reference_sigmoid_bf16_every_finite_value():
    """compact_cap ranks bf16 keymax by the bf16 ``jax.nn.sigmoid``, which
    XLA computes op by op in float32 rounding each step to bf16; the port's
    bf16 form gives its bits on every finite bf16 value, where rounding the
    float32 logistic once does not."""
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = every.view(torch.bfloat16)
    x = x[torch.isfinite(x.float())]
    want = np.asarray(jax.jit(jax.nn.sigmoid)(
        jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)))
    got = tint.reference_sigmoid(x).to(torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    once = tint.reference_sigmoid(x.float()).to(torch.bfloat16)
    assert (once.view(torch.int16).numpy() != want.view(np.int16)).any()


def test_reference_sigmoid_bf16_in_a_float32_sum():
    """Where the bf16 logistic feeds a float32 sum in a jitted function, as
    in the rank of late_interaction_pq_compact, XLA keeps its last step in
    float32: reference_sigmoid gives those bits on every finite bf16
    value."""
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = every.view(torch.bfloat16)
    x = x[torch.isfinite(x.float())]
    jx = jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
    want = np.asarray(jax.jit(
        lambda k: (k > 0.4).astype(jnp.float32) * 2.0 + jax.nn.sigmoid(k))(
            jx))
    keep = greater(x, 0.4).float()
    got = keep * 2.0 + tint.reference_sigmoid(x)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
