"""Filtered and compact retrieval: the port against the reference
(``repro.core.engine.retrieve``, Pallas interpret mode) under lossy budgets,
on the same index bytes, with the reference's CS and LUT injected into the
port (``_retrieve_batch(..., cs=, lut=)``), so phases 1b-4 are held to the
bit whatever the two frameworks' matmuls do: doc ids and float32 score bits.

Every lane — reference math, unfused kernels, fused megakernels — in both
candidate modes, at B = 1 and B = 3, with a padded term mask on some cases:
a filter passing about a sixth of the docs, and one passing fewer than k of
each query's survivors, so every lane returns its own fillers (the fused
lane's ``(-inf, sel1[0])``, the unfused lanes' lowest failing positions);
compact mode with ``cand_cap`` below the candidate count and at the whole
corpus; ``compact_cap`` on the reference math. Unfused and fused agree on
every finite-scored entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import engine as reng
from repro.core.pq import build_lut as ref_build_lut
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from test_torch_filter import MODES, N_Q, build_filter_index

torch.set_num_threads(1)

LOSSY = dict(n_q=N_Q, nprobe=2, th=0.2, th_r=0.3, n_filter=24, n_docs=12,
             k=8)
FILTERS = {"none": None,
           "sixth": lambda m: m.Pred("recent") & ~m.Pred("lang_en"),
           "rare": lambda m: m.Pred("rare")}
# mode, filter, B, padded, cand_cap
CASES = {
    "ref-score_all-sixth-b3-pad": ("ref-score_all", "sixth", 3, 1, None),
    "ref-score_all-rare-b1": ("ref-score_all", "rare", 1, 0, None),
    "ref-compact48-rare-b3": ("ref-compact", "rare", 3, 0, 48),
    "ref-compact96-sixth-b1-pad": ("ref-compact", "sixth", 1, 1, 96),
    "unfused-score_all-rare-b3-pad": ("unfused-score_all", "rare", 3, 1,
                                      None),
    "unfused-score_all-sixth-b1": ("unfused-score_all", "sixth", 1, 0, None),
    "unfused-compact48-sixth-b3": ("unfused-compact", "sixth", 3, 0, 48),
    "unfused-compact48-none-b3-pad": ("unfused-compact", "none", 3, 1, 48),
    "unfused-compact96-rare-b1": ("unfused-compact", "rare", 1, 0, 96),
    "fused-score_all-sixth-b3": ("fused-score_all", "sixth", 3, 0, None),
    "fused-score_all-rare-b1-pad": ("fused-score_all", "rare", 1, 1, None),
    "fused-score_all-rare-b3": ("fused-score_all", "rare", 3, 0, None),
    "fused-compact48-rare-b3-pad": ("fused-compact", "rare", 3, 1, 48),
    "fused-compact48-none-b1": ("fused-compact", "none", 1, 0, 48),
    "fused-compact96-sixth-b3": ("fused-compact", "sixth", 3, 0, 96),
    "fused-compact96-rare-b1": ("fused-compact", "rare", 1, 0, 96),
}


@pytest.fixture(scope="module")
def findex(tmp_path_factory):
    return build_filter_index(tmp_path_factory.mktemp("filter") / "idx")


@jax.jit
def _ref_cs_lut(index, q):
    cs = jax.vmap(lambda x: reng.centroid_scores(x, index.centroids))(q)
    q_rot = jax.vmap(lambda x: x @ index.opq_rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, index.pq))(q_rot)
    return cs, lut


def _queries(queries, nb, padded):
    q = np.array(queries[:nb])
    if not padded:
        return q, None
    qm = np.ones((nb, N_Q), bool)
    qm[:, -3:] = False
    q[~qm] = 0.0
    return q, qm


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _run_both(findex, mode, filt, nb, padded, cand_cap, **over):
    """(reference result, port result, the port's config, CS, LUT, q, qm,
    the port's plan)."""
    ref, meta, port, queries, _ = findex
    q, qm = _queries(queries, nb, padded)
    kw = {**LOSSY, **MODES[mode], **over}
    if cand_cap is not None:
        kw["cand_cap"] = cand_cap
    rplan = tplan = None
    if FILTERS[filt] is not None:
        rplan = rbv.compile_filter(FILTERS[filt](rbv), meta.pred_names)
        tplan = tbv.compile_filter(FILTERS[filt](tbv), meta.pred_names)
    want = reng.retrieve(ref, jnp.asarray(q), reng.EngineConfig(**kw),
                         None if qm is None else jnp.asarray(qm),
                         doc_filter=rplan)
    cs, lut = _ref_cs_lut(ref, jnp.asarray(q))
    cfg = teng.EngineConfig(**kw, doc_filter=tplan)
    got = teng._retrieve_batch(port, _t(q), cfg, _t(qm), cs=_t(cs),
                               lut=_t(lut))
    return want, got, cfg, _t(cs), _t(lut), _t(q), _t(qm), tplan


def _same(got, want):
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.scores.numpy().view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(findex, case):
    mode, filt, nb, padded, cand_cap = CASES[case]
    want, got, cfg, *_ = _run_both(findex, mode, filt, nb, bool(padded),
                                   cand_cap)
    _same(got, want)
    if filt == "rare":          # fewer than k pass: each lane's fillers
        assert torch.isneginf(got.scores[:, -1]).all()
    if cand_cap == 48:          # the buffer is smaller than the candidates
        port = findex[2]
        cs = teng.centroid_scores(torch.from_numpy(findex[3][:nb]),
                                  port.centroids)
        assert (teng._candidates(port, cs, cfg).sum(1) > cand_cap).all()


@pytest.mark.parametrize("filt", ["none", "sixth"])
def test_compact_cap_on_reference_math(findex, filt):
    """compact_cap compacts tokens on the reference math (and is ignored by
    the kernels, as in the reference)."""
    want, got, cfg, cs, lut, q, qm, _ = _run_both(
        findex, "ref-score_all", filt, 3, True, None, compact_cap=5)
    _same(got, want)
    plain = teng._retrieve_batch(findex[2], q, dataclasses.replace(
        cfg, compact_cap=None), qm, cs=cs, lut=lut)
    assert not torch.equal(plain.scores, got.scores)
    kern = dataclasses.replace(cfg, use_kernels=True)
    a = teng._retrieve_batch(findex[2], q, kern, qm, cs=cs, lut=lut)
    b = teng._retrieve_batch(findex[2], q, dataclasses.replace(
        kern, compact_cap=None), qm, cs=cs, lut=lut)
    assert torch.equal(a.doc_ids, b.doc_ids)
    assert torch.equal(a.scores, b.scores)


@pytest.mark.parametrize("mode", ["score_all", "compact"])
@pytest.mark.parametrize("filt", ["sixth", "rare"])
def test_unfused_equals_fused_where_finite(findex, mode, filt):
    """The lanes differ only in their fillers: the fused lane ends a short
    cut in (-inf, sel1[0]), the unfused lanes in the lowest failing
    positions. Every finite-scored entry agrees, and passes the filter."""
    _, meta, port, queries, _ = findex
    want, fused, cfg, cs, lut, q, qm, plan = _run_both(
        findex, f"fused-{mode}", filt, 3, True, 48)
    passing = tbv.apply_filter_plan(plan, port.pred_words)
    for lane in ("unfused-score_all", "ref-score_all"):
        flags = {k: v for k, v in MODES[lane].items()
                 if k != "candidate_mode"}
        ucfg = dataclasses.replace(
            cfg, **{"use_kernels": False, "fused_prefilter": True,
                    "fused_late_interaction": True, **flags})
        got = teng._retrieve_batch(port, q, ucfg, qm, cs=cs, lut=lut)
        finite = torch.isfinite(fused.scores)
        assert torch.equal(finite, torch.isfinite(got.scores))
        assert torch.equal(got.doc_ids[finite], fused.doc_ids[finite])
        assert torch.equal(got.scores[finite].view(torch.int32),
                           fused.scores[finite].view(torch.int32))
        assert passing[fused.doc_ids[finite].long()].all()
    if filt == "rare":
        assert not finite.all()


def test_reference_sigmoid_matches_xla():
    """compact_cap ranks tokens by ``jax.nn.sigmoid``: the port's
    ``reference_sigmoid`` gives XLA's bits on a million inputs, subnormal
    results and saturation included, where ``torch.sigmoid`` does not."""
    from repro_torch.core.interaction import reference_sigmoid
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-3, 3, 600_000),
                        rng.normal(size=300_000) * 10,
                        rng.uniform(-120, 120, 100_000),
                        [0.0, -1e9, 1e9, -87.9, 88.5]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.sigmoid)(jnp.asarray(x)))
    got = reference_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = torch.sigmoid(torch.from_numpy(x)).numpy()
    assert (plain.view(np.uint32) != want.view(np.uint32)).any()


@pytest.mark.parametrize("mode", ["score_all", "compact"])
def test_entry_points_take_doc_filter(findex, mode):
    """Every phase entry point takes ``doc_filter=``: the single-phase ones
    on the reference's own intermediates equal the reference's output by
    output, and the fused pair composes to filtered ``retrieve``."""
    ref, meta, port, queries, _ = findex
    kw = {**LOSSY, **MODES["unfused-" + mode], "cand_cap": 48}
    rcfg, tcfg = reng.EngineConfig(**kw), teng.EngineConfig(**kw)
    rplan = rbv.compile_filter(FILTERS["sixth"](rbv), meta.pred_names)
    tplan = tbv.compile_filter(FILTERS["sixth"](tbv), meta.pred_names)
    q = np.array(queries[:3])
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    tkw = dict(doc_filter=tplan, device="cpu")
    r_cs, r_bits, r_bitmap = reng.phase1_candidates(ref, jq, rcfg,
                                                    doc_filter=rplan)
    _, _, t_bitmap = teng.phase1_candidates(port, tq, tcfg, **tkw)
    np.testing.assert_array_equal(t_bitmap.numpy(), np.asarray(r_bitmap))
    r_sel1 = reng.phase2_prefilter(ref, jq, rcfg, bits=r_bits,
                                   bitmap=r_bitmap, doc_filter=rplan)
    t_sel1 = teng.phase2_prefilter(
        port, tq, tcfg, bits=_t(np.asarray(r_bits).view(np.int32)),
        bitmap=_t(r_bitmap), **tkw)
    np.testing.assert_array_equal(t_sel1.numpy(), np.asarray(r_sel1))
    r_sel2 = reng.phase3_centroid_interaction(ref, jq, rcfg, cs=r_cs,
                                              sel1=r_sel1, doc_filter=rplan)
    t_sel2 = teng.phase3_centroid_interaction(port, tq, tcfg, cs=_t(r_cs),
                                              sel1=_t(r_sel1), **tkw)
    np.testing.assert_array_equal(t_sel2.numpy(), np.asarray(r_sel2))
    _same(teng.phase4_late_interaction(port, tq, tcfg, cs=_t(r_cs),
                                       sel2=_t(r_sel2), **tkw),
          reng.phase4_late_interaction(ref, jq, rcfg, cs=r_cs, sel2=r_sel2,
                                       doc_filter=rplan))
    fcfg = teng.EngineConfig(**{**kw, **MODES["fused-" + mode]})
    cs, sel1 = teng.phase12_prefilter(port, tq, fcfg, **tkw)
    got = teng.phase34_late_interaction(port, tq, fcfg, cs=cs, sel1=sel1,
                                        **tkw)
    want = teng.retrieve(port, tq, fcfg, doc_filter=tplan, device="cpu")
    assert torch.equal(got.doc_ids, want.doc_ids)
    assert torch.equal(got.scores.view(torch.int32),
                       want.scores.view(torch.int32))
