"""The port's engine as a whole: ``retrieve`` against the reference's
``repro.core.engine.retrieve`` (``use_kernels=True``, Pallas interpret mode)
on the same index bytes and the same queries, at B = 4 and B = 1, with a
padded query-term mask and with ``th_r`` both set and None — on the fused
lane (the default) and on the unfused one (``fused_prefilter=False`` and/or
``fused_late_interaction=False``: bitpack + bitfilter, cinter + pqscore).

Each fused case first holds the CS and LUT bits (the two framework matmuls;
0 mismatches at these shapes), so a failure names the layer, then the final
doc ids and float32 score bits. Injecting the reference's CS and LUT through
the ``cs=``/``lut=`` overrides holds phases 1b-4 exactly whatever the
matmuls do. The four single-phase entry points are held output by output on
the reference's own intermediates, and every lane composes to ``retrieve``
and equals every other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core.pq import build_lut as ref_build_lut
from repro_torch.core import engine as teng
from repro_torch.core.index import index_from_arrays
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

KW = dict(n_q=32, nprobe=4, th=0.3, th_r=0.4, n_filter=64, n_docs=16, k=10)


@pytest.fixture(scope="module")
def port_index(small_index):
    ref, _ = small_index
    return index_from_arrays(
        {f: np.asarray(getattr(ref, f)) for f in ref._fields}, device="cpu")


@jax.jit
def _ref_cs_lut(index, q):
    """CS and LUT as the reference's batched pipeline builds them."""
    cs = jax.vmap(lambda x: reng.centroid_scores(x, index.centroids))(q)
    q_rot = jax.vmap(lambda x: x @ index.opq_rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, index.pq))(q_rot)
    return cs, lut


def _queries(small_corpus, rows, pad):
    q = np.array(small_corpus.queries[rows], np.float32)
    if not pad:
        return q, None
    qm = np.ones(q.shape[:2], bool)
    qm[:, -pad:] = False
    q[~qm] = 0.0
    return q, qm


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


CASES = {
    "b4": (slice(0, 4), 0, {}),
    "b4_padded_mask": (slice(4, 8), 9, {}),
    "b4_eq5": (slice(8, 12), 0, {"th_r": None}),
    "b1": (slice(12, 13), 0, {}),
    "b1_padded_mask_eq5": (slice(13, 14), 5, {"th_r": None}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_retrieve_matches_reference(small_corpus, small_index, port_index,
                                    case):
    rows, pad, over = CASES[case]
    ref_index, _ = small_index
    q, qm = _queries(small_corpus, rows, pad)
    kw = {**KW, **over}

    ref_cs, ref_lut = _ref_cs_lut(ref_index, jnp.asarray(q))
    tq = torch.from_numpy(q)
    port_cs = teng.centroid_scores(tq, port_index.centroids)
    port_lut = teng._query_lut(port_index, tq)
    np.testing.assert_array_equal(_bits(port_cs), _bits(ref_cs))
    np.testing.assert_array_equal(_bits(port_lut), _bits(ref_lut))

    want = reng.retrieve(ref_index, jnp.asarray(q),
                         reng.EngineConfig(**kw, use_kernels=True),
                         None if qm is None else jnp.asarray(qm))
    tops.reset_launches()
    got = teng.retrieve(port_index, tq, teng.EngineConfig(
        **kw, use_kernels=True), None if qm is None else torch.from_numpy(qm),
        device="cpu")
    assert set(tops.launch_counts().values()) == {0}   # no CPU launch
    assert got.doc_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(
        want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))


def test_injected_cs_and_lut_hold_phases_1b_to_4(small_corpus, small_index,
                                                 port_index):
    ref_index, _ = small_index
    q, qm = _queries(small_corpus, slice(14, 18), 4)
    cfg = reng.EngineConfig(**KW, use_kernels=True)
    ref_cs, ref_lut = _ref_cs_lut(ref_index, jnp.asarray(q))
    want = reng.retrieve(ref_index, jnp.asarray(q), cfg, jnp.asarray(qm))
    got = teng._retrieve_batch(
        port_index, torch.from_numpy(q), teng.EngineConfig(
            **KW, use_kernels=True), torch.from_numpy(qm),
        cs=torch.from_numpy(np.array(ref_cs)),
        lut=torch.from_numpy(np.array(ref_lut)))
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(
        want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))


@pytest.mark.parametrize("th_r", [None, 0.4])
def test_reference_math_equals_kernel_path(small_corpus, port_index, th_r):
    q, qm = _queries(small_corpus, slice(18, 24), 6)
    q, qm = torch.from_numpy(q), torch.from_numpy(qm)
    kw = {**KW, "th_r": th_r}
    a = teng.retrieve(port_index, q, teng.EngineConfig(**kw), qm,
                      device="cpu")
    b = teng.retrieve(port_index, teng.QueryBatch(q, qm),
                      teng.EngineConfig(**kw, use_kernels=True),
                      device="cpu")
    assert torch.equal(a.doc_ids, b.doc_ids)
    assert torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32))


def test_phase_entry_points_compose_to_retrieve(small_corpus, port_index):
    q = torch.from_numpy(np.array(small_corpus.queries[:3]))
    cfg = teng.EngineConfig(**KW, use_kernels=True)
    cs, sel1 = teng.phase12_prefilter(port_index, q, cfg, device="cpu")
    assert sel1.dtype == torch.int32 and sel1.shape == (3, KW["n_filter"])
    got = teng.phase34_late_interaction(port_index, q, cfg, cs=cs, sel1=sel1,
                                        device="cpu")
    want = teng.retrieve(port_index, q, cfg, device="cpu")
    assert torch.equal(got.doc_ids, want.doc_ids)
    assert torch.equal(got.scores, want.scores)


@pytest.mark.parametrize("bad", [
    {"n_q": 33}, {"k": 20, "n_docs": 16}, {"n_docs": 128, "n_filter": 64},
    {"candidate_mode": "nope"}, {"candidate_mode": "compact", "cand_cap": 8},
    {"compact_cap": 4, "th_r": None}, {"cs_dtype": "float16"}])
def test_engine_config_raises_reference_errors(bad):
    kw = {**KW, **bad}
    with pytest.raises(ValueError) as want:
        reng.EngineConfig(**kw)
    with pytest.raises(ValueError) as got:
        teng.EngineConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("todo", [
    {"candidate_mode": "compact"}, {"compact_cap": 8},
    {"cs_dtype": "bfloat16"}, {"doc_filter": object()}])
def test_engine_config_refuses_configs_outside_the_slice(todo, small_corpus,
                                                         port_index):
    """Every configuration of the reference is ported: compact mode,
    compact_cap and bf16 CS build as the reference's config does (bf16 CS
    also serves retrieve), and a doc_filter that is no compiled plan is
    refused with the reference's error."""
    kw = {**KW, **todo}
    if todo.get("cs_dtype") == "bfloat16":
        cfg = teng.EngineConfig(**kw)
        assert dataclasses.asdict(cfg) == {
            k: v for k, v in dataclasses.asdict(reng.EngineConfig(**kw))
            .items() if k != "kernel_interpret"}
        q, _ = _queries(small_corpus, slice(0, 2), 0)
        res = teng.retrieve(port_index, q, cfg, device="cpu")
        assert res.doc_ids.shape == (2, KW["k"])
        assert res.scores.dtype == torch.float32
        assert torch.isfinite(res.scores).all()
    elif "doc_filter" in todo:
        with pytest.raises(ValueError) as want:
            reng.EngineConfig(**kw)
        with pytest.raises(ValueError) as got:
            teng.EngineConfig(**kw)
        assert str(got.value) == str(want.value)
    else:
        assert dataclasses.asdict(teng.EngineConfig(**kw)) == {
            k: v for k, v in dataclasses.asdict(reng.EngineConfig(**kw))
            .items() if k != "kernel_interpret"}


def test_engine_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(reng.EngineConfig)}
    port = {f.name: f.default for f in dataclasses.fields(teng.EngineConfig)}
    del ref["kernel_interpret"]
    assert port == ref


LANES = {
    "unfused_prefilter": dict(fused_prefilter=False),
    "unfused_late": dict(fused_late_interaction=False),
    "unfused_both": dict(fused_prefilter=False, fused_late_interaction=False),
}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _same_result(got, want):
    assert got.doc_ids.dtype == torch.int32
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("case", ["b1_padded_mask_eq5", "b4",
                                  "b4_eq5", "b4_padded_mask"])
def test_unfused_retrieve_matches_reference(small_corpus, small_index,
                                            port_index, lane, case):
    rows, pad, over = CASES[case]
    q, qm = _queries(small_corpus, rows, pad)
    kw = {**KW, **over, "use_kernels": True, **LANES[lane]}
    want = reng.retrieve(small_index[0], jnp.asarray(q),
                         reng.EngineConfig(**kw), _j(qm))
    tops.reset_launches()
    got = teng.retrieve(port_index, _t(q), teng.EngineConfig(**kw), _t(qm),
                        device="cpu")
    assert set(tops.launch_counts().values()) == {0}   # no CPU launch
    _same_result(got, want)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_unfused_lane_with_injected_cs_and_lut(small_corpus, small_index,
                                               port_index, lane):
    ref_index, _ = small_index
    q, qm = _queries(small_corpus, slice(14, 18), 4)
    kw = {**KW, "use_kernels": True, **LANES[lane]}
    ref_cs, ref_lut = _ref_cs_lut(ref_index, jnp.asarray(q))
    want = reng.retrieve(ref_index, jnp.asarray(q), reng.EngineConfig(**kw),
                         jnp.asarray(qm))
    got = teng._retrieve_batch(port_index, _t(q), teng.EngineConfig(**kw),
                               _t(qm), cs=_t(ref_cs), lut=_t(ref_lut))
    _same_result(got, want)


@pytest.mark.parametrize("pad", [0, 6])
def test_single_phase_entry_points_match_reference(small_corpus, small_index,
                                                   port_index, pad):
    """Each entry point on the reference's own intermediates, output by
    output, under the unfused kernel config."""
    ref_index, _ = small_index
    q, qm = _queries(small_corpus, slice(0, 3), pad)
    kw = {**KW, "use_kernels": True, **LANES["unfused_both"]}
    rcfg, tcfg = reng.EngineConfig(**kw), teng.EngineConfig(**kw)
    jq, tq = jnp.asarray(q), _t(q)

    r_cs, r_bits, r_bitmap = reng.phase1_candidates(ref_index, jq, rcfg,
                                                    q_mask=_j(qm))
    t_cs, t_bits, t_bitmap = teng.phase1_candidates(
        port_index, tq, tcfg, q_mask=_t(qm), device="cpu")
    assert t_bits.dtype == torch.int32
    np.testing.assert_array_equal(_bits(t_cs), _bits(r_cs))
    np.testing.assert_array_equal(t_bits.numpy().view(np.uint32),
                                  np.asarray(r_bits))
    np.testing.assert_array_equal(t_bitmap.numpy(), np.asarray(r_bitmap))

    r_sel1 = reng.phase2_prefilter(ref_index, jq, rcfg, bits=r_bits,
                                   bitmap=r_bitmap)
    t_sel1 = teng.phase2_prefilter(
        port_index, tq, tcfg, bits=_t(np.asarray(r_bits).view(np.int32)),
        bitmap=_t(r_bitmap), device="cpu")
    assert t_sel1.dtype == torch.int32
    np.testing.assert_array_equal(t_sel1.numpy(), np.asarray(r_sel1))

    r_sel2 = reng.phase3_centroid_interaction(
        ref_index, jq, rcfg, q_mask=_j(qm), cs=r_cs, sel1=r_sel1)
    t_sel2 = teng.phase3_centroid_interaction(
        port_index, tq, tcfg, q_mask=_t(qm), cs=_t(r_cs), sel1=_t(r_sel1),
        device="cpu")
    assert t_sel2.dtype == torch.int32
    np.testing.assert_array_equal(t_sel2.numpy(), np.asarray(r_sel2))

    want = reng.phase4_late_interaction(ref_index, jq, rcfg, q_mask=_j(qm),
                                        cs=r_cs, sel2=r_sel2)
    got = teng.phase4_late_interaction(port_index, tq, tcfg, q_mask=_t(qm),
                                       cs=_t(r_cs), sel2=_t(r_sel2),
                                       device="cpu")
    _same_result(got, want)


@pytest.mark.parametrize("lane", ["fused", *sorted(LANES)])
def test_single_phase_entry_points_compose_to_retrieve(small_corpus,
                                                       port_index, lane):
    q, qm = (_t(x) for x in _queries(small_corpus, slice(2, 5), 3))
    cfg = teng.EngineConfig(**KW, use_kernels=True, **LANES.get(lane, {}))
    kw = dict(q_mask=qm, device="cpu")
    cs, bits, bitmap = teng.phase1_candidates(port_index, q, cfg, **kw)
    sel1 = teng.phase2_prefilter(port_index, q, cfg, bits=bits,
                                 bitmap=bitmap, **kw)
    assert sel1.shape == (3, KW["n_filter"])
    sel2 = teng.phase3_centroid_interaction(port_index, q, cfg, cs=cs,
                                            sel1=sel1, **kw)
    assert sel2.shape == (3, KW["n_docs"])
    got = teng.phase4_late_interaction(port_index, q, cfg, cs=cs, sel2=sel2,
                                       **kw)
    want = teng.retrieve(port_index, q, cfg, qm, device="cpu")
    assert torch.equal(got.doc_ids, want.doc_ids)
    assert torch.equal(got.scores.view(torch.int32),
                       want.scores.view(torch.int32))
    # each entry point also runs the phases it was not handed
    alone = teng.phase4_late_interaction(port_index, q, cfg, **kw)
    assert torch.equal(alone.doc_ids, want.doc_ids)
    assert torch.equal(teng.phase3_centroid_interaction(
        port_index, q, cfg, **kw), sel2)
    assert torch.equal(teng.phase2_prefilter(port_index, q, cfg, **kw), sel1)


@pytest.mark.parametrize("th_r", [None, 0.4])
def test_fused_equals_unfused(small_corpus, port_index, th_r):
    q, qm = (_t(x) for x in _queries(small_corpus, slice(18, 24), 6))
    kw = {**KW, "th_r": th_r, "use_kernels": True}
    fused = teng.retrieve(port_index, q, teng.EngineConfig(**kw), qm,
                          device="cpu")
    for lane, flags in LANES.items():
        got = teng.retrieve(port_index, q, teng.EngineConfig(**kw, **flags),
                            qm, device="cpu")
        assert torch.equal(got.doc_ids, fused.doc_ids), lane
        assert torch.equal(got.scores.view(torch.int32),
                           fused.scores.view(torch.int32)), lane


@pytest.mark.parametrize("n_c,n_q", [(512, 16), (511, 15)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_products_are_batch_invariant(n_c, n_q, dtype):
    """A query's CS and LUT rows have the same bits in a batch of 1, 16, 17
    or 32: each query's product runs at one fixed shape (engine.centroid_scores),
    on slices of the output at a 16-byte multiple (512 x 16) or through a
    fresh result (511 x 15 floats a query is no 16-byte multiple)."""
    from repro_torch.data import synthetic
    index, _ = synthetic.make_packed_index(
        0, n_docs=300, cap=16, min_len=6, d=32, n_centroids=n_c, m=4,
        nbits=4, list_cap=None, device="cpu")
    q, _ = synthetic.make_queries(index, 1, 32, n_q)
    cs = teng.centroid_scores(q, index.centroids, dtype)
    lut = teng._query_lut(index, q)
    assert cs.shape == (32, n_q, n_c) and lut.shape == (32, n_q, 4, 16)
    for b in (1, 16, 17):
        for off in (0, 32 - b):
            rows = slice(off, off + b)
            assert torch.equal(teng.centroid_scores(
                q[rows], index.centroids, dtype).view(torch.int16),
                cs[rows].view(torch.int16)), (b, off)
            assert torch.equal(teng._query_lut(index, q[rows]).view(
                torch.int32), lut[rows].view(torch.int32)), (b, off)
    # one query without a batch axis is the same row too
    assert torch.equal(teng.centroid_scores(q[3], index.centroids, dtype)
                       .view(torch.int16), cs[3].view(torch.int16))
