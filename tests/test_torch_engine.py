"""The slice as a whole: the port's ``retrieve`` against the reference's
``repro.core.engine.retrieve`` (``use_kernels=True``, Pallas interpret mode)
on the same index bytes and the same queries, at B = 4 and B = 1, with a
padded query-term mask and with ``th_r`` both set and None.

Each case first holds the CS and LUT bits (the two framework matmuls; 0
mismatches at these shapes), so a failure names the layer, then the final
doc ids and float32 score bits. One case injects the reference's CS and LUT
through the ``cs=``/``lut=`` overrides, which holds phases 1b-4 exactly
whatever the matmuls do.
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
    assert tops.launch_counts() == {"prefilter": 0, "pqinter": 0}
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
    {"cs_dtype": "bfloat16"}, {"doc_filter": object()},
    {"use_kernels": True, "fused_prefilter": False},
    {"use_kernels": True, "fused_late_interaction": False}])
def test_engine_config_refuses_configs_outside_the_slice(todo):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.EngineConfig(**{**KW, **todo})


def test_engine_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(reng.EngineConfig)}
    port = {f.name: f.default for f in dataclasses.fields(teng.EngineConfig)}
    del ref["kernel_interpret"]
    assert port == ref
