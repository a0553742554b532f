"""The port's CUDA kernels against their plain PyTorch versions on the
card: ids, int scores, bit words and float32 score bits, exactly. Every test
here needs a CUDA card, is marked ``cuda`` and skips without one.

The tests directory's conftest imports jax, which the GPU machine lacks, so
run this file there without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitfilter as kbf
from repro_torch.kernels import bitpack as kbp
from repro_torch.kernels import cinter as kci
from repro_torch.kernels import ops
from repro_torch.kernels import pqinter as kpq
from repro_torch.kernels import pqscore as kps
from repro_torch.kernels import prefilter as kpf
from repro_torch.kernels import topnprobe as ktp
from torch_inputs import (BF16_EDGES, BF16_TH, BF16_TH_R, bf16_edges,
                          compact_inputs, doc_pass_rows, lit_row_words,
                          plan_words, pqinter_inputs, prefilter_inputs,
                          topnprobe_inputs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *xs):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
def test_prefilter_kernel_equals_plain(card, nb):
    cs, codes, mask, bitmap, qm = _on(card, *prefilter_inputs(
        nb, nb, 32, 300, 2100, 12))
    lens = mask.sum(-1, dtype=torch.int32)
    before = kpf.launches
    got = ops.prefilter_batched(cs, 0.25, codes, lens, bitmap, 200, qm)
    torch.cuda.synchronize()
    assert kpf.launches == before + -(-nb // kpf.MAX_BATCH)
    _same(got, kpf.prefilter_batched_ref(cs, 0.25, codes, lens, bitmap, 200,
                                         qm))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32])
@pytest.mark.parametrize("th_r", [None, 0.25])
def test_pqinter_kernel_equals_plain(card, nb, th_r):
    cs_t, lut, codes, res, mask, qm = _on(card, *pqinter_inputs(
        nb, nb, 32, 200, 150, 10, 16, 256))
    lens = mask.sum(-1, dtype=torch.int32)
    before = kpq.launches
    got = ops.pqinter_batched(cs_t, lut, codes, res, lens, th_r, 40, 10, qm)
    torch.cuda.synchronize()
    assert kpq.launches == before + 1
    _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens, th_r, 40,
                                       10, qm))


EDGE_LENS = (0, 1, 31, 32, 33, 80)   # a round's edges at cap 80
CHUNK_LENS = (0, 127, 128, 129, 200)  # the prefilter's 128-token chunks
ROUND_LENS = (0, 127, 128, 129, 192, 193, 200)  # bitfilter's rounds
SPLIT_LENS = (0, 1, 7, 8, 9, 79, 80)  # pqscore's 8-warp token split


def slot_lens(cap):
    """Token counts at the Eq. 5/6 cluster pass's edges: a warp load covers
    32 / T token slots (T = 8, 4, 2, 1 terms a CTA) and a round two loads,
    so 0, 1 and each multiple of 4 up to 64 and its neighbours, and cap."""
    edges = {0, 1, cap - 1, cap}
    for w in (4, 8, 16, 32, 64):
        edges |= {w - 1, w, w + 1}
    return tuple(sorted(n for n in edges if 0 <= n <= cap))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, n_c, n_docs, cap, n_filter, density, lens, kind
    (32, 300, 5003, 12, 200, 0.02, None, ""),          # sparse candidacy
    (32, 300, 3001, 12, 200, 0.9, None, ""),           # dense candidacy
    (21, 300, 3001, 12, 200, 0.97, None, ""),          # dense, odd batch
    (32, 300, 3001, 12, 200, 0.3, None, "shared"),     # one candidate set
    (3, 300, 2100, 80, 200, 0.3, EDGE_LENS, ""),       # cap 80
    (3, 64, 4100, 12, 2500, 0.9, None, "flat"),        # ties across tiles
    (32, 64, 4100, 12, 2500, 0.9, None, "flat"),       # ties, sorted cut
    (1, 300, 1025, 12, 1025, 0.3, None, ""),           # a tile plus one doc
    (32, 300, 2100, 200, 200, 0.6, CHUNK_LENS, ""),    # docs over 2 chunks
], ids=["sparse", "dense", "dense_odd_batch", "shared", "cap80", "ties",
        "ties_sorted_cut", "tile_plus_one", "cap200"])
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_kernel_stress(card, case, masked):
    nb, n_c, n_docs, cap, n_filter, density, lens, kind = case
    cs, codes, mask, bitmap, qm = prefilter_inputs(
        n_docs, nb, 32, n_c, n_docs, cap, density=density, lens=lens)
    if kind == "flat":          # one word per query: F ties in every tile
        cs = np.repeat(cs[:, :, :1], n_c, axis=2)
    if kind == "shared":
        bitmap[:] = bitmap[:1]
    cs, codes, mask, bitmap, qm = _on(card, cs, codes, mask, bitmap, qm)
    lens = mask.sum(-1, dtype=torch.int32)
    qm = qm if masked else None
    got = ops.prefilter_batched(cs, 0.25, codes, lens, bitmap, n_filter, qm)
    torch.cuda.synchronize()
    _same(got, kpf.prefilter_batched_ref(cs, 0.25, codes, lens, bitmap,
                                         n_filter, qm))
    _same((ops.bitpack_batched(cs, 0.25, qm),),
          (kbp.bitpack_batched_ref(cs, 0.25, qm),))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, nf, cap, m, K, n_docs, k, lens, th_r, n_q
    (3, 300, 80, 16, 256, 60, 20, EDGE_LENS, 0.25, 32),    # cap 80, m = 16
    (3, 300, 17, 5, 7, 60, 20, None, 0.25, 32),            # odd m and K
    (2, 200, 33, 8, 16, 50, 10, None, None, 32),           # m = 8, serial
    (2, 200, 12, 4, 16, 50, 10, None, 0.25, 32),           # m = 4, serial
    (2, 200, 12, 32, 16, 50, 10, None, 0.25, 32),          # m = 32, serial
    (3, 300, 17, 16, 256, 60, 20, None, 100.0, 32),        # Eq. 6 keeps none
    (32, 2100, 12, 4, 16, 2100, 50, None, 0.25, 32),       # both cuts sorted
    # the Eq. 5/6 cluster pass: T = 8 terms a CTA, clusters of 1 to 4
    # (multicast rings), one term (T = 1), ragged last groups
    (3, 300, 80, 16, 256, 60, 20, slot_lens(80), 0.25, 1),
    (40, 300, 80, 16, 256, 256, 20, slot_lens(80), 0.25, 7),
    (3, 300, 80, 16, 256, 60, 20, slot_lens(80), None, 8),
    (32, 300, 80, 16, 256, 256, 20, slot_lens(80), 0.25, 9),
    (3, 300, 80, 8, 256, 60, 20, slot_lens(80), 0.25, 16),   # serial m
    (3, 300, 80, 5, 256, 60, 20, slot_lens(80), None, 17),   # serial m
    (1, 300, 33, 16, 256, 1, 1, slot_lens(33), 0.25, 24),    # codes read
    (3, 300, 200, 16, 256, 60, 20, slot_lens(200), 0.25, 32),  # directly
    (3, 300, 80, 32, 256, 60, 20, slot_lens(80), 0.25, 32),  # T = 4, C = 8
    (2, 200, 80, 64, 256, 50, 10, slot_lens(80), 0.25, 32),  # T = 2: 2 passes
    (2, 100, 10, 256, 256, 30, 10, None, 0.25, 32),          # the L2 form
], ids=["cap80_m16", "odd_m_K", "m8", "m4", "m32", "eq6_none_kept",
        "sorted_cuts", "cluster_nq1", "cluster_nq7_b40", "cluster_nq8",
        "cluster_nq9_b32", "cluster_nq16_m8", "cluster_nq17_m5",
        "cluster_nq24_cap33_one_doc", "cluster_cap200", "cluster_m32_t4",
        "cluster_m64_t2_passes", "l2_form_m256"])
@pytest.mark.parametrize("masked", [False, True])
def test_pqinter_kernel_stress(card, case, masked):
    nb, nf, cap, m, ksub, n_docs, k, lens, th_r, n_q = case
    cs_t, lut, codes, res, mask, qm = _on(card, *pqinter_inputs(
        nf + m, nb, n_q, 200, nf, cap, m, ksub, lens=lens))
    lens = mask.sum(-1, dtype=torch.int32)
    qm = qm if masked else None
    got = ops.pqinter_batched(cs_t, lut, codes, res, lens, th_r, n_docs, k,
                              qm)
    torch.cuda.synchronize()
    _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens, th_r,
                                       n_docs, k, qm))
    _same((ops.pqscore_batched(cs_t, lut, codes, res, lens, th_r, qm),),
          (kps.pqscore_batched_ref(cs_t, lut, codes, res, lens, th_r, qm),))
    _same((ops.cinter_batched(cs_t, codes, lens, qm),),
          (kci.cinter_batched_ref(cs_t, codes, lens, qm),))


@pytest.mark.cuda
def test_wrappers_refuse_bad_card_operands(card):
    cs, codes, mask, bitmap, qm = _on(card, *prefilter_inputs(
        0, 2, 32, 64, 100, 6))
    lens = mask.sum(-1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.prefilter_batched(cs, 0.2, codes.long(), lens, bitmap, 10, qm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.prefilter_batched(cs.transpose(1, 2).contiguous().transpose(
            1, 2), 0.2, codes, lens, bitmap, 10, qm)
    with pytest.raises(ValueError, match="on cpu"):
        ops.prefilter_batched(cs, 0.2, codes, lens, bitmap.cpu(), 10, qm)
    with pytest.raises(ValueError, match="expected"):
        ops.prefilter_batched(cs, 0.2, codes, lens, bitmap, 10,
                              qm[:, :16].contiguous())
    cs_t, lut, pcodes, res, pmask, pqm = _on(card, *pqinter_inputs(
        0, 2, 32, 64, 20, 6, 4, 16))
    plens = pmask.sum(-1, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        ops.pqinter_batched(cs_t[:1].contiguous(), lut, pcodes, res, plens,
                            None, 8, 4, pqm)


@pytest.mark.cuda
@pytest.mark.parametrize("n_c", [262_144, 1001])
@pytest.mark.parametrize("nb", [1, 16, 17, 32, 40])
@pytest.mark.parametrize("nprobe", [1, 2, 4, 8, 32, 33, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topnprobe_kernel_equals_plain(card, dtype, nprobe, nb, n_c):
    """The masked top-nprobe kernel == its plain version on the card, ids
    exactly, in one launch: both forms (nprobe <= 32 in registers, 33 and
    256 the exact form), one block a row and the cluster split of small
    batches, n_c = 2^18 and an odd n_c (rows off 16-byte boundaries), rows
    with 0, 1, nprobe - 1, nprobe and n_c survivors, ties before and after
    the -1e6 offset, signed zeros, entries equal to th and bf16(th), masked
    terms."""
    cs, qm = topnprobe_inputs(nb, nb, 32, n_c, nprobe, 0.4, card)
    cs = cs.to(dtype)
    before = ktp.launches
    got = ktp.masked_topk(cs, 0.4, nprobe, qm)
    torch.cuda.synchronize()
    assert ktp.launches == before + 1
    _same((got,), (ktp.masked_topk_ref(cs, 0.4, nprobe, qm),))


@pytest.mark.cuda
@pytest.mark.parametrize("n_c", [262_144, 40_001, 1001])
@pytest.mark.parametrize("th", [-0.25, 0.4, np.float32(0.4)])
@pytest.mark.parametrize("nprobe", [4, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topnprobe_thresholds_and_layouts(card, dtype, nprobe, th, n_c):
    """Through ``masked_topk_centroids``, the engine's call: signed zeros
    among the survivors (th < 0), a numpy th (bf16 CS compared in
    float32), no term mask, and a CS whose base lies off a 16-byte
    boundary, at B = 17 and at B = 1 (a cluster of blocks a row, whose
    parts start off 16-byte boundaries at the odd n_c); the ids equal the
    plain version's."""
    from repro_torch.core import bitvector as tbv
    for nb in (17, 1):
        cs, qm = topnprobe_inputs(7, nb, 32, n_c, nprobe, th, card)
        cs = cs.to(dtype)
        flat = torch.empty(cs.numel() + 1, dtype=dtype, device=card)
        off = flat[1:].view(cs.shape)
        off.copy_(cs)
        for x, m in ((cs, qm), (cs, None), (off, qm)):
            before = ktp.launches
            got = tbv.masked_topk_centroids(x, th, nprobe, m)
            torch.cuda.synchronize()
            assert ktp.launches == before + 1
            _same((got,), (ktp.masked_topk_ref(x, th, nprobe, m),))


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["fused", "unfused"])
@pytest.mark.parametrize("nb", [1, 32])
def test_retrieve_launches_topnprobe_once(card, lane, nb, monkeypatch):
    """One retrieve selects its probes in one topnprobe launch on either
    lane, and returns the ids and score bits it returns with the plain
    selection."""
    import dataclasses

    from repro_torch.core import bitvector as tbv
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    w = dict(n_docs=20_000, cap=40, d=64, n_centroids=1024, m=16,
             list_cap=1024)
    spec = _small_emvb_spec(w["n_docs"], w["cap"], w["d"], w["n_centroids"],
                            w["m"], w["list_cap"])
    index, _ = synthetic.make_packed_index(0, min_len=20, nbits=8,
                                           device=card, **w)
    queries, _ = synthetic.make_queries(index, 1, nb, 32)
    cfg = dataclasses.replace(spec.make_config().engine, use_kernels=True)
    if lane == "unfused":
        cfg = dataclasses.replace(cfg, fused_prefilter=False,
                                  fused_late_interaction=False)
    ops.reset_launches()
    got = teng.retrieve(index, queries, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["topnprobe"] == 1
    monkeypatch.setattr(tbv, "masked_topk_centroids", tbv.masked_topk_plain)
    want = teng.retrieve(index, queries, cfg)
    _same((got.doc_ids, got.scores), (want.doc_ids, want.scores))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 17, 32, 40])
@pytest.mark.parametrize("lit_share", [None, 0.02, 0.0, 1.0])
def test_bitpack_and_bitfilter_kernels_equal_plain(card, nb, lit_share):
    """bitpack's words (lit_share None), then word tables whose rows are lit
    at 2 %, none or all: bitfilter gathers only lit rows. n_c = 300 is no
    multiple of 32."""
    cs, codes, mask, _, qm = _on(card, *prefilter_inputs(
        nb, nb, 32, 300, 2100, 12))
    lens = mask.sum(-1, dtype=torch.int32)
    before = (kbp.launches, kbf.launches)
    bits = ops.bitpack_batched(cs, 0.25, qm)
    if lit_share is not None:
        bits, = _on(card, lit_row_words(nb, nb, 300, lit_share).view(
            np.int32))
    f = ops.bitfilter_batched(bits, codes, lens)
    torch.cuda.synchronize()
    assert (kbp.launches, kbf.launches) == (
        before[0] + 1, before[1] + -(-nb // kbf.MAX_BATCH))
    want_bits = kbp.bitpack_batched_ref(cs, 0.25, qm)
    if lit_share is None:
        _same((bits,), (want_bits,))
    _same((f,), (kbf.bitfilter_batched_ref(bits, codes, lens),))
    if lit_share != 0.0:
        assert (bits < 0).any()    # bit 31 set: the words are unsigned


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, n_c, n_docs, cap, lit-row share, lens
    (1, 1_500_001, 3001, 80, 0.02, EDGE_LENS),  # bitmap above the shared-
    (32, 600_001, 3001, 80, 0.02, EDGE_LENS),   # memory limit: read from
    (3, 1001, 2100, 200, 0.3, ROUND_LENS),      # global memory; cap 200
    (32, 1001, 2100, 200, 0.3, ROUND_LENS),     # over 128-code rounds
    (17, 1001, 3001, 80, 1.0, EDGE_LENS),       # every row lit
], ids=["global_bitmap_b1", "global_bitmap_b32", "cap200_b3", "cap200_b32",
        "every_row_lit_b17"])
def test_bitfilter_kernel_stress(card, case):
    nb, n_c, n_docs, cap, share, lens = case
    _, codes, mask, _, _ = prefilter_inputs(n_docs, 1, 1, n_c, n_docs, cap,
                                            lens=lens)
    bits, codes, mask = _on(card, lit_row_words(n_docs, nb, n_c, share).view(
        np.int32), codes, mask)
    lens = mask.sum(-1, dtype=torch.int32)
    f = ops.bitfilter_batched(bits, codes, lens)
    torch.cuda.synchronize()
    _same((f,), (kbf.bitfilter_batched_ref(bits, codes, lens),))


# The Eq. 5/6 pass's shapes: cap, m, K, lens, n_q, docs a query. m = 16
# compiled in, m = 5 and 8 the serial form; n_q 1 to 32 (T = 8 terms a CTA,
# clusters of 1 to 4 CTAs, ragged last groups); m = 32 forces T = 4 (C = 8)
# and m = 64 T = 2 (two groups a CTA in turn); m = 256 the L2 form; cap 33
# and 200 read the codes from global memory, cap 80 through multicast rings.
PQ_SHAPES = {
    "cap10_m16": (10, 16, 256, None, 32, 150),
    "cap80_m16": (80, 16, 256, SPLIT_LENS, 32, 150),
    "cap80_m5": (80, 5, 256, SPLIT_LENS, 32, 150),
    "cap80_m8": (80, 8, 16, SPLIT_LENS, 32, 150),
    "cap80_m16_nq1": (80, 16, 256, slot_lens(80), 1, 150),
    "cap80_m16_nq7": (80, 16, 256, slot_lens(80), 7, 150),
    "cap80_m16_nq8": (80, 16, 256, slot_lens(80), 8, 150),
    "cap80_m16_nq9": (80, 16, 256, slot_lens(80), 9, 150),
    "cap80_m8_nq16": (80, 8, 256, slot_lens(80), 16, 150),
    "cap80_m5_nq17": (80, 5, 256, slot_lens(80), 17, 150),
    "cap33_m16_nq24": (33, 16, 256, slot_lens(33), 24, 150),
    "cap200_m16": (200, 16, 256, slot_lens(200), 32, 150),
    "cap80_m32_t4": (80, 32, 256, slot_lens(80), 32, 150),
    "cap80_m64_t2": (80, 64, 256, slot_lens(80), 32, 60),
    "cap10_m256_l2": (10, 256, 256, None, 32, 40),
    "one_doc": (80, 16, 256, slot_lens(80), 32, 1),
    "docs256": (80, 16, 256, None, 32, 256),
    "docs10000": (12, 16, 256, None, 32, 10_000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("th_r", [None, 0.25])
@pytest.mark.parametrize("shape", list(PQ_SHAPES.values()),
                         ids=list(PQ_SHAPES))
@pytest.mark.parametrize("masked", [True, False])
def test_cinter_and_pqscore_kernels_equal_plain(card, nb, th_r, shape,
                                                masked):
    cap, m, ksub, lens, n_q, nd = shape
    cs_t, lut, codes, res, mask, qm = _on(card, *pqinter_inputs(
        nb, nb, n_q, 200, nd, cap, m, ksub, lens=lens))
    lens = mask.sum(-1, dtype=torch.int32)
    qm = qm if masked else None
    before = (kci.launches, kps.launches)
    sbar = ops.cinter_batched(cs_t, codes, lens, qm)
    score = ops.pqscore_batched(cs_t, lut, codes, res, lens, th_r, qm)
    torch.cuda.synchronize()
    assert (kci.launches, kps.launches) == (before[0] + 1, before[1] + 1)
    _same((sbar, score), (
        kci.cinter_batched_ref(cs_t, codes, lens, qm),
        kps.pqscore_batched_ref(cs_t, lut, codes, res, lens, th_r, qm)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,m,form,terms,cluster,passes", [
    (32, 16, "cluster", 8, 4, 1),     # emvb-msmarco: 4 CTAs of 8 terms
    (4, 16, "cluster", 4, 1, 1),      # MIND's 4 interests: one CTA
    (32, 32, "cluster", 4, 8, 1),     # a slice of 8 terms would not fit
    (32, 64, "cluster", 2, 8, 2),     # 16 groups over 8 CTAs, in turn
    (32, 256, "L2", 32, 0, 0),        # not even one term's slice fits
])
def test_eq56_plan_follows_the_shape(card, n_q, m, form, terms, cluster,
                                     passes):
    """Both kernels plan the Eq. 5/6 pass from the shape alone: the cluster
    form wherever one term's LUT slice fits shared memory, its slice staged
    there (K = 256), else the L2 form."""
    _, _, codes, res, _, _ = pqinter_inputs(0, 3, n_q, 64, 40, 12, m, 256)
    cs_t = torch.zeros((3, 64, n_q), device=card)
    codes, res = _on(card, codes, res)
    for plan in (kps.plan(cs_t, codes, res, n_q, m, 256),
                 kpq.eq56_plan("pqinter", "pqinter_eq56_plan", cs_t, res, 40,
                               n_q, m, 256)):
        assert (plan["form"], plan["terms"], plan["cluster"],
                plan["passes"]) == (form, terms, cluster, passes)
        assert kpq.lut_terms("pqscore", n_q, m, 256) == terms
        if form == "cluster":
            assert plan["smem"] >= plan["rows"] * terms * 4 >= m * 256 * 4
            assert 1 <= plan["runs"] <= 40 and plan["clusters"] >= 1
            assert plan["staged_bytes"] > 0


@pytest.mark.cuda
def test_unfused_wrappers_refuse_bad_card_operands(card):
    cs, codes, mask, _, qm = _on(card, *prefilter_inputs(0, 2, 32, 64, 100,
                                                         6))
    lens = mask.sum(-1, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitpack_batched(cs.transpose(1, 2).contiguous().transpose(1, 2),
                            0.2, qm)
    with pytest.raises(ValueError, match="on cpu"):
        ops.bitpack_batched(cs, 0.2, qm.cpu())
    bits = ops.bitpack_batched(cs, 0.2, qm)
    with pytest.raises(TypeError, match="int32"):
        ops.bitfilter_batched(bits.long(), codes, lens)
    with pytest.raises(ValueError, match="on cpu"):
        ops.bitfilter_batched(bits, codes.cpu(), lens.cpu())
    cs_t, lut, pcodes, res, pmask, pqm = _on(card, *pqinter_inputs(
        0, 2, 32, 64, 20, 6, 4, 16))
    plens = pmask.sum(-1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.cinter_batched(cs_t, pcodes.long(), plens, pqm)
    with pytest.raises(ValueError, match="expected"):
        ops.cinter_batched(cs_t[:1].contiguous(), pcodes, plens, pqm)
    with pytest.raises(TypeError, match="uint8"):
        ops.pqscore_batched(cs_t, lut, pcodes, res.int(), plens, 0.1, pqm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pqscore_batched(cs_t, lut, pcodes.transpose(1, 2).contiguous()
                            .transpose(1, 2), res, plens, 0.1, pqm)


# Filtered and compact retrieval's operand forms. Plans by pass rate on
# plan_words' random words: none, about 1 % (six bits required), about half
# (one bit), all; with forbidden bits and bit 31.
CARD_PLANS = {"pass0": (), "pass1pct": ((0b111111 << 8, 1 << 31),),
              "pass50pct": ((1 << 3, 0),), "pass100": ((0, 0),),
              "forbidden": ((1 << 0, 1 << 1), (1 << 31, 0b110))}


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("plan", sorted(CARD_PLANS))
def test_prefilter_plan_kernel_equals_plain(card, nb, plan):
    cs, codes, mask, bitmap, qm = _on(card, *prefilter_inputs(
        nb + 100, nb, 32, 300, 5003, 12, density=0.3))
    words, = _on(card, plan_words(nb, 5003))
    lens = mask.sum(-1, dtype=torch.int32)
    clauses = CARD_PLANS[plan]
    before = kpf.launches
    got = ops.prefilter_batched(cs, 0.25, codes, lens, bitmap, 200, qm,
                                pred_words=words, plan=clauses)
    torch.cuda.synchronize()
    assert kpf.launches == before + -(-nb // kpf.MAX_BATCH)
    _same(got, kpf.prefilter_batched_ref(cs, 0.25, codes, lens, bitmap, 200,
                                         qm, pred_words=words.view(
                                             torch.int32), plan=clauses))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("cand_cap,cap", [(1500, 12), (4100, 80)])
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_per_query_kernel_equals_plain(card, nb, cand_cap, cap,
                                                 masked):
    """Compact mode's per-query buffers, with holes in the valid slots and
    a buffer size that is no multiple of the 1024-doc tile."""
    cs, codes, mask, valid, qm = _on(card, *compact_inputs(
        nb, nb, 32, 300, cand_cap, cap))
    lens = mask.sum(-1, dtype=torch.int32)
    qm = qm if masked else None
    got = ops.prefilter_batched(cs, 0.25, codes, lens, valid, 1024, qm)
    torch.cuda.synchronize()
    _same(got, kpf.prefilter_batched_ref(cs, 0.25, codes, lens, valid, 1024,
                                         qm))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("passing", ["all", "none", "sparse", "few"])
@pytest.mark.parametrize("th_r", [None, 0.25])
def test_pqinter_doc_pass_kernel_equals_plain(card, nb, passing, th_r):
    """doc_pass with every, no, fewer than n_docs and fewer than k
    survivors passing: the fillers of both cuts."""
    cs_t, lut, codes, res, mask, qm = _on(card, *pqinter_inputs(
        nb, nb, 32, 200, 300, 80, 16, 256))
    dp, = _on(card, doc_pass_rows(nb, nb, 300, passing, 60, 20))
    lens = mask.sum(-1, dtype=torch.int32)
    got = ops.pqinter_batched(cs_t, lut, codes, res, lens, th_r, 60, 20, qm,
                              doc_pass=dp)
    torch.cuda.synchronize()
    _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens, th_r, 60,
                                       20, qm, dp))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
def test_bitfilter_per_query_kernel_equals_plain(card, nb):
    _, codes, mask, valid, _ = compact_inputs(nb, nb, 1, 300, 4100, 80)
    lens = (mask & valid[..., None]).sum(-1).astype(np.int32)
    bits, codes, lens = _on(card, lit_row_words(nb, nb, 300, 0.3).view(
        np.int32), codes, lens)
    before = kbf.launches
    f = ops.bitfilter_batched(bits, codes, lens)
    torch.cuda.synchronize()
    assert kbf.launches == before + 1
    _same((f,), (kbf.bitfilter_batched_ref(bits, codes, lens),))


# bf16 CS (cs_dtype="bfloat16"): each kernel's bf16 form against its plain
# version, on CS with entries equal to bf16(th) and bf16(th_r), where the
# lanes' comparison dtypes differ (the prefilter compares in bf16, bitpack
# in float32). n_c 300 takes the prefilter pack's per-column form, 304 (a
# multiple of 8) its 16-byte loads of eight bf16 columns.

def _bf16(dev, x):
    """A float32 array of bf16 values as a bf16 tensor on dev (exact)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("n_c", [300, 304])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_bitpack_and_prefilter_equal_plain(card, nb, n_c, masked):
    cs, codes, mask, bitmap, qm = prefilter_inputs(nb, nb, 32, n_c, 2100, 12)
    cs = bf16_edges(nb, cs)
    cs_b = _bf16(card, cs)
    codes, mask, bitmap, qm = _on(card, codes, mask, bitmap, qm)
    lens = mask.sum(-1, dtype=torch.int32)
    qm = qm if masked else None
    before = (kbp.launches, kpf.launches)
    bits = ops.bitpack_batched(cs_b, BF16_TH, qm)
    got = ops.prefilter_batched(cs_b, BF16_TH, codes, lens, bitmap, 200, qm)
    torch.cuda.synchronize()
    assert (kbp.launches, kpf.launches) == (
        before[0] + 1, before[1] + -(-nb // kpf.MAX_BATCH))
    _same((bits,), (kbp.bitpack_batched_ref(cs_b, BF16_TH, qm),))
    _same(got, kpf.prefilter_batched_ref(cs_b, BF16_TH, codes, lens, bitmap,
                                         200, qm))
    b, i, c = (int(x[0]) for x in np.nonzero(cs == BF16_EDGES[0]))
    if qm is None or qm[b, i]:
        assert (int(bits[b, c]) >> i) & 1 == 1      # float32 comparison
        assert (int(got[2][b, c]) >> i) & 1 == 0    # bf16 comparison


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, n_c, n_docs, cap, n_filter, density, lens
    (32, 304, 5003, 12, 200, 0.02, None),          # sparse candidacy
    (32, 304, 3001, 12, 200, 0.9, None),           # dense candidacy
    (3, 300, 2100, 80, 200, 0.3, EDGE_LENS),       # cap 80
    (32, 304, 2100, 200, 200, 0.6, CHUNK_LENS),    # docs over 2 chunks
], ids=["sparse", "dense", "cap80", "cap200"])
def test_bf16_prefilter_kernel_stress(card, case):
    nb, n_c, n_docs, cap, n_filter, density, lens = case
    cs, codes, mask, bitmap, qm = prefilter_inputs(
        n_docs, nb, 32, n_c, n_docs, cap, density=density, lens=lens)
    cs = _bf16(card, bf16_edges(n_docs, cs))
    codes, mask, bitmap, qm = _on(card, codes, mask, bitmap, qm)
    lens = mask.sum(-1, dtype=torch.int32)
    got = ops.prefilter_batched(cs, BF16_TH, codes, lens, bitmap, n_filter,
                                qm)
    torch.cuda.synchronize()
    _same(got, kpf.prefilter_batched_ref(cs, BF16_TH, codes, lens, bitmap,
                                         n_filter, qm))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 32])
@pytest.mark.parametrize("form", ["plan", "per_query"])
def test_bf16_prefilter_operand_forms_equal_plain(card, nb, form):
    if form == "plan":
        cs, codes, mask, valid, qm = prefilter_inputs(nb, nb, 32, 304, 5003,
                                                      12, density=0.3)
        words, = _on(card, plan_words(nb, 5003))
        extra = dict(pred_words=words, plan=CARD_PLANS["forbidden"])
    else:
        cs, codes, mask, valid, qm = compact_inputs(nb, nb, 32, 304, 4100, 80)
        extra = {}
    cs = _bf16(card, bf16_edges(nb, cs))
    codes, mask, valid, qm = _on(card, codes, mask, valid, qm)
    lens = mask.sum(-1, dtype=torch.int32)
    got = ops.prefilter_batched(cs, BF16_TH, codes, lens, valid, 1024, qm,
                                **extra)
    torch.cuda.synchronize()
    if "pred_words" in extra:
        extra["pred_words"] = extra["pred_words"].view(torch.int32)
    _same(got, kpf.prefilter_batched_ref(cs, BF16_TH, codes, lens, valid,
                                         1024, qm, **extra))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
def test_bf16_bitfilter_on_bitpack_words(card, nb):
    """bitfilter has no bf16 operand: its words come from a bf16 bitpack."""
    cs, codes, mask, _, qm = prefilter_inputs(nb, nb, 32, 300, 2100, 12)
    cs = _bf16(card, bf16_edges(nb, cs))
    codes, mask, qm = _on(card, codes, mask, qm)
    lens = mask.sum(-1, dtype=torch.int32)
    bits = ops.bitpack_batched(cs, BF16_TH, qm)
    f = ops.bitfilter_batched(bits, codes, lens)
    torch.cuda.synchronize()
    _same((f,), (kbf.bitfilter_batched_ref(
        kbp.bitpack_batched_ref(cs, BF16_TH, qm), codes, lens),))


def _bf16_pq(dev, seed, nb, nf, cap, m, ksub, lens=None, n_q=32):
    cs_t, lut, codes, res, mask, qm = pqinter_inputs(seed, nb, n_q, 200, nf,
                                                     cap, m, ksub, lens=lens)
    lut, codes, res, mask, qm = _on(dev, lut, codes, res, mask, qm)
    return (_bf16(dev, bf16_edges(seed, cs_t)), lut, codes, res,
            mask.sum(-1, dtype=torch.int32), qm)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("th_r", [None, BF16_TH_R])
@pytest.mark.parametrize("shape", [
    PQ_SHAPES[s] for s in ("cap10_m16", "cap80_m16", "cap80_m5",
                           "cap80_m16_nq9", "cap33_m16_nq24", "cap80_m32_t4",
                           "cap10_m256_l2")],
    ids=["cap10_m16", "cap80_m16", "cap80_m5", "cap80_m16_nq9",
         "cap33_m16_nq24", "cap80_m32_t4", "cap10_m256_l2"])
@pytest.mark.parametrize("masked", [True, False])
def test_bf16_cinter_and_pqscore_equal_plain(card, nb, th_r, shape, masked):
    cap, m, ksub, lens, n_q, nd = shape
    cs_t, lut, codes, res, lens, qm = _bf16_pq(card, nb, nb, nd, cap, m,
                                               ksub, lens, n_q)
    qm = qm if masked else None
    before = (kci.launches, kps.launches)
    sbar = ops.cinter_batched(cs_t, codes, lens, qm)
    score = ops.pqscore_batched(cs_t, lut, codes, res, lens, th_r, qm)
    torch.cuda.synchronize()
    assert (kci.launches, kps.launches) == (before[0] + 1, before[1] + 1)
    _same((sbar, score), (
        kci.cinter_batched_ref(cs_t, codes, lens, qm),
        kps.pqscore_batched_ref(cs_t, lut, codes, res, lens, th_r, qm)))
    assert torch.equal(sbar.to(torch.bfloat16).float(), sbar)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, nf, cap, m, K, n_docs, k, lens
    (1, 150, 10, 16, 256, 40, 10, None),
    (3, 300, 80, 16, 256, 60, 20, EDGE_LENS),     # cap 80, m = 16
    (32, 150, 10, 16, 256, 40, 10, None),
    (2, 600, 8, 8, 16, 40, 10, None),             # S̄ ties, serial m
    (32, 2100, 12, 4, 16, 2100, 50, None),        # both cuts sorted
], ids=["b1", "cap80_m16", "b32", "ties_m8", "sorted_cuts"])
@pytest.mark.parametrize("th_r", [None, BF16_TH_R])
def test_bf16_pqinter_equals_plain(card, case, th_r):
    nb, nf, cap, m, ksub, n_docs, k, lens = case
    cs_t, lut, codes, res, lens, qm = _bf16_pq(card, nf + m, nb, nf, cap, m,
                                               ksub, lens)
    before = kpq.launches
    got = ops.pqinter_batched(cs_t, lut, codes, res, lens, th_r, n_docs, k,
                              qm)
    torch.cuda.synchronize()
    assert kpq.launches == before + 1
    _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens, th_r,
                                       n_docs, k, qm))


@pytest.mark.cuda
@pytest.mark.parametrize("passing", ["all", "none", "sparse", "few"])
def test_bf16_pqinter_doc_pass_equals_plain(card, passing):
    cs_t, lut, codes, res, lens, qm = _bf16_pq(card, 3, 3, 300, 80, 16, 256)
    dp, = _on(card, doc_pass_rows(3, 3, 300, passing, 60, 20))
    got = ops.pqinter_batched(cs_t, lut, codes, res, lens, BF16_TH_R, 60, 20,
                              qm, doc_pass=dp)
    torch.cuda.synchronize()
    _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens,
                                       BF16_TH_R, 60, 20, qm, dp))


@pytest.mark.cuda
def test_wrappers_refuse_other_cs_dtypes_on_the_card(card):
    cs, codes, mask, bitmap, qm = _on(card, *prefilter_inputs(
        0, 2, 32, 64, 100, 6))
    lens = mask.sum(-1, dtype=torch.int32)
    half = cs.half()
    with pytest.raises(TypeError, match="torch.float32 or torch.bfloat16"):
        ops.bitpack_batched(half, 0.2, qm)
    with pytest.raises(TypeError, match="torch.float32 or torch.bfloat16"):
        ops.prefilter_batched(half, 0.2, codes, lens, bitmap, 10, qm)
    cs_t, lut, pcodes, res, pmask, pqm = _on(card, *pqinter_inputs(
        0, 2, 32, 64, 20, 6, 4, 16))
    plens = pmask.sum(-1, dtype=torch.int32)
    for call in (lambda c: ops.cinter_batched(c, pcodes, plens, pqm),
                 lambda c: ops.pqscore_batched(c, lut, pcodes, res, plens,
                                               0.1, pqm),
                 lambda c: ops.pqinter_batched(c, lut, pcodes, res, plens,
                                               0.1, 8, 4, pqm)):
        with pytest.raises(TypeError, match="torch.float32 or "
                                            "torch.bfloat16"):
            call(cs_t.half())
    with pytest.raises(TypeError, match="float32"):
        ops.pqscore_batched(cs_t.bfloat16(), lut.bfloat16(), pcodes, res,
                            plens, 0.1, pqm)


# The S̄ pass that cinter and pqinter's pass 1 share (emvb::sbar_block):
# n_q 1 and 7 run one lane per term; 4, 8, 12, 16 and 32 the 16-byte rows
# in float32 (1, 2, 4 (3 pieces), 4 and 8 lanes a row), 8, 16 and 32 in
# bf16 (1, 2 and 4 lanes); a CS^T one element past 16-byte alignment runs
# one lane per term. Docs per query such that on an H100's 132 SMs B = 1,
# 3 and 40 split a doc over up to 8, 4 and 2 warps (fewer where cap is
# short of that many rounds), B = 32 over one; lengths at the 8-warp
# split's and the 16- to 128-token rounds' edges, 0 and cap among them.
SBAR_DOCS = {1: 300, 3: 400, 32: 300, 40: 60}


# Cuts of any size: the prefilter's counting rank and pqinter's
# radix-select cuts above the shared-memory forms, on every operand form,
# held exactly: at the old edges (n_filter 8,192 / 8,193, n 4,096 / 4,097),
# at one block's sort's edge (16,384 / 16,385 kept keys), keeping every key
# and keeping one.
CUT_DOCS = 20_000
PREFILTER_FORMS = ("shared", "ties", "plan", "per_query")


def _prefilter_form(dev, form, nb, dtype, n_docs=CUT_DOCS):
    """A prefilter operand form's operands: codes shared by the batch (with
    F ties in every tile: one word a query), with a plan, or per query
    (compact mode, holes in the valid slots); float32 or bf16 CS."""
    if form == "per_query":
        cs, codes, mask, bitmap, qm = compact_inputs(nb, nb, 32, 304, n_docs,
                                                     12)
    else:
        cs, codes, mask, bitmap, qm = prefilter_inputs(
            nb, nb, 32, 304, n_docs, 12, density=0.5)
    if form == "ties":
        cs = np.repeat(cs[:, :, :1], cs.shape[2], axis=2)
    extra = {}
    if form == "plan":
        words, = _on(dev, plan_words(nb, n_docs))
        extra = dict(pred_words=words, plan=CARD_PLANS["pass50pct"])
    if dtype == "bfloat16":
        cs = _bf16(dev, bf16_edges(nb, cs))
    else:
        cs, = _on(dev, cs)
    codes, mask, bitmap, qm = _on(dev, codes, mask, bitmap, qm)
    return cs, codes, mask.sum(-1, dtype=torch.int32), bitmap, qm, extra


def _hold_prefilter(cs, codes, lens, bitmap, n_filter, qm, extra):
    th = BF16_TH if cs.dtype == torch.bfloat16 else 0.25
    got = ops.prefilter_batched(cs, th, codes, lens, bitmap, n_filter, qm,
                                **extra)
    torch.cuda.synchronize()
    if "pred_words" in extra:
        extra = dict(extra, pred_words=extra["pred_words"].view(torch.int32))
    _same(got, kpf.prefilter_batched_ref(cs, th, codes, lens, bitmap,
                                         n_filter, qm, **extra))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 3, 32])
@pytest.mark.parametrize("form", PREFILTER_FORMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_filter", [1, 200, 1024, 4096, 8192, 8193, 16384,
                                      CUT_DOCS])
def test_prefilter_any_n_filter_equals_plain(card, nb, form, dtype,
                                             n_filter):
    """Up to the whole corpus: n_filter = n_docs keeps every candidate and
    then the lowest ids of the rest (F = -1)."""
    cs, codes, lens, bitmap, qm, extra = _prefilter_form(card, form, nb,
                                                         dtype)
    _hold_prefilter(cs, codes, lens, bitmap, n_filter, qm, extra)


PQ_CUTS = (
    # n_filter, n_docs, k
    (4096, 4096, 4096),      # the shared-memory forms' edge, every key kept
    (4097, 4097, 4097),      # the cut of any size, every key kept
    (4097, 1, 1),            # one key kept
    (4097, 4096, 100),       # cut 1 of any size, cut 2 in shared memory
    (20000, 10000, 10000),   # fig9's post-filter lane
    (20000, 16384, 16384),   # one block's sort at its edge (B >= 5)
    (20000, 16385, 16385),   # ranked by counting past it
    (20000, 16385, 1),
)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 5, 32, 40])   # the rank counted; sorted
@pytest.mark.parametrize("cut", PQ_CUTS, ids=lambda c: "_".join(map(str, c)))
@pytest.mark.parametrize("form", ["float32", "bfloat16", "doc_pass",
                                  "doc_pass_few"])
def test_pqinter_any_cut_equals_plain(card, nb, cut, form):
    """S̄ ties everywhere (a CS and LUT of two levels), so both cuts break
    ties by position in the keys' low bits."""
    nf, n_docs, k = cut
    cs_t, lut, codes, res, mask, qm = pqinter_inputs(nf + nb, nb, 32, 200,
                                                     nf, 10, 16, 16)
    lut, codes, res, mask, qm = _on(card, lut, codes, res, mask, qm)
    cs_t = (_bf16(card, bf16_edges(nf, cs_t)) if form == "bfloat16"
            else _on(card, cs_t)[0])
    th_r = BF16_TH_R if form == "bfloat16" else 0.25
    dp = None
    if form.startswith("doc_pass"):
        dp, = _on(card, doc_pass_rows(nf, nb, nf, "sparse" if form ==
                                      "doc_pass" else "few", n_docs, k))
    lens = mask.sum(-1, dtype=torch.int32)
    before = kpq.launches
    got = ops.pqinter_batched(cs_t, lut, codes, res, lens, th_r, n_docs, k,
                              qm, doc_pass=dp)
    torch.cuda.synchronize()
    assert kpq.launches == before + 1
    _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens, th_r,
                                       n_docs, k, qm, dp))


@pytest.mark.cuda
def test_masks_with_holes_equal_compacted_on_card(card):
    """Every wrapper given a token mask with holes (arbitrary codes in the
    holes) returns what it returns on the operands compacted by hand."""
    rng = np.random.default_rng(7)
    nb, nd, cap, m = 3, 500, 8, 16
    cs, codes, _, bitmap, qm = prefilter_inputs(3, nb, 32, 300, nd, cap)
    cs_t, lut, pcodes, res, _, _ = pqinter_inputs(3, nb, 32, 300, nd, cap, m,
                                                  16)
    holes = rng.random((nd, cap)) < 0.6
    pholes = rng.random((nb, nd, cap)) < 0.6

    def packed(mask, *xs):
        order = np.argsort(~mask, axis=-1, kind="stable")
        return (mask.sum(-1).astype(np.int32),
                *(np.take_along_axis(x, order.reshape(
                    *order.shape, *(1,) * (x.ndim - order.ndim)), -1 -
                    (x.ndim - order.ndim)) for x in xs))

    lens, pk = packed(holes, codes)
    plens, ppk, pres = packed(pholes, pcodes, res)
    (cs, codes, holes, bitmap, qm, lens, pk, cs_t, lut, pcodes, res, pholes,
     plens, ppk, pres) = _on(card, cs, codes, holes, bitmap, qm, lens, pk,
                             cs_t, lut, pcodes, res, pholes, plens, ppk, pres)
    bits = ops.bitpack_batched(cs, 0.25, qm)
    pairs = [
        (lambda t, c: ops.prefilter_batched(cs, 0.25, c, t, bitmap, 200, qm),
         (holes, codes), (lens, pk)),
        (lambda t, c: ops.prefilter(cs[0], 0.25, c, t, bitmap[0], 200,
                                    qm[0]), (holes, codes), (lens, pk)),
        (lambda t, c: (ops.bitfilter_batched(bits, c, t),),
         (holes, codes), (lens, pk)),
        (lambda t, c: (ops.cinter_batched(cs_t, c, t, qm),),
         (pholes, pcodes), (plens, ppk)),
        (lambda t, c, r: (ops.pqscore_batched(cs_t, lut, c, r, t, 0.25, qm),),
         (pholes, pcodes, res), (plens, ppk, pres)),
        (lambda t, c, r: ops.pqinter_batched(cs_t, lut, c, r, t, 0.25, 60, 20,
                                             qm),
         (pholes, pcodes, res), (plens, ppk, pres)),
        (lambda t, c, r: ops.pqinter(cs_t[0], lut[0], c[0], r[0], t[0], 0.25,
                                     60, 20, qm[0]),
         (pholes, pcodes, res), (plens, ppk, pres)),
    ]
    for fn, holey, compacted in pairs:
        got = fn(*holey)
        torch.cuda.synchronize()
        _same(got, fn(*compacted))


def _off_alignment(x):
    """A contiguous copy of x whose storage starts one element past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 4, 7, 8, 12, 16, 32])
@pytest.mark.parametrize("nb", [1, 3, 32, 40])
@pytest.mark.parametrize("cap", [10, 33, 80, 200])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sbar_pass_stress(card, n_q, nb, cap, aligned, dtype):
    seed = nb * 1000 + n_q * 10 + cap
    lens = sorted({n for n in (0, 1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 127,
                               128, 129, cap - 1, cap) if n <= cap})
    cs_t, lut, codes, res, mask, qm = pqinter_inputs(
        seed, nb, n_q, 300, SBAR_DOCS[nb], cap, 4, 16, lens=lens)
    cs_t = (_bf16(card, bf16_edges(seed, cs_t)) if dtype == "bfloat16"
            else _on(card, cs_t)[0])
    if not aligned:
        cs_t = _off_alignment(cs_t)
        assert cs_t.data_ptr() % 16 != 0
    lut, codes, res, mask, qm = _on(card, lut, codes, res, mask, qm)
    lens = mask.sum(-1, dtype=torch.int32)
    n_docs = min(SBAR_DOCS[nb], 50)
    th_r = BF16_TH_R if dtype == "bfloat16" else 0.25
    for q in (qm, None):
        before = (kci.launches, kpq.launches)
        sbar = ops.cinter_batched(cs_t, codes, lens, q)
        got = ops.pqinter_batched(cs_t, lut, codes, res, lens, th_r, n_docs,
                                  10, q)
        torch.cuda.synchronize()
        assert (kci.launches, kpq.launches) == (before[0] + 1, before[1] + 1)
        _same((sbar,), (kci.cinter_batched_ref(cs_t, codes, lens, q),))
        _same(got, kpq.pqinter_batched_ref(cs_t, lut, codes, res, lens, th_r,
                                           n_docs, 10, q))


# --- timelines, their merges and growth on the card --------------------------

TL_WIDTHS = dict(n_docs=3000, cap=16, min_len=6, d=32, n_centroids=512, m=4,
                 nbits=4, list_cap=None)
TL_ENGINE = dict(n_q=16, nprobe=4, th=0.4, th_r=0.5, n_filter=128, n_docs=32,
                 k=10)
TL_LANES = {"fused": dict(use_kernels=True),
            "unfused": dict(use_kernels=True, fused_prefilter=False,
                            fused_late_interaction=False)}


def _moved(index, dev):
    return index._replace(**{f: getattr(index, f).to(dev)
                             for f in index._fields})


def _cpu_timeline():
    """A planted base and two generations encoded on the CPU (the second
    grown by add_passages), with queries planted on all three."""
    from repro_torch.core import store as tstore
    from repro_torch.data import synthetic
    index, meta = synthetic.make_packed_index(0, device="cpu", **TL_WIDTHS)
    tl = tstore.ShardedTimeline.of((index, meta))
    qs = [synthetic.make_queries(index, 1, 6, TL_ENGINE["n_q"])[0]]
    for seed in (2, 3):
        a, la = synthetic.make_raw_docs(index, seed, 300,
                                        TL_WIDTHS["min_len"])
        gen = tstore.new_generation(index, meta, a[:240].numpy(),
                                    la[:240].numpy(), device="cpu")
        tl = tl.append(*tstore.add_passages(*gen, a[240:].numpy(),
                                            la[240:].numpy(), device="cpu"))
        qs.append(synthetic.make_raw_queries(a, la, seed, 5,
                                             TL_ENGINE["n_q"])[0])
    return tl, torch.cat(qs)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(TL_LANES))
@pytest.mark.parametrize("nb", [1, 16])
def test_timeline_on_card_equals_plain(card, lane, nb):
    """retrieve_timeline's kernels on the card == their plain versions on
    the CPU, through the whole timeline: the same CS and LUT (made on the
    card) go into both runs, ids and score bits equal; the merged
    generations 1-2 retrieve as the pair did under lossless budgets; the
    generations survive a save/load round trip on the card."""
    import dataclasses
    import tempfile

    from repro_torch.core import engine as teng
    from repro_torch.core import store as tstore
    tl_cpu, q = _cpu_timeline()
    tl = tstore.ShardedTimeline(tuple(_moved(g, card)
                                      for g in tl_cpu.generations),
                                tl_cpu.metas)
    q = q[:nb]
    cfg = teng.EngineConfig(**TL_ENGINE, **TL_LANES[lane])
    g0 = tl.generations[0]
    cs = teng.centroid_scores(q.to(card), g0.centroids)
    lut = teng._query_lut(g0, q.to(card))
    before = dict(ops.launch_counts())
    got = teng._timeline_topk(tl, q.to(card), cfg, None, None,
                              lambda _: (cs, lut))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert sum(launched.values()) == len(tl) * (3 if lane == "fused" else 5)
    want = teng._timeline_topk(tl_cpu, q, cfg, None, None,
                               lambda _: (cs.cpu(), lut.cpu()))
    _same((got.doc_ids.cpu(), got.scores.cpu()),
          (want.doc_ids, want.scores))
    pair = tstore.ShardedTimeline(tl.generations[1:], tl.metas[1:])
    merged = tstore.merge_generations(tl, 1, 3)
    one = tstore.ShardedTimeline(merged.generations[1:], merged.metas[1:])
    lossless = dataclasses.replace(cfg, n_filter=600, n_docs=600,
                                   cand_cap=600)
    a = teng.retrieve_timeline(pair, q.to(card), lossless)
    b = teng.retrieve_timeline(one, q.to(card), lossless)
    _same((a.doc_ids, a.scores), (b.doc_ids, b.scores))
    with tempfile.TemporaryDirectory() as tmp:
        back = tstore.load_timeline(tstore.save_timeline(tmp, pair))
        assert back.fingerprints == pair.fingerprints
        assert all(torch.equal(getattr(x, f), getattr(y, f))
                   for x, y in zip(back.generations, pair.generations)
                   for f in x._fields)


@pytest.fixture
def smoke(card, monkeypatch):
    """chip_smoke.py at a tiny width: its timeline phase's holds, run as
    the script runs them."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "MIN_LEN", TL_WIDTHS["min_len"])
    monkeypatch.setattr(chip_smoke, "ENGINE", TL_ENGINE)
    monkeypatch.setattr(chip_smoke, "GEN_DOCS", 300)
    monkeypatch.setattr(chip_smoke, "GEN2_OPEN", 200)
    monkeypatch.setattr(chip_smoke, "ENCODE_HOLD", (40, 10))
    monkeypatch.setattr(chip_smoke, "MERGE_BUDGETS",
                        dict(n_filter=600, n_docs=600, cand_cap=600))
    monkeypatch.setattr(chip_smoke, "N_SINGLE", 4)
    monkeypatch.setitem(chip_smoke.RECORD, "device",
                        {"nvidia_smi": "pytest -m cuda"})
    return chip_smoke


@pytest.mark.cuda
def test_encode_on_card_equals_cpu_except_near_ties(smoke, card):
    from repro_torch.data import synthetic
    widths = {k: v for k, v in TL_WIDTHS.items() if k != "min_len"}
    index, meta = synthetic.make_packed_index(
        0, min_len=TL_WIDTHS["min_len"], device=card, **widths)
    from repro_torch.core import store as tstore
    a, la, b, lb = (t.cpu().numpy() for seed in (2, 3)
                    for t in synthetic.make_raw_docs(index, seed, 300,
                                                     TL_WIDTHS["min_len"]))
    g1 = tstore.new_generation(index, meta, a, la)
    g2 = tstore.add_passages(
        *tstore.new_generation(index, meta, b[:200], lb[:200]), b[200:],
        lb[200:])
    out = smoke.encode_hold(index, meta, g1, g2, a, la, b, lb)
    assert out["docs"] == 50 and out["max_gap"] <= out["near_tie_eps"]


@pytest.mark.cuda
def test_timeline_phase_on_card(smoke, card):
    """The timeline phase of chip_smoke.py at a tiny width on the card:
    every hold in it (encode against the CPU, each generation's kernels
    against their plain versions, unfused == fused, the merge, the round
    trip) passes."""
    import dataclasses

    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    widths = {k: v for k, v in TL_WIDTHS.items() if k != "min_len"}
    index, meta = synthetic.make_packed_index(
        0, min_len=TL_WIDTHS["min_len"], device=card, **widths)
    queries, gt = synthetic.make_queries(index, 1, 64, TL_ENGINE["n_q"])
    cfg = teng.EngineConfig(**TL_ENGINE, use_kernels=True)
    out = smoke.timeline_phase(dict(
        index=index, meta=meta, cfg=cfg, queries=queries, gt=gt,
        ucfg=dataclasses.replace(cfg, fused_prefilter=False,
                                 fused_late_interaction=False)))
    assert len(out["timeline"]) == 3 and len(out["merged"]) == 2


@pytest.mark.cuda
def test_build_index_on_card_matches_cpu(card):
    """build_index on the card against the CPU from one seed: the same
    deterministic fields, retrieval quality within 0.05 MRR@10, and two
    card builds with one fingerprint."""
    from repro_torch.core import build_index, index_fingerprint
    from repro_torch.core import engine as teng
    from repro_torch.data.synthetic import make_corpus, mrr_at_k
    c = make_corpus(3, n_docs=800, cap=24, min_len=8, n_queries=32,
                    n_topics=32)
    kw = dict(n_centroids=128, m=8, nbits=4, kmeans_iters=3)
    cpu, cm = build_index(0, c.doc_embs, c.doc_lens, device="cpu", **kw)
    dev, dm = build_index(0, c.doc_embs, c.doc_lens, device=card, **kw)
    again, _ = build_index(0, c.doc_embs, c.doc_lens, device=card, **kw)
    assert index_fingerprint(dev) == index_fingerprint(again)
    for f in ("n_docs", "cap", "n_raw_tokens", "doc_budget", "pred_names"):
        assert getattr(dm, f) == getattr(cm, f)
    assert all(getattr(dev, f).device.type == "cuda" for f in dev._fields)
    cfg = teng.EngineConfig(nprobe=8, th=0.2, th_r=0.4, n_filter=128,
                            n_docs=48, k=10, use_kernels=True)
    mrr = [mrr_at_k(teng.retrieve(i, c.queries, cfg, device=d).doc_ids
                    .cpu().numpy(), c.gt_doc)
           for i, d in ((cpu, "cpu"), (dev, card))]
    assert mrr[1] >= mrr[0] - 0.05, mrr


@pytest.mark.cuda
def test_kmeans_update_is_deterministic_on_card(card):
    from repro_torch.core import kmeans
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(200_000, 128, generator=g, device=card)
    a = torch.randint(0, 4096, (200_000,), generator=g, device=card)
    one, two = (kmeans._update(x, a, 4100, x[:4100], kmeans.generator(1))
                for _ in range(2))
    assert torch.equal(one.view(torch.int32), two.view(torch.int32))
    cpu = kmeans._update(x.cpu(), a.cpu(), 4100, x[:4100].cpu(),
                         kmeans.generator(1))
    assert torch.allclose(one.cpu(), cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(TL_LANES))
def test_service_on_card_equals_retrieve_timeline(card, lane):
    """RetrievalService on the card: every ticket and query() result equals
    retrieve_timeline on the card (same padded batch), cold and warm, and
    the warm pass launches the kernels for the open generation only."""
    from repro_torch.core import engine as teng
    from repro_torch.core import store as tstore
    from repro_torch.serving import RetrievalService, pad_query
    tl_cpu, q = _cpu_timeline()
    tl = tstore.ShardedTimeline(tuple(_moved(g, card)
                                      for g in tl_cpu.generations),
                                tl_cpu.metas)
    cfg = teng.EngineConfig(**TL_ENGINE, **TL_LANES[lane])
    svc = RetrievalService(tl, cfg, max_batch=8)
    qs = [x[:8 + i % 9] for i, x in enumerate(q.numpy())]
    padded = [pad_query(x, TL_ENGINE["n_q"]) for x in qs[:8]]
    want = teng.retrieve_timeline(tl, np.stack([p[0] for p in padded]), cfg,
                                  np.stack([p[1] for p in padded]))
    for rnd in range(2):
        before = dict(ops.launch_counts())
        tickets = [svc.submit(x) for x in qs[:8]]
        launched = sum(v - before[k] for k, v in ops.launch_counts().items())
        per = 3 if lane == "fused" else 5
        assert launched == per * (len(tl) if rnd == 0 else 1)
        for i, t in enumerate(tickets):
            s, ids = t.result()
            assert np.array_equal(ids, want.doc_ids[i].cpu().numpy())
            assert np.array_equal(s.view(np.uint32),
                                  want.scores[i].cpu().numpy().view(np.uint32))
    got = svc.query(q.numpy())
    ref = teng.retrieve_timeline(tl, q.numpy(), cfg)
    _same((got.doc_ids, got.scores), (ref.doc_ids, ref.scores))


@pytest.mark.cuda
def test_index_build_and_serving_phases_on_card(smoke, card, monkeypatch):
    """The index_build and serving phases of chip_smoke.py at a tiny width
    on the card, after the timeline phase they serve: every hold passes."""
    import dataclasses

    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    widths = {k: v for k, v in TL_WIDTHS.items() if k != "min_len"}
    for name, value in (("BUILD_DOCS", 400), ("BUILD_HOLD", 16),
                        ("MIN_TRAIN_TOKENS", 1000), ("SWAP_DOCS", 64),
                        ("ADD_DOCS", 32), ("DRIFT_DOCS", 300),
                        ("BUILD", dict(n_centroids=widths["n_centroids"],
                                       m=widths["m"], nbits=widths["nbits"],
                                       plaid_b=2, list_cap=None,
                                       kmeans_iters=3, pq_train_size=2000))):
        monkeypatch.setattr(smoke, name, value)
    index, meta = synthetic.make_packed_index(
        0, min_len=TL_WIDTHS["min_len"], device=card, **widths)
    queries, gt = synthetic.make_queries(index, 1, 64, TL_ENGINE["n_q"])
    cfg = teng.EngineConfig(**TL_ENGINE, use_kernels=True)
    ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                               fused_late_interaction=False)
    full = dict(index=index, meta=meta, cfg=cfg, ucfg=ucfg, queries=queries,
                gt=gt)
    launches, results, _, _ = smoke.serve_lanes(
        index, {"fused": cfg, "unfused": ucfg}, queries, gt)
    full["held"], full["held_u"], _ = smoke.hold_lanes(
        index, cfg, ucfg, queries, results)
    full["token_hist"] = smoke.token_hist(index)
    tlres = smoke.timeline_phase(full)
    filt = {"index": index._replace(pred_words=smoke.predicate_words(
        meta.n_docs, dict(enumerate(smoke.FILTER_PREDICATES.values())), 1,
        card))}
    build = smoke.index_build_phase(full)
    serve = smoke.serving_phase(full, filt, tlres)
    assert build["launches"]["fused"]["b32"]["prefilter"] == 2
    assert serve["launches"]["pqinter"] == 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_products_batch_invariant_on_card(card, dtype):
    """At 512 centroids, d = 32, n_q = 16 (where one product over the whole
    batch gave a query's CS row other bits in batches of 1, 16 and 17 than
    in a batch of 32) every CS and LUT element of a query is the same in
    any batch."""
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    index, _ = synthetic.make_packed_index(0, device=card, **TL_WIDTHS)
    q, _ = synthetic.make_queries(index, 1, 32, TL_ENGINE["n_q"])
    cs = teng.centroid_scores(q, index.centroids, dtype).view(torch.int16)
    lut = teng._query_lut(index, q).view(torch.int32)
    for b in (1, 2, 4, 8, 16, 17):
        for r in (slice(0, b), slice(32 - b, 32)):
            assert torch.equal(teng.centroid_scores(
                q[r], index.centroids, dtype).view(torch.int16), cs[r]), r
            assert torch.equal(teng._query_lut(index, q[r]).view(
                torch.int32), lut[r]), r


@pytest.mark.cuda
def test_plaid_explain_distributed_phases_on_card(smoke, card, monkeypatch,
                                                  tmp_path):
    """The invariance, explain, distributed (one NCCL rank; one gloo rank
    through the two-rank phase's rank function) and PLAID phases of
    chip_smoke.py at a tiny width on the card, after the phases they
    build on: every hold passes."""
    import dataclasses
    import json

    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    widths = {k: v for k, v in TL_WIDTHS.items() if k != "min_len"}
    for name, value in (("BUILD_DOCS", 400), ("BUILD_HOLD", 16),
                        ("MIN_TRAIN_TOKENS", 1000), ("SWAP_DOCS", 64),
                        ("ADD_DOCS", 32), ("DRIFT_DOCS", 300),
                        ("BUILD", dict(n_centroids=widths["n_centroids"],
                                       m=widths["m"], nbits=widths["nbits"],
                                       plaid_b=2, list_cap=None,
                                       kmeans_iters=3, pq_train_size=2000)),
                        ("WIDTHS", widths), ("CAND_CAP", 600),
                        ("DIST_DOCS", 2000), ("PLAID_SAMPLE_DOCS", 500),
                        ("PLAID_CFG", dict(k=10, n_docs=32, nprobe=4)),
                        ("INVARIANCE_WIDTHS", ())):
        monkeypatch.setattr(smoke, name, value)
    smoke._dist_rank(0, 1, str(tmp_path / "init"), str(tmp_path), "cuda")
    rank = json.loads((tmp_path / "rank0.json").read_text())
    assert all(rank["equal"].values())
    index, meta = synthetic.make_packed_index(
        0, min_len=TL_WIDTHS["min_len"], device=card, **widths)
    queries, gt = synthetic.make_queries(index, 1, 64, TL_ENGINE["n_q"])
    cfg = teng.EngineConfig(**TL_ENGINE, use_kernels=True)
    ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                               fused_late_interaction=False)
    full = dict(index=index, meta=meta, cfg=cfg, ucfg=ucfg, queries=queries,
                gt=gt)
    launches, results, _, _ = smoke.serve_lanes(
        index, {"fused": cfg, "unfused": ucfg}, queries, gt)
    full["held"], full["held_u"], _ = smoke.hold_lanes(
        index, cfg, ucfg, queries, results)
    full["token_hist"] = smoke.token_hist(index)
    smoke.invariance_phase(full)
    tlres = smoke.timeline_phase(full)
    filt = {"index": index._replace(pred_words=smoke.predicate_words(
        meta.n_docs, dict(enumerate(smoke.FILTER_PREDICATES.values())), 1,
        card))}
    build = smoke.index_build_phase(full)
    serve = smoke.serving_phase(full, filt, tlres)
    expl = smoke.explain_phase(full, filt, tlres, serve["fingerprints"])
    distr = smoke.distributed_phase(full, tlres, serve["fingerprints"],
                                    [rank])
    pl = smoke.plaid_phase(full, build)
    assert expl["launches"]["cinter"] == 9
    assert distr["launches"]["b32"]["prefilter"] == 2
    assert pl["launches"]["b32"]["cinter"] == 64


# --- the encoder and its trainer --------------------------------------------

ENC_WIDTH = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128,
                 vocab=300, out_dim=32)


def _enc_tokens(b: int, s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, ENC_WIDTH["vocab"], (b, s)))
    valid = torch.arange(s)[None] < torch.from_numpy(
        rng.integers(1, s + 1, b))[:, None]
    return tok, valid


@pytest.mark.cuda
def test_encode_on_card_matches_cpu(card):
    """One seed gives the same weights on both devices (CPU draws); the
    card's encode equals the CPU's at rtol 1e-5 / atol 1e-6 (unit vectors;
    float32 products in another order, TF32 off), zeros on padding."""
    from repro_torch.models import colbert
    cfg = colbert.make_config(**ENC_WIDTH)
    cpu = colbert.ColBERT(cfg, seed=3, device="cpu")
    gpu = colbert.ColBERT(cfg, seed=3, device=card)
    tok, valid = _enc_tokens(8, 24)
    with torch.no_grad():
        want = cpu(tok, valid)
        got = gpu(tok.to(card), valid.to(card)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert (got[~valid] == 0).all()


@pytest.mark.cuda
def test_encoder_batch_variance_on_card(card):
    """The elements of a query's embedding that differ between a batch of
    B and a batch of 32: printed (ROADMAP known limits), 0 for the same
    batch run twice, and within 1e-5 wherever they differ."""
    from repro_torch.models import colbert
    model = colbert.ColBERT(colbert.make_config(**ENC_WIDTH), seed=3,
                            device=card)
    tok, valid = _enc_tokens(32, 32, seed=1)
    tok, valid = tok.to(card), valid.to(card)
    with torch.no_grad():
        e32 = model(tok, valid)
        assert torch.equal(model(tok, valid).view(torch.int32),
                           e32.view(torch.int32))
        for b in (1, 16, 17, 32):
            e = model(tok[:b], valid[:b])
            diff = int((e.view(torch.int32) !=
                        e32[:b].view(torch.int32)).sum())
            print(f"B={b}: {diff} of {e.numel()} elements differ")
            assert float((e - e32[:b]).abs().max()) < 1e-5


@pytest.mark.cuda
def test_trainer_resume_on_card_is_bit_exact(card, tmp_path):
    """Three steps, a checkpoint, three more in a fresh Trainer: the same
    weights, bit for bit, as six steps in one run on the card."""
    from repro_torch.data import synthetic
    from repro_torch.models import colbert
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = colbert.make_config(**ENC_WIDTH)
    init = colbert.ColBERT(cfg, seed=3, device=card)
    pairs = synthetic.token_pairs(0, n_topics=12, words_per_topic=24,
                                  vocab=ENC_WIDTH["vocab"], batch=8,
                                  q_len=8, d_len=16)

    def trainer(ckpt_dir=None):
        return Trainer(lambda p, b: colbert.contrastive_loss(p, b, cfg),
                       optimizer.make("adamw", lr=3e-3), pairs,
                       TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=3,
                                     log_every=1), init, device=card)
    whole = trainer()
    wlog = whole.run(6)["log"]
    trainer(str(tmp_path)).run(3)
    resumed = trainer(str(tmp_path))
    rlog = resumed.run(6)["log"]
    assert [m["loss"] for m in rlog] == [m["loss"] for m in wlog[3:]]
    for a, b in zip(whole.state.params.parameters(),
                    resumed.state.params.parameters()):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_encoder_phase_on_card(smoke, card, monkeypatch, tmp_path):
    """chip_smoke.py's encoder phase at a tiny corpus and index, its
    training at full length (the loss falls over 200 steps, not 60):
    resume equals continuous, both lanes serve the encoded index with every
    kernel held."""
    import dataclasses

    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    widths = {k: v for k, v in TL_WIDTHS.items() if k != "min_len"}
    monkeypatch.setattr(smoke, "ENCODER", {
        **smoke.ENCODER, "jmpq_steps": 2, "docs": 400, "encode_batch": 128, "time_docs": 64, "time_reps": 2})
    monkeypatch.setattr(smoke, "COLBERTV2", {
        **smoke.COLBERTV2, "n_layers": 2})
    monkeypatch.setattr(smoke, "BUILD", dict(
        n_centroids=widths["n_centroids"], m=widths["m"],
        nbits=widths["nbits"], plaid_b=2, list_cap=None, kmeans_iters=3,
        pq_train_size=2000))
    monkeypatch.setattr(smoke, "WIDTHS", widths)
    monkeypatch.setitem(smoke.RECORD, "device", {"nvidia_smi": "test"})
    monkeypatch.setattr(smoke, "OUT_DIR", str(tmp_path))
    index, meta = synthetic.make_packed_index(
        0, min_len=TL_WIDTHS["min_len"], device=card, **widths)
    queries, gt = synthetic.make_queries(index, 1, 64, TL_ENGINE["n_q"])
    cfg = teng.EngineConfig(**TL_ENGINE, use_kernels=True)
    ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                               fused_late_interaction=False)
    full = dict(index=index, meta=meta, cfg=cfg, ucfg=ucfg, queries=queries,
                gt=gt)
    enc = smoke.encoder_phase(full)
    assert enc["launches"]["fused"]["b32"]["prefilter"] == 2
    assert smoke.RECORD["encoder_resume"]["bit_equal"]


# --- MIND x EMVB's operands and the recommender / graph steps ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 32])
@pytest.mark.parametrize("th_r", [None, 0.25])
def test_kernels_at_n_q_4_one_token_a_doc(card, nb, th_r):
    """The six kernels == their plain versions on MIND x EMVB's operands:
    n_q = 4 interest terms, one token a doc (cap 1, some docs empty),
    PQ m = 16 x 256 (d = 64), n_filter 4096, n_docs 1024, k 10; the 4-bit
    words tie F massively."""
    n_c, n_docs, nf = 2048, 60_001, 4096
    cs, codes, mask, bitmap, qm = _on(card, *prefilter_inputs(
        7 + nb, nb, 4, n_c, n_docs, 1, density=0.05))
    lens = mask.sum(-1, dtype=torch.int32)
    _same(ops.prefilter_batched(cs, 0.25, codes, lens, bitmap, nf, qm),
          kpf.prefilter_batched_ref(cs, 0.25, codes, lens, bitmap, nf, qm))
    bits = ops.bitpack_batched(cs, 0.25, qm)
    _same((bits,), (kbp.bitpack_batched_ref(cs, 0.25, qm),))
    _same((ops.bitfilter_batched(bits, codes, lens),),
          (kbf.bitfilter_batched_ref(bits, codes, lens),))
    cs_t, lut, pcodes, res, pmask, qm = _on(card, *pqinter_inputs(
        11 + nb, nb, 4, n_c, nf, 1, 16, 256))
    plens = pmask.sum(-1, dtype=torch.int32)
    _same(ops.pqinter_batched(cs_t, lut, pcodes, res, plens, th_r, 1024, 10,
                              qm),
          kpq.pqinter_batched_ref(cs_t, lut, pcodes, res, plens, th_r, 1024,
                                  10, qm))
    _same((ops.cinter_batched(cs_t, pcodes, plens, qm),),
          (kci.cinter_batched_ref(cs_t, pcodes, plens, qm),))
    _same((ops.pqscore_batched(cs_t, lut, pcodes, res, plens, th_r, qm),),
          (kps.pqscore_batched_ref(cs_t, lut, pcodes, res, plens, th_r, qm),))


def _step_bits(model, loss_fn, batch):
    """Loss, gradients and an Adagrad update of one step from ``model``'s
    state, as float32 bit patterns."""
    from repro_torch import models
    from repro_torch.core.precision import exact_matmuls
    from repro_torch.train import optimizer
    from repro_torch.train import trainer as ttrainer
    opt = optimizer.make("adagrad")
    params = models.to_reference_layout(model)
    with exact_matmuls():
        loss, grads = ttrainer._value_and_grad(loss_fn, model, batch)
        new, _ = opt.update(grads, opt.init(params), params)
    return [t.view(torch.int32).clone() for t in
            (loss, *grads.values(), *new.values())]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dcn-v2", "dien", "mind"])
def test_recsys_step_is_bit_equal_twice(card, arch):
    """A recommender's training step run twice from one state on one batch
    gives the same bits: the gathers' backward sorts, no float atomics."""
    from repro_torch.configs import registry
    from repro_torch.launch import train as tlaunch
    cfg = registry.get(arch).make_smoke_config()
    M = tlaunch._recsys_model(arch)
    model = M.init_params(0, cfg, card)
    batch = {k: v.to(card) for k, v in tlaunch.recsys_batch_fn(
        arch, cfg, batch=4096)(3).items()}

    def loss(p, b):
        return M.loss_fn(p, b, cfg)
    a, b = _step_bits(model, loss, batch), _step_bits(model, loss, batch)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_gcn_sampled_step_is_bit_equal_twice(card):
    """A sampled GCN step (the sampler on the card, segment sums over a
    stable sort) twice from one state on one batch: the same bits; and a
    full-graph step likewise."""
    from repro_torch.configs import gcn_cora
    from repro_torch.models import gcn, sampler
    cfg = gcn_cora.make_config("minibatch_lg")
    g = torch.Generator(device=card)
    g.manual_seed(0)
    n, md = 5000, 64
    nbr = torch.randint(0, n, (n, md), generator=g, device=card,
                        dtype=torch.int32)
    deg = torch.randint(0, md + 1, (n,), generator=g, device=card,
                        dtype=torch.int32)
    feats = torch.randn((n + 1, cfg.d_feat), generator=g, device=card)
    seeds = torch.randint(0, n, (1024,), generator=g, device=card)
    hops, blocks = sampler.sample_blocks(5, seeds, nbr, deg, [15, 10])
    batch = {"labels": torch.randint(0, cfg.n_classes, (1024,), device=card)}
    for i, h in enumerate(hops):
        batch[f"feats{i}"] = feats[torch.clamp(h.long(), max=n)]
    for i, blk in enumerate(blocks):
        batch[f"edges{i}"] = blk["edges"]
        batch[f"edge_mask{i}"] = blk["edge_mask"]
    model = gcn.init_params(0, cfg, card)

    def loss(p, b):
        return gcn.loss_fn_sampled(p, b, cfg)
    assert all(torch.equal(x, y) for x, y in zip(
        _step_bits(model, loss, batch), _step_bits(model, loss, batch)))
    cora = gcn_cora.make_config("full_graph_sm")
    model = gcn.init_params(1, cora, card)
    full = {"feats": torch.randn((2708, cora.d_feat), generator=g,
                                 device=card),
            "edges": torch.randint(0, 2708, (2, 10556), generator=g,
                                   device=card, dtype=torch.int32),
            "edge_mask": torch.ones(10556, dtype=torch.bool, device=card),
            "labels": torch.randint(0, 7, (2708,), device=card)}

    def full_loss(p, b):
        return gcn.loss_fn(p, b, cora)
    assert all(torch.equal(x, y) for x, y in zip(
        _step_bits(model, full_loss, full), _step_bits(model, full_loss,
                                                       full)))


@pytest.mark.cuda
def test_recsys_phase_on_card(smoke, card, monkeypatch):
    """chip_smoke.py's recsys phase at small widths on the card: every
    model's loss falls and resumes bit-equal; MIND x EMVB serves both lanes
    with each kernel held."""
    import dataclasses

    from repro_torch.configs import (dcn_v2, dien, dlrm_mlperf, gcn_cora,
                                     mind)
    small = tuple(min(v, 5000) for v in dlrm_mlperf.CRITEO_1TB_VOCABS)
    shapes = ("full_graph_sm", "minibatch_lg", "molecule")

    def configs():
        d = dlrm_mlperf.make_config()
        return {
            "mind": dataclasses.replace(mind.make_config(),
                                        vocab_items=20_000),
            "dcn": dataclasses.replace(dcn_v2.make_config(),
                                       vocab_sizes=small),
            "dlrm_pq": dataclasses.replace(dlrm_mlperf.make_config(
                use_pq_tables=True), vocab_sizes=small),
            "dlrm_train": dataclasses.replace(d, vocab_sizes=small),
            "dien": dataclasses.replace(dien.make_config(),
                                        vocab_items=20_000),
            "gcn": {s: gcn_cora.make_config(s) for s in shapes},
            "gcn_dims": {**{s: gcn_cora.SHAPES[s].dims for s in shapes},
                         "minibatch_lg": dict(gcn_cora.SHAPES[
                             "minibatch_lg"].dims, n_nodes=20_000)}}
    monkeypatch.setattr(smoke, "_recsys_configs", configs)
    monkeypatch.setattr(smoke, "RECSYS", {
        **smoke.RECSYS, "mind_batch": 1024, "train_batch": 4096,
        "serve": (512, 4096), "mind_centroids": 256, "time_reps": 2})
    monkeypatch.setattr(smoke, "GCN_GRAPH", {**smoke.GCN_GRAPH,
                                             "max_degree": 128})
    out = smoke.recsys_phase(card)
    assert out["launches"]["fused"]["b1"]["prefilter"] == \
        smoke.RECSYS["mind_singles"]
    for name in ("recsys_mind_train", "recsys_dcn", "recsys_dlrm",
                 "recsys_dien"):
        assert smoke.RECORD[name]["bit_equal"], name
    assert all(smoke.RECORD["recsys_gcn"][s]["bit_equal"] for s in shapes)


# --- the LM serving path -----------------------------------------------------

def _lm_smoke_configs(smoke):
    """chip_smoke's LM configs at a small width: granite's widths at two
    layers with the chunked path at 1,024 tokens, qwen2.5-3b's widths cut to
    one layer and a 4,096 vocabulary, the smoke configs as the script runs
    them."""
    import dataclasses
    full = smoke._lm_configs()
    return {
        "full": dataclasses.replace(full["full"], n_layers=2,
                                    attn_q_chunk=256, attn_kv_chunk=512,
                                    attn_chunk_min_seq=1024),
        "dense": dataclasses.replace(full["dense"], n_layers=1, vocab=4096,
                                     attn_q_chunk=256, attn_kv_chunk=512,
                                     attn_chunk_min_seq=1024),
        "smoke": full["smoke"]}


@pytest.mark.cuda
def test_granite_prefill_and_decode_are_bit_equal_twice(card):
    """granite-moe-1b-a400m's widths (bf16, 32 experts top-8) at two layers:
    a chunked prefill of 2 x 8,192 tokens and a decode step over its cache,
    each run twice, give the same bits (no atomics in the experts'
    scatter-add back to tokens)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer
    cfg = dataclasses.replace(registry.get(
        "granite-moe-1b-a400m").make_config(), n_layers=2)
    model = transformer.init_params(0, cfg, card)
    g = torch.Generator(device=card)
    g.manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 8192), generator=g, device=card)
    runs = [transformer.prefill(model, tok, cfg) for _ in range(2)]
    (la, ca), (lb, cb) = runs
    assert torch.equal(la.view(torch.int16), lb.view(torch.int16))
    assert torch.equal(ca.k.view(torch.int16), cb.k.view(torch.int16))
    assert torch.equal(ca.v.view(torch.int16), cb.v.view(torch.int16))
    nxt = la.argmax(-1)
    steps = []
    for c in (ca, cb):
        cache = transformer.init_cache(cfg, 2, 8200, card)
        cache.k[:, :, :8192] = c.k
        cache.v[:, :, :8192] = c.v
        steps.append(transformer.decode_step(model, cache, nxt, 8192, cfg))
    (da, xa), (db, xb) = steps
    assert torch.equal(da.view(torch.int16), db.view(torch.int16))
    assert torch.equal(xa.k.view(torch.int16), xb.k.view(torch.int16))
    assert torch.isfinite(da.float()).all()


@pytest.mark.cuda
def test_lm_smoke_configs_on_card_match_cpu(smoke, card):
    """The granite and kimi smoke configs (float32, chunked path forced):
    prefill and four decode steps on the card equal the CPU's at rtol 1e-5
    with the same routed expert ids; the grouped dispatch equals the
    capacity gather at ample capacity (chip_smoke's check (d))."""
    out = smoke.lm_card_vs_cpu(card, "test")
    for arch in smoke.LM["smoke_archs"]:
        assert out[arch]["routed_ids_equal"]
        assert out[arch]["route_calls"] == 2 * (1 + smoke.LM["smoke_steps"])


@pytest.mark.cuda
def test_lm_phase_on_card(smoke, card, monkeypatch):
    """chip_smoke.py's lm phase at a small width on the card: every check
    of (a)-(e) holds and no hand-written kernel launches."""
    configs = _lm_smoke_configs(smoke)
    monkeypatch.setattr(smoke, "_lm_configs", lambda: configs)
    monkeypatch.setattr(smoke, "LM", {
        **smoke.LM, "prefill_seq": 2048, "cache_seq": 2060,
        "decode_steps": 4, "decode_batch": 8, "decode_seq": 2048,
        "decode_reps": 2, "route_reps": 1, "dense_seq": 1024,
        "dense_steps": 4})
    monkeypatch.setitem(smoke.RECORD, "device", {"nvidia_smi": "test"})
    out = smoke.lm_phase(card)
    assert set(out["launches"].values()) == {0}
    assert smoke.RECORD["lm_determinism"]["prefill_bit_equal"]
    assert smoke.RECORD["lm_dense_consistency"]["argmax_equal"]
    for arch in smoke.LM["smoke_archs"]:
        assert smoke.RECORD["lm_train"][arch]["bit_equal"]


def _small_emvb_spec(n_docs: int, cap: int, d: int, n_c: int, m: int,
                     list_cap: int):
    """The registry's emvb-msmarco entry at a small width."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.emvb_msmarco import EMVBProdConfig
    spec = registry.get("emvb-msmarco")
    engine = dataclasses.replace(spec.make_config().engine, n_filter=256,
                                 n_docs=64, k=10)
    return dataclasses.replace(spec, make_config=lambda: EMVBProdConfig(
        n_docs=n_docs, doc_cap=cap, d=d, n_centroids=n_c, m=m, nbits=8,
        list_cap=list_cap, engine=engine))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["serve_b32", "serve_b1"])
def test_retrieval_cell_on_one_card_equals_retrieve(card, shape, tmp_path):
    """The dry run's retrieval cell on the 1 x 1 mesh: its step (the
    sharded plan at one NCCL rank) on a planted index equals retrieve in
    ids and score bits through the fused kernels, one launch each; the
    real arguments hold the reckoned argument bytes exactly and the cell's
    leaves."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.launch import op_stats, serve, steps
    from repro_torch.launch.mesh import single_card_mesh
    w = dict(n_docs=20_000, cap=40, d=64, n_centroids=1024, m=16,
             list_cap=1024)
    spec = _small_emvb_spec(w["n_docs"], w["cap"], w["d"], w["n_centroids"],
                            w["m"], w["list_cap"])
    index, _ = synthetic.make_packed_index(0, min_len=20, nbits=8,
                                           device=card, **w)
    queries, _ = synthetic.make_queries(index, 1, 32, 32)
    cell = steps.build_cell(spec, shape, single_card_mesh())
    q = queries[:cell.dims["query_batch"]].clone()
    cfg = dataclasses.replace(spec.make_config().engine, use_kernels=True)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        stacked = serve.shard_index(index, 1)
        args = (stacked, q)
        assert {p: (tuple(t.shape), t.dtype) for p, t in
                steps.leaves(args).items()} == {
            p: (tuple(t.shape), t.dtype)
            for p, t in steps.leaves(cell.args).items()}
        ops.reset_launches()
        got = cell.fn(*args)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launch_counts().items() if v} == {
            "prefilter": 1, "pqinter": 1, "topnprobe": 1}
        want = teng.retrieve(index, q, cfg)
        assert torch.equal(got.doc_ids, want.doc_ids)
        assert torch.equal(got.scores.view(torch.int32),
                           want.scores.view(torch.int32))
        held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in op_stats.tensors(args)}
        assert sum(held.values()) == op_stats.argument_bytes(cell)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_lm_cell_on_one_card_counts_as_on_meta(card):
    """granite's decode cell at its smoke config on the 1 x 1 mesh: the
    FLOPs counted on the card equal those counted on meta, the reckoned
    argument bytes the bytes the real arguments hold, and a train cell's
    step gives the same bits twice."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import op_stats, steps
    from repro_torch.launch.mesh import single_card_mesh
    from repro_torch.models import to_reference_layout
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainState
    spec = registry.get("granite-moe-1b-a400m")
    shapes = {"long_500k": dataclasses.replace(
        spec.shapes["long_500k"], dims={"seq": 4096, "batch": 1}),
        "train_4k": dataclasses.replace(spec.shapes["train_4k"],
                                        dims={"seq": 256, "batch": 4})}
    spec = dataclasses.replace(spec, make_config=spec.make_smoke_config,
                               shapes=shapes)
    mesh = single_card_mesh()
    cell = steps.build_cell(spec, "long_500k", mesh)
    model = T.init_params(3, cell.cfg, card)
    g = torch.Generator(device=card).manual_seed(5)
    cache = T.KVCache(*(torch.randn(t.shape, generator=g, device=card,
                                    dtype=t.dtype) for t in cell.args[1]))
    token = torch.randint(0, cell.cfg.vocab, (1,), generator=g, device=card,
                          dtype=torch.int32)
    pos = torch.tensor(4095, dtype=torch.int32, device=card)
    args = (model, cache, token, pos)
    assert op_stats.count(cell.fn, args)["flops"] == \
        op_stats.global_counts(cell)["flops"]
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in op_stats.tensors(args)}
    assert sum(held.values()) == op_stats.argument_bytes(cell)

    cell = steps.build_cell(spec, "train_4k", mesh)
    opt = steps._optimizer_for(cell.spec)
    tok = torch.randint(0, cell.cfg.vocab, (4, 256), generator=g,
                        device=card, dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    runs = []
    for _ in range(2):
        m = T.init_params(3, cell.cfg, card)
        state = TrainState(torch.zeros((), dtype=torch.int32, device=card),
                           m, opt.init(to_reference_layout(m)))
        state, metrics = cell.fn(state, batch)
        runs.append((to_reference_layout(m), metrics["loss"]))
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])


# --- the engine's stream-timed phase spans on the card ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(TL_LANES))
def test_phase_spans_stream_time_on_card(card, lane):
    """Under a tracer, ``retrieve``'s three phase spans (and on the fused
    lane the two inside ``engine.late``) carry a positive ``stream_ms``
    once the ring is drained, the host spans none, the phases' stream times
    sum to no more than the call's wall time, and the inner two to no more
    than ``engine.late``'s."""
    import time

    from repro_torch import obs
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    index, _ = synthetic.make_packed_index(0, device=card, **TL_WIDTHS)
    q, _ = synthetic.make_queries(index, 1, 32, TL_ENGINE["n_q"])
    cfg = teng.EngineConfig(**TL_ENGINE, **TL_LANES[lane])
    want = teng.retrieve(index, q, cfg)
    torch.cuda.synchronize()
    with obs.tracing() as tr:
        t0 = time.perf_counter()
        got = teng.retrieve(index, q, cfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        spans = tr.drain()
    assert torch.equal(got.doc_ids, want.doc_ids)
    assert torch.equal(got.scores.view(torch.int32),
                       want.scores.view(torch.int32))
    phases = ("engine.candgen", "engine.prefilter", "engine.late")
    late = (("engine.late.gather", "engine.late.pqinter") if lane == "fused"
            else ())
    timed = [s for s in spans if "stream_ms" in s]
    assert [s["name"] for s in timed] == list(phases[:2] + late + phases[2:])
    assert all(s["stream_ms"] > 0 for s in timed)
    ms = {s["name"]: s["stream_ms"] for s in timed}
    assert sum(ms[p] for p in phases) <= wall_ms
    assert sum(ms[p] for p in late) <= ms["engine.late"]
    (wait,) = [s for s in spans if s["name"] == "engine.candgen.bitmap_wait"]
    assert wait["attrs"]["postings"] > 0
