"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the
reference's Pallas kernels in interpret mode, as tests/test_kernels.py runs
them. On the CPU the wrappers run the kernels' plain PyTorch versions; the
outputs must be bit-exact: ids, int scores, bit words (as uint32), F, sel2,
and the float32 bits of S̄ and the final scores.

The fused megakernels (prefilter, pqinter) and the unfused lane's kernels
(bitpack, bitfilter, cinter, pqscore) are covered; batched forms of the
unfused kernels are held row by row against the single-query Pallas kernel.
Inputs (``torch_inputs.py``) are tie-heavy, ragged (sizes that are no
multiple of any block: ``DEFAULT_BC`` 512, ``DEFAULT_BD`` 256 / 128 / 32),
with dead query terms, and with ``th_r`` both None and set.
tests/test_torch_cuda.py holds the CUDA kernels against the same plain
versions on the card.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pqinter as tpqinter
from repro_torch.kernels import prefilter as tprefilter
from torch_inputs import lit_row_words
from torch_inputs import pqinter_inputs as _pqinter_inputs
from torch_inputs import prefilter_inputs as _prefilter_inputs

torch.set_num_threads(1)


def _u32(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def _eq(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(_u32(p.cpu().numpy()), _u32(r))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("nb,n_q,n_c,n_docs,cap,n_filter", [
    (3, 32, 200, 300, 12, 64),      # 300 docs: ragged against block 256
    (2, 16, 130, 517, 9, 100),
    (4, 32, 64, 90, 6, 90),         # n_filter == n_docs: the whole corpus
])
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_batched_matches_pallas(nb, n_q, n_c, n_docs, cap,
                                          n_filter, masked):
    cs, codes, mask, bitmap, qm = _prefilter_inputs(
        n_docs, nb, n_q, n_c, n_docs, cap)
    qm = qm if masked else None
    ref = rops.prefilter_batched(*_j(cs), 0.25, *_j(codes, mask, bitmap),
                                 n_filter, None if qm is None
                                 else jnp.asarray(qm), interpret=True)
    before = tprefilter.launches
    port = tops.prefilter_batched(*_t(cs), 0.25, *_t(codes, mask, bitmap),
                                  n_filter, None if qm is None
                                  else torch.from_numpy(qm))
    assert tprefilter.launches == before       # the CPU runs no kernel
    _eq(port, ref)


EDGE_LENS = (0, 1, 31, 32, 33, 80)   # a round's and a chunk's edges at cap 80


@pytest.mark.parametrize("nb,n_c,n_docs,cap,n_filter,density,lens", [
    (3, 200, 600, 12, 64, 0.02, None),     # most docs no query's candidate
    (2, 130, 300, 33, 64, 0.6, None),      # a second round of tokens
    (2, 200, 300, 80, 100, 0.3, EDGE_LENS),
])
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_stress_matches_pallas(nb, n_c, n_docs, cap, n_filter,
                                         density, lens, masked):
    cs, codes, mask, bitmap, qm = _prefilter_inputs(
        n_docs + cap, nb, 32, n_c, n_docs, cap, density=density, lens=lens)
    qm = qm if masked else None
    ref = rops.prefilter_batched(*_j(cs), 0.25, *_j(codes, mask, bitmap),
                                 n_filter, None if qm is None
                                 else jnp.asarray(qm), interpret=True)
    port = tops.prefilter_batched(*_t(cs), 0.25, *_t(codes, mask, bitmap),
                                  n_filter, None if qm is None
                                  else torch.from_numpy(qm))
    _eq(port, ref)


def test_prefilter_single_query_matches_pallas():
    cs, codes, mask, bitmap, qm = _prefilter_inputs(5, 1, 32, 160, 270, 10)
    ref = rops.prefilter(*_j(cs[0]), 0.5, *_j(codes, mask, bitmap[0]), 50,
                         jnp.asarray(qm[0]), interpret=True)
    port = tops.prefilter(*_t(cs[0]), 0.5, *_t(codes, mask, bitmap[0]), 50,
                          torch.from_numpy(qm[0]))
    _eq(port, ref)


@pytest.mark.parametrize("nb,n_q,n_c,nf,cap,m,ksub,n_docs,k", [
    (3, 32, 100, 70, 10, 8, 16, 20, 7),     # ragged nf and n_docs
    (2, 16, 64, 40, 7, 4, 256, 40, 40),     # n_docs == nf, k == n_docs
    # term counts whose last group of 8 is ragged on the card
    (2, 9, 100, 50, 12, 16, 256, 20, 7),
    (2, 17, 80, 40, 10, 8, 16, 16, 5),
    (3, 24, 90, 45, 9, 5, 7, 25, 10),
])
@pytest.mark.parametrize("th_r", [None, 0.25])
@pytest.mark.parametrize("masked", [False, True])
def test_pqinter_batched_matches_pallas(nb, n_q, n_c, nf, cap, m, ksub,
                                        n_docs, k, th_r, masked):
    cs_t, lut, codes, res, mask, qm = _pqinter_inputs(
        nf + cap, nb, n_q, n_c, nf, cap, m, ksub)
    qm = qm if masked else None
    ref = rops.pqinter_batched(*_j(cs_t, lut, codes, res, mask), th_r,
                               n_docs, k, None if qm is None
                               else jnp.asarray(qm), interpret=True)
    before = tpqinter.launches
    port = tops.pqinter_batched(*_t(cs_t, lut, codes, res, mask), th_r,
                                n_docs, k, None if qm is None
                                else torch.from_numpy(qm))
    assert tpqinter.launches == before
    _eq(port, ref)


@pytest.mark.parametrize("nb,nf,cap,m,ksub,n_docs,k,lens", [
    (2, 30, 33, 8, 16, 12, 5, None),
    (2, 24, 80, 16, 16, 10, 4, EDGE_LENS),
])
@pytest.mark.parametrize("th_r", [None, 0.25])
def test_pqinter_long_docs_match_pallas(nb, nf, cap, m, ksub, n_docs, k,
                                        lens, th_r):
    cs_t, lut, codes, res, mask, qm = _pqinter_inputs(
        nf + cap, nb, 32, 100, nf, cap, m, ksub, lens=lens)
    ref = rops.pqinter_batched(*_j(cs_t, lut, codes, res, mask), th_r,
                               n_docs, k, jnp.asarray(qm), interpret=True)
    port = tops.pqinter_batched(*_t(cs_t, lut, codes, res, mask), th_r,
                                n_docs, k, torch.from_numpy(qm))
    _eq(port, ref)


def test_pqinter_single_query_matches_pallas():
    cs_t, lut, codes, res, mask, qm = _pqinter_inputs(9, 1, 32, 90, 50, 8,
                                                      8, 16)
    ref = rops.pqinter(*_j(cs_t[0], lut[0], codes[0], res[0], mask[0]), 0.0,
                       16, 5, jnp.asarray(qm[0]), interpret=True)
    port = tops.pqinter(*_t(cs_t[0], lut[0], codes[0], res[0], mask[0]),
                        0.0, 16, 5, torch.from_numpy(qm[0]))
    _eq(port, ref)


def test_wrappers_refuse_out_of_slice_operands():
    """Every operand form of the reference is taken (filter plans, per-query
    codes, doc_pass); what is refused is a malformed one. pred_words without
    a plan is not read, as in the reference."""
    cs, codes, mask, bitmap, _ = _prefilter_inputs(0, 2, 8, 32, 40, 4)
    cs, codes, mask, bitmap = _t(cs, codes, mask, bitmap)
    tops.prefilter_batched(cs, 0.2, codes, mask, bitmap, 8,
                           pred_words=torch.zeros(40, dtype=torch.int32))
    with pytest.raises(ValueError, match="pred_words"):
        tops.prefilter(cs[0], 0.2, codes, mask, bitmap[0], 8, plan=())
    with pytest.raises(ValueError, match="pred_words"):
        tops.prefilter_batched(cs, 0.2, codes, mask, bitmap, 8, plan=(),
                               pred_words=torch.zeros(39, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        tops.prefilter_batched(cs, 0.2, codes[None].expand(3, -1, -1),
                               mask[None].expand(3, -1, -1), bitmap, 8)
    with pytest.raises(ValueError, match="expected"):
        tops.prefilter_batched(cs, 0.2, codes[None].expand(2, -1, -1),
                               mask, bitmap, 8)
    cs_t, lut, pcodes, res, pmask, _ = _t(*_pqinter_inputs(
        0, 2, 8, 32, 12, 4, 4, 16))
    with pytest.raises(ValueError, match="doc_pass"):
        tops.pqinter_batched(cs_t, lut, pcodes, res, pmask, None, 8, 4,
                             doc_pass=torch.ones(2, 11, dtype=torch.bool))


def test_token_mask_must_be_a_prefix():
    """A prefix mask is no longer required: a mask with holes is taken, its
    valid tokens moved to the front (``prefilter.valid_first``), and the
    result is the reference's on the mask as given."""
    cs, codes, mask, bitmap, _ = _prefilter_inputs(1, 1, 8, 32, 40, 4)
    holey = mask.copy()
    holey[0, 0], holey[0, -1] = False, True
    ref = rops.prefilter_batched(*_j(cs), 0.2, *_j(codes, holey, bitmap), 8,
                                 interpret=True)
    _eq(tops.prefilter_batched(*_t(cs), 0.2, *_t(codes, holey, bitmap), 8),
        ref)
    with pytest.raises(ValueError, match="does not lead"):
        tops.prefilter_batched(*_t(cs), 0.2, *_t(codes[:, :3], holey,
                                                 bitmap), 8)


def _no_launch(fn):
    """Run ``fn`` and check it launched no kernel (the CPU runs none)."""
    before = tops.launch_counts()
    out = fn()
    assert tops.launch_counts() == before
    return out


def _bit_words(seed, nb, n_c):
    """Sparse uint32 words with bit 31 set in some (int32-negative)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(nb, n_c), dtype=np.uint64)
    w &= rng.integers(0, 1 << 32, size=(nb, n_c), dtype=np.uint64)
    return w.astype(np.uint32)


def _row(qm, b):
    return None if qm is None else jnp.asarray(qm[b])


@pytest.mark.parametrize("nb,n_q,n_c", [
    (3, 32, 700),     # n_c ragged against block 512; bit 31 in use
    (2, 16, 130),     # less than one block
    (1, 7, 1024),     # whole blocks
])
@pytest.mark.parametrize("masked", [False, True])
def test_bitpack_matches_pallas(nb, n_q, n_c, masked):
    cs, _, _, _, qm = _prefilter_inputs(n_c, nb, n_q, n_c, 4, 2)
    qm = qm if masked else None
    tqm = None if qm is None else torch.from_numpy(qm)
    port = _no_launch(lambda: tops.bitpack_batched(*_t(cs), 0.25, tqm))
    assert port.dtype == torch.int32 and port.shape == (nb, n_c)
    for b in range(nb):
        _eq([port[b]], [rops.bitpack(*_j(cs[b]), 0.25, _row(qm, b),
                                     interpret=True)])
    single = tops.bitpack(*_t(cs[0]), 0.25, None if tqm is None else tqm[0])
    assert torch.equal(single, port[0])


# Word tables whose rows are lit (some bit set) at a share: the kernel
# gathers only lit rows. n_c = 200 and 130 are no multiple of 32.
LIT_ROWS = [pytest.param(nb, n_c, 300, 12, share,
                         id=f"{nb}-{n_c}-300-12-lit{share}")
            for nb in (1, 3, 32) for n_c, share in ((200, 0.02), (130, 0.0),
                                                     (200, 1.0))]


@pytest.mark.parametrize("nb,n_c,n_docs,cap,lit_share", [
    pytest.param(3, 200, 300, 12, None, id="3-200-300-12"),  # 300 docs:
    pytest.param(2, 130, 517, 9, None, id="2-130-517-9"),    # ragged against
    pytest.param(1, 64, 256, 5, None, id="1-64-256-5"),      # block 256
    *LIT_ROWS,
])
@pytest.mark.parametrize("as_lengths", [False, True])
def test_bitfilter_matches_pallas(nb, n_c, n_docs, cap, lit_share,
                                  as_lengths):
    _, codes, mask, _, _ = _prefilter_inputs(n_docs, 1, 1, n_c, n_docs, cap)
    bits = (_bit_words(n_docs + cap, nb, n_c) if lit_share is None
            else lit_row_words(n_docs + nb, nb, n_c, lit_share))
    lit = (bits != 0).any(0)
    if lit_share == 0.0:
        assert not lit.any()
    elif lit_share == 1.0:
        assert lit.all()
    elif lit_share is not None:
        assert 0 < lit.mean() < 0.1
    validity = mask.sum(-1).astype(np.int32) if as_lengths else mask
    port = _no_launch(lambda: tops.bitfilter_batched(
        *_t(bits.view(np.int32), codes, validity)))
    assert port.dtype == torch.int32 and port.shape == (nb, n_docs)
    for b in range(nb):
        _eq([port[b]], [rops.bitfilter(*_j(bits[b], codes, mask),
                                       interpret=True)])
    single = tops.bitfilter(*_t(bits[0].view(np.int32), codes, mask))
    assert torch.equal(single, port[0])


# Lengths at the edges of the kernels' 8-warp token split, 0, 1 and cap.
SPLIT_LENS = (0, 1, 7, 8, 9, 79, 80)


@pytest.mark.parametrize("nb,n_q,n_c,nd,cap,lens", [
    # 130 docs: ragged against block 128
    pytest.param(3, 32, 100, 130, 10, None, id="3-32-100-130-10"),
    # less than one block
    pytest.param(2, 16, 64, 70, 7, None, id="2-16-64-70-7"),
    # n_q 1 and 7: the card's S̄ pass runs one lane per term
    pytest.param(2, 1, 100, 40, 80, SPLIT_LENS, id="2-1-100-40-80-split_lens"),
    pytest.param(3, 7, 100, 40, 80, SPLIT_LENS, id="3-7-100-40-80-split_lens"),
])
@pytest.mark.parametrize("masked", [False, True])
def test_cinter_matches_pallas(nb, n_q, n_c, nd, cap, lens, masked):
    cs_t, _, codes, _, mask, qm = _pqinter_inputs(nd + cap, nb, n_q, n_c, nd,
                                                  cap, 2, 4, lens=lens)
    qm = qm if masked else None
    tqm = None if qm is None else torch.from_numpy(qm)
    port = _no_launch(lambda: tops.cinter_batched(*_t(cs_t, codes, mask),
                                                  tqm))
    assert port.dtype == torch.float32 and port.shape == (nb, nd)
    for b in range(nb):
        _eq([port[b]], [rops.cinter(*_j(cs_t[b], codes[b], mask[b]),
                                    _row(qm, b), interpret=True)])
    single = tops.cinter(*_t(cs_t[0], codes[0], mask[0]),
                         None if tqm is None else tqm[0])
    assert torch.equal(single.view(torch.int32), port[0].view(torch.int32))


@pytest.mark.parametrize("nb,n_q,n_c,nd,cap,m,ksub,lens", [
    pytest.param(3, 32, 100, 45, 10, 8, 16, None,      # 45 docs: ragged
                 id="3-32-100-45-10-8-16"),            # against block 32
    pytest.param(2, 16, 64, 70, 7, 4, 256, None, id="2-16-64-70-7-4-256"),
    # emvb-msmarco's shape: n_q 32, m 16, K 256, cap 80
    pytest.param(2, 32, 100, 24, 80, 16, 256, SPLIT_LENS,
                 id="2-32-100-24-80-16-256-split_lens"),
    # term counts whose last group of 8 is ragged on the card
    pytest.param(2, 9, 100, 24, 80, 16, 256, SPLIT_LENS,
                 id="2-9-100-24-80-16-256-split_lens"),
    pytest.param(2, 17, 100, 30, 33, 8, 16, None, id="2-17-100-30-33-8-16"),
    pytest.param(3, 24, 100, 40, 12, 5, 7, None, id="3-24-100-40-12-5-7"),
])
@pytest.mark.parametrize("th_r", [None, 0.25])
@pytest.mark.parametrize("masked", [False, True])
def test_pqscore_matches_pallas(nb, n_q, n_c, nd, cap, m, ksub, lens, th_r,
                                masked):
    cs_t, lut, codes, res, mask, qm = _pqinter_inputs(
        nd + m, nb, n_q, n_c, nd, cap, m, ksub, lens=lens)
    if lens is not None:
        assert set(mask.sum(-1).ravel()) == set(lens)
    qm = qm if masked else None
    tqm = None if qm is None else torch.from_numpy(qm)
    port = _no_launch(lambda: tops.pqscore_batched(
        *_t(cs_t, lut, codes, res, mask), th_r, tqm))
    assert port.dtype == torch.float32 and port.shape == (nb, nd)
    for b in range(nb):
        _eq([port[b]], [rops.pqscore(
            *_j(cs_t[b], lut[b], codes[b], res[b], mask[b]), th_r,
            _row(qm, b), interpret=True)])
    single = tops.pqscore(*_t(cs_t[0], lut[0], codes[0], res[0], mask[0]),
                          th_r, None if tqm is None else tqm[0])
    assert torch.equal(single.view(torch.int32), port[0].view(torch.int32))


@pytest.mark.parametrize("n_q,terms,m,ksub", [
    (1, 1, 16, 256), (7, 8, 16, 256), (8, 8, 16, 256), (9, 8, 16, 256),
    (17, 8, 8, 16), (32, 8, 16, 256),
    (32, 4, 32, 256),        # a slice of 8 terms would not fit: T = 4
    (17, 2, 5, 7), (9, 1, 3, 5),    # rows padded to 16-byte slices
    (32, 32, 16, 256), (3, 3, 5, 7),    # the L2 form's one group of n_q
])
def test_flat_lut_puts_each_entry_where_the_pass_reads_it(n_q, terms, m,
                                                          ksub):
    """lut[b, i, s, k] lies at [b, i // T, s * K + k, i % T] of the grouped
    layout, the element the Eq. 5/6 pass of group i // T reads for term
    i % T at code k of subspace s; the padding is zero. With T = n_q the
    layout is the L2 form's flat (B, m * K, n_q) table."""
    rng = np.random.default_rng(n_q * 100 + terms)
    nb = 3
    lut = rng.normal(size=(nb, n_q, m, ksub)).astype(np.float32)
    out = tpqinter.flat_lut(torch.from_numpy(lut), terms).numpy()
    groups = -(-n_q // terms)
    rows = tpqinter.lut_rows(m * ksub, terms)
    assert out.shape == (nb, groups, rows, terms)
    assert rows >= m * ksub
    if terms in (1, 2, 4, 8):     # the cluster pass stages 16-byte pieces
        assert (rows * terms) % 4 == 0
    # the pass's read: flat index ((b * G + g) * rows + s * K + k) * T + j
    b, i, sub, k = np.meshgrid(np.arange(nb), np.arange(n_q), np.arange(m),
                               np.arange(ksub), indexing="ij")
    at = (((b * groups + i // terms) * rows + sub * ksub + k) * terms
          + i % terms)
    np.testing.assert_array_equal(out.ravel()[at.ravel()], lut.ravel())
    pad = np.ones(out.size, bool)
    pad[at.ravel()] = False
    assert not out.ravel()[pad].any()
    if terms == n_q:
        np.testing.assert_array_equal(
            out.reshape(nb, m * ksub, n_q),
            lut.transpose(0, 2, 3, 1).reshape(nb, m * ksub, n_q))


def test_unfused_wrappers_refuse_out_of_slice_operands():
    cs_t, lut, codes, res, mask, _ = _t(*_pqinter_inputs(
        0, 2, 8, 32, 12, 4, 4, 16))
    with pytest.raises(ValueError, match="expected"):
        tops.bitfilter_batched(torch.zeros(3, 32, dtype=torch.int32), codes,
                               mask)
    with pytest.raises(ValueError, match="expected"):
        tops.bitfilter_batched(torch.zeros(2, 32, dtype=torch.int32), codes,
                               mask[0])
    holey = mask.clone()
    holey[0, 0, 0], holey[0, 0, -1] = False, True
    with pytest.raises(ValueError, match="does not lead"):
        tops.cinter_batched(cs_t, codes[..., :3], holey)
    with pytest.raises(ValueError, match="does not lead"):
        tops.pqscore_batched(cs_t, lut, codes, res[..., :3, :], holey, 0.1)
    with pytest.raises(ValueError, match="n_q"):
        tops.pqscore_batched(cs_t, lut[:, :4], codes, res, mask, 0.1)
    with pytest.raises(ValueError, match="expected"):
        tops.cinter_batched(cs_t, codes, mask[:1])
    with pytest.raises(ValueError, match="one query term per bit"):
        tops.bitpack_batched(torch.zeros(1, 33, 8), 0.1)


GLOBAL_FN = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
             r"(\w+)\s*\(")


def test_chip_smoke_names_every_global_function():
    """chip_smoke.py reads each kernel's per-pass device time by the names
    in KERNEL_FUNCTIONS; they must be exactly the __global__ functions each
    csrc/*.cu declares, so a renamed pass cannot drop out of the profile."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    declared = {}
    for cu in sorted(csrc.glob("*.cu")):
        declared[cu.stem] = set(re.findall(GLOBAL_FN, cu.read_text()))
        assert declared[cu.stem], cu
    assert {k: set(v) for k, v in smoke.KERNEL_FUNCTIONS.items()} == declared
    assert sorted(smoke.KERNELS) == sorted(declared)
    for name, info in smoke.KERNELS.items():
        assert info["source"] == f"src/repro_torch/kernels/csrc/{name}.cu"
