"""bf16 centroid scores (``cs_dtype="bfloat16"``, paper §6) through the
port's kernel wrappers (their plain PyTorch versions on the CPU) against the
reference's Pallas kernels in interpret mode, bit for bit: bit words, F and
ids, S̄ and score bits, positions.

The CS inputs are tie-heavy bf16 values (quantized, every float32 entry a
bf16 value), with a share of entries equal to bf16(th) = 0.400390625 and to
bf16(th_r) = 0.30078125 (``torch_inputs.bf16_edges``): there the fused
prefilter (a bf16 comparison against th cast to bf16) packs bit 0 and the
unfused bitpack (a float32 comparison, its threshold a float32 array) packs
bit 1, and Eq. 6 keeps no token whose centroid score equals bf16(th_r).
``th_r`` is both None and set, the term mask both absent and padded, and
bitfilter runs on words from a bf16 bitpack. cinter is held against its
Pallas kernel's body (:func:`cinter_body`): the kernel itself does not run
on bf16 CS under jax 0.9.0. tests/test_torch_cuda.py holds
the CUDA forms against the same plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cinter as rcinter
from repro.kernels import ops as rops
from repro_torch.core.precision import CS_TYPES
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from torch_inputs import (BF16_EDGES, BF16_TH, BF16_TH_R, bf16_edges,
                          compact_inputs, doc_pass_rows, plan_words,
                          pqinter_inputs, prefilter_inputs)

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


def _tb(x):
    """A float32 array of bf16 values as a bf16 tensor (exact)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _opt(qm, conv):
    return None if qm is None else conv(qm)


def _cs(seed, nb, n_q, n_c):
    """(B, n_q, n_c) bf16-valued CS with bf16(th) and bf16(th_r) entries."""
    cs = prefilter_inputs(seed, nb, n_q, n_c, 4, 2)[0]
    return bf16_edges(seed, cs)


def _bit(words, b, i, c):
    return (int(np.asarray(words)[b, c]) >> i) & 1


@pytest.mark.parametrize("nb,n_q,n_c", [(3, 32, 700), (1, 7, 1024)])
@pytest.mark.parametrize("masked", [False, True])
def test_bitpack_bf16_matches_pallas(nb, n_q, n_c, masked):
    """bitpack compares in float32 (the reference's th is a float32 array):
    an entry equal to bf16(th) packs bit 1 where build_bitvectors' bf16
    comparison packs bit 0."""
    cs = _cs(n_c, nb, n_q, n_c)
    qm = prefilter_inputs(n_c, nb, n_q, 4, 4, 2)[4] if masked else None
    port = tops.bitpack_batched(_tb(cs), BF16_TH, _opt(qm, torch.from_numpy))
    for b in range(nb):
        want = rops.bitpack(_jb(cs[b]), BF16_TH,
                            _opt(qm, lambda m: jnp.asarray(m[b])),
                            interpret=True)
        _eq([port[b]], [want])
    b, i, c = (int(x[0]) for x in np.nonzero(cs == BF16_EDGES[0]))
    if qm is None or qm[b, i]:
        assert _bit(port, b, i, c) == 1
    assert torch.equal(tops.bitpack(_tb(cs[0]), np.float32(BF16_TH),
                                    _opt(qm, lambda m: torch.from_numpy(
                                        m[0]))), port[0])


@pytest.mark.parametrize("nb,n_q,n_c,n_docs,cap,n_filter", [
    (3, 32, 200, 300, 12, 64),      # 300 docs: ragged against block 256
    (2, 16, 130, 517, 9, 100),
    (1, 32, 64, 90, 6, 90),         # n_filter == n_docs: the whole corpus
])
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_bf16_matches_pallas(nb, n_q, n_c, n_docs, cap, n_filter,
                                       masked):
    """The fused pack compares in bf16 against th cast to bf16: an entry
    equal to bf16(th) packs bit 0."""
    _, codes, mask, bitmap, qm = prefilter_inputs(n_docs, nb, n_q, n_c,
                                                  n_docs, cap)
    cs = _cs(n_docs, nb, n_q, n_c)
    qm = qm if masked else None
    ref = rops.prefilter_batched(_jb(cs), BF16_TH, *_j(codes, mask, bitmap),
                                 n_filter, _opt(qm, jnp.asarray),
                                 interpret=True)
    port = tops.prefilter_batched(_tb(cs), BF16_TH, *_t(codes, mask, bitmap),
                                  n_filter, _opt(qm, torch.from_numpy))
    _eq(port, ref)
    b, i, c = (int(x[0]) for x in np.nonzero(cs == BF16_EDGES[0]))
    assert _bit(port[2], b, i, c) == 0
    if nb == 1:
        single = tops.prefilter(_tb(cs[0]), BF16_TH,
                                *_t(codes, mask, bitmap[0]), n_filter,
                                _opt(qm, lambda m: torch.from_numpy(m[0])))
        _eq(single, [r[0] for r in ref])


@pytest.mark.parametrize("form", ["plan", "per_query"])
def test_prefilter_bf16_operand_forms_match_pallas(form):
    """A predicate plan over pred_words, and compact mode's per-query codes
    with holes in the valid slots, on bf16 CS."""
    if form == "plan":
        _, codes, mask, valid, qm = prefilter_inputs(11, 3, 32, 200, 300, 12)
        cs = _cs(11, 3, 32, 200)
        words = plan_words(12, 300)
        plan = ((1 << 0, 1 << 1), (1 << 31, 0))
        extra = dict(pred_words=words, plan=plan)
    else:
        _, codes, mask, valid, qm = compact_inputs(13, 3, 32, 150, 700, 10)
        cs = _cs(13, 3, 32, 150)
        extra = {}
    ref = rops.prefilter_batched(
        _jb(cs), BF16_TH, *_j(codes, mask, valid), 64, jnp.asarray(qm),
        interpret=True, **{k: v if k == "plan" else jnp.asarray(v)
                           for k, v in extra.items()})
    port = tops.prefilter_batched(
        _tb(cs), BF16_TH, *_t(codes, mask, valid), 64, torch.from_numpy(qm),
        **{k: v if k == "plan" else torch.from_numpy(v)
           for k, v in extra.items()})
    _eq(port, ref)


@pytest.mark.parametrize("nb", [1, 3, 32])
def test_bitfilter_on_bf16_bitpack_words(nb):
    """bitfilter sees only words; here they come from a bf16 bitpack."""
    _, codes, mask, _, _ = prefilter_inputs(nb, 1, 1, 200, 300, 12)
    cs = _cs(nb + 1, nb, 32, 200)
    words = tops.bitpack_batched(_tb(cs), BF16_TH)
    port = tops.bitfilter_batched(words, *_t(codes, mask))
    for b in range(nb):
        ref_words = rops.bitpack(_jb(cs[b]), BF16_TH, interpret=True)
        _eq([words[b]], [ref_words])
        _eq([port[b]], [rops.bitfilter(ref_words, *_j(codes, mask),
                                       interpret=True)])


def _pq_inputs(seed, nb, n_q, n_c, nf, cap, m, ksub, lens=None):
    cs_t, lut, codes, res, mask, qm = pqinter_inputs(seed, nb, n_q, n_c, nf,
                                                     cap, m, ksub, lens=lens)
    return bf16_edges(seed, cs_t), lut, codes, res, mask, qm


def cinter_body(cs_t, codes, token_mask, q_mask=None, *, interpret=True):
    """The reference cinter kernel's body, ``sbar_block`` over all the docs,
    widened to float32 as the kernel's output is (``cinter.py:109``). On
    bf16 CS the Pallas kernel itself stores its bf16 S̄ into that float32
    output, which jax 0.9.0 refuses ("Invalid dtype for `swap`"), so the
    bf16 tests hold cinter against this plain reference instead."""
    del interpret
    return rcinter.sbar_block(cs_t, codes, token_mask,
                              q_mask).astype(jnp.float32)


@pytest.mark.parametrize("nb,n_q,n_c,nd,cap", [
    (3, 32, 100, 130, 10),     # 130 docs: ragged against block 128
    (2, 16, 64, 70, 7),        # less than one block
])
@pytest.mark.parametrize("masked", [False, True])
def test_cinter_bf16_matches_reference(nb, n_q, n_c, nd, cap, masked):
    """S̄ is the bf16 sum, written widened to float32."""
    cs_t, _, codes, _, mask, qm = _pq_inputs(nd + cap, nb, n_q, n_c, nd, cap,
                                             2, 4)
    qm = qm if masked else None
    port = tops.cinter_batched(_tb(cs_t), *_t(codes, mask),
                               _opt(qm, torch.from_numpy))
    assert port.dtype == torch.float32
    assert torch.equal(port.to(torch.bfloat16).float(), port)
    for b in range(nb):
        _eq([port[b]], [cinter_body(
            _jb(cs_t[b]), *_j(codes[b], mask[b]),
            _opt(qm, lambda m: jnp.asarray(m[b])))])
    # on float32 CS the body is the Pallas kernel, bit for bit
    f32 = [jnp.asarray(x) for x in (cs_t[0], codes[0], mask[0])]
    np.testing.assert_array_equal(
        _u32(cinter_body(*f32)), _u32(rops.cinter(*f32, interpret=True)))


SPLIT_LENS = (0, 1, 7, 8, 9, 79, 80)


@pytest.mark.parametrize("nb,n_q,n_c,nd,cap,m,ksub,lens", [
    pytest.param(3, 32, 100, 45, 10, 8, 16, None, id="3-32-100-45-10-8-16"),
    # emvb-msmarco's shape: n_q 32, m 16, K 256, cap 80
    pytest.param(2, 32, 100, 24, 80, 16, 256, SPLIT_LENS,
                 id="2-32-100-24-80-16-256-split_lens"),
])
@pytest.mark.parametrize("th_r", [None, BF16_TH_R])
@pytest.mark.parametrize("masked", [False, True])
def test_pqscore_bf16_matches_pallas(nb, n_q, n_c, nd, cap, m, ksub, lens,
                                     th_r, masked):
    cs_t, lut, codes, res, mask, qm = _pq_inputs(nd + m, nb, n_q, n_c, nd,
                                                 cap, m, ksub, lens=lens)
    qm = qm if masked else None
    port = tops.pqscore_batched(_tb(cs_t), *_t(lut, codes, res, mask), th_r,
                                _opt(qm, torch.from_numpy))
    assert port.dtype == torch.float32
    for b in range(nb):
        _eq([port[b]], [rops.pqscore(
            _jb(cs_t[b]), *_j(lut[b], codes[b], res[b], mask[b]), th_r,
            _opt(qm, lambda m: jnp.asarray(m[b])), interpret=True)])


@pytest.mark.parametrize("nb,nf,cap,m,ksub,n_docs,k", [
    (3, 70, 10, 8, 16, 20, 7),       # ragged nf and n_docs
    (2, 600, 8, 8, 16, 40, 10),      # S̄ ties across pass 1's 512-row blocks
])
@pytest.mark.parametrize("th_r", [None, BF16_TH_R])
@pytest.mark.parametrize("masked", [False, True])
def test_pqinter_bf16_matches_pallas(nb, nf, cap, m, ksub, n_docs, k, th_r,
                                     masked):
    cs_t, lut, codes, res, mask, qm = _pq_inputs(nf + cap, nb, 32, 100, nf,
                                                 cap, m, ksub)
    qm = qm if masked else None
    ref = rops.pqinter_batched(_jb(cs_t), *_j(lut, codes, res, mask), th_r,
                               n_docs, k, _opt(qm, jnp.asarray),
                               interpret=True)
    port = tops.pqinter_batched(_tb(cs_t), *_t(lut, codes, res, mask), th_r,
                                n_docs, k, _opt(qm, torch.from_numpy))
    _eq(port, ref)
    if nf > 512:                     # the cut broke ties of S̄
        sbar = port[3][0]
        assert (sbar[1:] == sbar[:-1]).any()


@pytest.mark.parametrize("passing", ["all", "none", "sparse", "few"])
def test_pqinter_bf16_doc_pass_matches_pallas(passing):
    nb, nf, n_docs, k = 3, 70, 20, 7
    cs_t, lut, codes, res, mask, qm = _pq_inputs(17, nb, 32, 100, nf, 10, 8,
                                                 16)
    dp = doc_pass_rows(18, nb, nf, passing, n_docs, k)
    ref = rops.pqinter_batched(_jb(cs_t), *_j(lut, codes, res, mask),
                               BF16_TH_R, n_docs, k, jnp.asarray(qm),
                               doc_pass=jnp.asarray(dp), interpret=True)
    port = tops.pqinter_batched(_tb(cs_t), *_t(lut, codes, res, mask),
                                BF16_TH_R, n_docs, k, torch.from_numpy(qm),
                                doc_pass=torch.from_numpy(dp))
    _eq(port, ref)


def test_pqinter_bf16_single_query_matches_pallas():
    cs_t, lut, codes, res, mask, qm = _pq_inputs(9, 1, 32, 90, 50, 8, 8, 16)
    ref = rops.pqinter(_jb(cs_t[0]), *_j(lut[0], codes[0], res[0], mask[0]),
                       BF16_TH_R, 16, 5, jnp.asarray(qm[0]), interpret=True)
    port = tops.pqinter(_tb(cs_t[0]), *_t(lut[0], codes[0], res[0], mask[0]),
                        BF16_TH_R, 16, 5, torch.from_numpy(qm[0]))
    _eq(port, ref)


def test_operand_check_takes_float32_and_bf16_cs_only():
    """The card's operand check takes float32 and bf16 CS and refuses any
    other dtype, naming both."""
    for dtype in CS_TYPES:
        _build.check_operands("bitpack", torch.device("cpu"), [
            ("cs", torch.zeros(2, 8, 32, dtype=dtype), CS_TYPES, (2, 8, 32))])
    with pytest.raises(TypeError, match="torch.float32 or torch.bfloat16"):
        _build.check_operands("bitpack", torch.device("cpu"), [
            ("cs", torch.zeros(2, 8, 32, dtype=torch.float16), CS_TYPES,
             (2, 8, 32))])
