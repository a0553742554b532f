"""The operand forms of filtered and compact retrieval: the port's kernel
wrappers (their plain PyTorch versions on the CPU) against the reference's
Pallas kernels in interpret mode, bit for bit.

- prefilter with a predicate plan over ``pred_words`` (empty, ``(0, 0)``,
  several clauses with forbidden bits, bit 31 in use), batched and single
  query;
- prefilter with per-query candidate codes (compact mode), with holes in
  the buffer's valid slots and a buffer size that is no multiple of any
  block or tile;
- pqinter with ``doc_pass`` all true, all false, and sparse with fewer than
  ``n_docs`` and fewer than ``k`` survivors passing;
- bitfilter with per-query codes, row by row against the reference kernel.

tests/test_torch_cuda.py holds the CUDA kernels against the same plain
versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from torch_inputs import (compact_inputs, doc_pass_rows, plan_words,
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


PLANS = {
    "empty": (),
    "everything": ((0, 0),),
    "one_bit": ((1 << 3, 0),),
    "forbidden": ((1 << 0, 1 << 1), (1 << 2, (1 << 31) | 1)),
    "bit31": ((1 << 31, 0), (0, (1 << 31) | (1 << 5) | (1 << 6))),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_plan_matches_pallas(plan, masked):
    nb, n_docs, n_filter = 3, 300, 64
    cs, codes, mask, bitmap, qm = prefilter_inputs(7, nb, 32, 200, n_docs,
                                                   12)
    words = plan_words(8, n_docs)
    clauses = PLANS[plan]
    qm = qm if masked else None
    ref = rops.prefilter_batched(
        *_j(cs), 0.25, *_j(codes, mask, bitmap), n_filter,
        None if qm is None else jnp.asarray(qm),
        pred_words=jnp.asarray(words), plan=clauses, interpret=True)
    port = tops.prefilter_batched(
        *_t(cs), 0.25, *_t(codes, mask, bitmap), n_filter,
        None if qm is None else torch.from_numpy(qm),
        pred_words=torch.from_numpy(words), plan=clauses)
    _eq(port, ref)
    if plan == "empty":            # nothing passes: every doc scores -1
        assert (port[0] == -1).all()
    single = tops.prefilter(*_t(cs[0]), 0.25, *_t(codes, mask, bitmap[0]),
                            n_filter, None if qm is None
                            else torch.from_numpy(qm[0]),
                            pred_words=torch.from_numpy(words), plan=clauses)
    _eq(single, [np.asarray(x)[0] for x in ref[:2]] + [np.asarray(ref[2])[0]])


@pytest.mark.parametrize("nb,n_c,cand_cap,cap,n_filter", [
    (3, 200, 300, 12, 64),       # 300 slots: ragged against block 256
    (2, 130, 1030, 9, 1030),     # n_filter == cand_cap, a tile plus six
    (1, 64, 257, 33, 50),
])
@pytest.mark.parametrize("masked", [False, True])
def test_prefilter_per_query_codes_match_pallas(nb, n_c, cand_cap, cap,
                                                n_filter, masked):
    cs, codes, mask, valid, qm = compact_inputs(cand_cap + nb, nb, 32, n_c,
                                                cand_cap, cap)
    qm = qm if masked else None
    ref = rops.prefilter_batched(*_j(cs), 0.25, *_j(codes, mask, valid),
                                 n_filter, None if qm is None
                                 else jnp.asarray(qm), interpret=True)
    port = tops.prefilter_batched(*_t(cs), 0.25, *_t(codes, mask, valid),
                                  n_filter, None if qm is None
                                  else torch.from_numpy(qm))
    _eq(port, ref)
    lens = torch.from_numpy(mask.sum(-1).astype(np.int32))
    again = tops.prefilter_batched(*_t(cs), 0.25, torch.from_numpy(codes),
                                   lens, torch.from_numpy(valid), n_filter,
                                   None if qm is None
                                   else torch.from_numpy(qm))
    _eq(again, ref)


def test_prefilter_per_query_codes_with_plan_match_pallas():
    """The reference also takes a plan beside per-query codes (the words
    index the buffer's slots)."""
    cs, codes, mask, valid, qm = compact_inputs(3, 2, 32, 100, 200, 7)
    words, clauses = plan_words(4, 200), PLANS["forbidden"]
    ref = rops.prefilter_batched(*_j(cs), 0.25, *_j(codes, mask, valid), 40,
                                 jnp.asarray(qm),
                                 pred_words=jnp.asarray(words), plan=clauses,
                                 interpret=True)
    port = tops.prefilter_batched(*_t(cs), 0.25, *_t(codes, mask, valid), 40,
                                  torch.from_numpy(qm),
                                  pred_words=torch.from_numpy(words),
                                  plan=clauses)
    _eq(port, ref)


@pytest.mark.parametrize("passing", ["all", "none", "sparse", "few"])
@pytest.mark.parametrize("th_r", [None, 0.25])
def test_pqinter_doc_pass_matches_pallas(passing, th_r):
    nb, nf, n_docs, k = 3, 70, 20, 7
    cs_t, lut, codes, res, mask, qm = pqinter_inputs(
        11, nb, 32, 100, nf, 10, 8, 16)
    dp = doc_pass_rows(12, nb, nf, passing, n_docs, k)
    ref = rops.pqinter_batched(*_j(cs_t, lut, codes, res, mask), th_r,
                               n_docs, k, jnp.asarray(qm),
                               doc_pass=jnp.asarray(dp), interpret=True)
    port = tops.pqinter_batched(*_t(cs_t, lut, codes, res, mask), th_r,
                                n_docs, k, torch.from_numpy(qm),
                                doc_pass=torch.from_numpy(dp))
    _eq(port, ref)
    n_pass = dp.sum(1)
    for b in range(nb):
        # the fillers: (-1, -inf) past the passing survivors in phase 3,
        # (-inf, 0) past them in phase 4
        assert (port[2][b, n_pass[b]:] == -1).all()
        assert torch.isneginf(port[3][b, n_pass[b]:]).all()
        assert (port[1][b, n_pass[b]:] == 0).all()
    single = tops.pqinter(*_t(cs_t[1], lut[1], codes[1], res[1], mask[1]),
                          th_r, n_docs, k, torch.from_numpy(qm[1]),
                          doc_pass=torch.from_numpy(dp[1]))
    _eq(single, [np.asarray(x)[1] for x in ref])


@pytest.mark.parametrize("nb,n_c,cand_cap,cap", [
    (3, 200, 300, 12), (2, 130, 517, 40), (1, 64, 40, 5)])
@pytest.mark.parametrize("as_lengths", [False, True])
def test_bitfilter_per_query_codes_match_pallas(nb, n_c, cand_cap, cap,
                                                as_lengths):
    _, codes, mask, valid, _ = compact_inputs(cand_cap, nb, 1, n_c,
                                              cand_cap, cap)
    mask &= valid[..., None]              # the unfused lane's buffer mask
    bits = plan_words(cand_cap + 1, nb * n_c).reshape(nb, n_c)
    validity = mask.sum(-1).astype(np.int32) if as_lengths else mask
    port = tops.bitfilter_batched(*_t(bits.view(np.int32), codes, validity))
    assert port.dtype == torch.int32 and port.shape == (nb, cand_cap)
    for b in range(nb):
        _eq([port[b]], [rops.bitfilter(*_j(bits[b], codes[b], mask[b]),
                                       interpret=True)])
