"""Token masks with holes at every kernel entry point of the port
(``repro_torch.kernels.ops``) against the reference's Pallas kernels in
interpret mode (``repro.kernels.ops``): F exactly, ids, and the float32 bits
of every score.

The reference's kernels take any bool token mask; the port's wrappers move
each row's valid tokens to the front (``prefilter.valid_first``) and pass
lengths, which is exact because every per-doc reduction over tokens is free
of order. The masks here have holes anywhere, rows with no valid token and
rows with every token valid, and the codes in the holes are real centroid
ids, so a hole that leaked into a result would change it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from torch_inputs import (compact_inputs, doc_pass_rows, plan_words,
                          pqinter_inputs, prefilter_inputs)

torch.set_num_threads(1)

NB, N_DOCS, CAP, N_C = 2, 512, 8, 96
TH, TH_R = 0.25, 0.25


def _u32(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def _eq(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(_u32(p.numpy()), _u32(r))


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x))
            for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def holey_mask(seed, shape, valid=0.6):
    """A bool mask with holes anywhere; the first row of each leading index
    has no valid token and the second every token valid."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < valid
    mask[..., 0, :] = False
    mask[..., 1, :] = True
    return mask


def _prefilter_operands(seed, form):
    """cs, codes (real ids in the holes too), a holey mask, bitmap, q_mask
    and the plan's operands of one prefilter operand form."""
    if form == "per_query":
        cs, codes, _, bitmap, qm = compact_inputs(seed, NB, 32, N_C, N_DOCS,
                                                  CAP)
    else:
        cs, codes, _, bitmap, qm = prefilter_inputs(seed, NB, 32, N_C,
                                                    N_DOCS, CAP)
    codes = np.random.default_rng(seed).integers(
        0, N_C, size=codes.shape).astype(np.int32)
    plan = pred = None
    if form == "plan":
        plan, pred = ((1 << 3, 0), (0, 1 << 31)), plan_words(seed, N_DOCS)
    return cs, codes, holey_mask(seed, codes.shape), bitmap, qm, plan, pred


@pytest.mark.parametrize("form", ["shared", "plan", "per_query"])
@pytest.mark.parametrize("n_filter", [64, N_DOCS])
def test_prefilter_batched_takes_masks_with_holes(form, n_filter):
    cs, codes, mask, bitmap, qm, plan, pred = _prefilter_operands(1, form)
    ref = rops.prefilter_batched(*_j(cs), TH, *_j(codes, mask, bitmap),
                                 n_filter, jnp.asarray(qm),
                                 pred_words=_j(pred)[0], plan=plan,
                                 interpret=True)
    port = tops.prefilter_batched(*_t(cs), TH, *_t(codes, mask, bitmap),
                                  n_filter, torch.from_numpy(qm),
                                  pred_words=_t(pred)[0], plan=plan)
    _eq(port, ref)


@pytest.mark.parametrize("form", ["shared", "plan"])
def test_prefilter_takes_masks_with_holes(form):
    cs, codes, mask, bitmap, qm, plan, pred = _prefilter_operands(2, form)
    ref = rops.prefilter(*_j(cs[0]), TH, *_j(codes, mask, bitmap[0]), 100,
                         jnp.asarray(qm[0]), pred_words=_j(pred)[0],
                         plan=plan, interpret=True)
    port = tops.prefilter(*_t(cs[0]), TH, *_t(codes, mask, bitmap[0]), 100,
                          torch.from_numpy(qm[0]), pred_words=_t(pred)[0],
                          plan=plan)
    _eq(port, ref)


def _pq_operands(seed, nf=N_DOCS):
    """cs_t, lut, codes and residual codes (real ones in the holes), a
    holey mask, q_mask; m = 16 over 16 sub-centroids."""
    cs_t, lut, codes, res, _, qm = pqinter_inputs(seed, NB, 32, N_C, nf, CAP,
                                                  16, 16)
    codes = np.random.default_rng(seed).integers(
        0, N_C, size=codes.shape).astype(np.int32)
    return cs_t, lut, codes, res, holey_mask(seed, codes.shape), qm


@pytest.mark.parametrize("th_r", [None, TH_R])
@pytest.mark.parametrize("passing", [None, "sparse", "few"])
def test_pqinter_batched_takes_masks_with_holes(th_r, passing):
    cs_t, lut, codes, res, mask, qm = _pq_operands(3)
    dp = None if passing is None else doc_pass_rows(3, NB, N_DOCS, passing,
                                                    100, 30)
    ref = rops.pqinter_batched(*_j(cs_t, lut, codes, res, mask), th_r, 100,
                               30, jnp.asarray(qm), doc_pass=_j(dp)[0],
                               interpret=True)
    port = tops.pqinter_batched(*_t(cs_t, lut, codes, res, mask), th_r, 100,
                                30, torch.from_numpy(qm), doc_pass=_t(dp)[0])
    _eq(port, ref)


def test_pqinter_takes_masks_with_holes():
    cs_t, lut, codes, res, mask, qm = _pq_operands(4)
    ref = rops.pqinter(*_j(cs_t[0], lut[0], codes[0], res[0], mask[0]),
                       TH_R, 60, 20, jnp.asarray(qm[0]), interpret=True)
    port = tops.pqinter(*_t(cs_t[0], lut[0], codes[0], res[0], mask[0]),
                        TH_R, 60, 20, torch.from_numpy(qm[0]))
    _eq(port, ref)


def test_bitfilter_takes_masks_with_holes():
    cs, codes, mask, _, qm, _, _ = _prefilter_operands(5, "shared")
    bits = rops.bitpack(jnp.asarray(cs[0]), TH, jnp.asarray(qm[0]),
                        interpret=True)
    ref = rops.bitfilter(bits, *_j(codes, mask), interpret=True)
    words = torch.from_numpy(np.array(bits).view(np.int32))
    _eq([tops.bitfilter(words, *_t(codes, mask))], [ref])
    _eq([tops.bitfilter_batched(words[None], *_t(codes, mask))[0]], [ref])


@pytest.mark.parametrize("masked", [False, True])
def test_cinter_takes_masks_with_holes(masked):
    cs_t, _, codes, _, mask, qm = _pq_operands(6)
    for b in range(NB):
        q = qm[b] if masked else None
        ref = rops.cinter(*_j(cs_t[b], codes[b], mask[b], q), interpret=True)
        _eq([tops.cinter(*_t(cs_t[b], codes[b], mask[b], q))], [ref])
    port = tops.cinter_batched(*_t(cs_t, codes, mask),
                               torch.from_numpy(qm) if masked else None)
    _eq([port[1]], [rops.cinter(*_j(cs_t[1], codes[1], mask[1],
                                    qm[1] if masked else None),
                                interpret=True)])


@pytest.mark.parametrize("th_r", [None, TH_R])
def test_pqscore_takes_masks_with_holes(th_r):
    cs_t, lut, codes, res, mask, qm = _pq_operands(7, nf=200)
    for b in range(NB):
        ref = rops.pqscore(*_j(cs_t[b], lut[b], codes[b], res[b], mask[b]),
                           th_r, jnp.asarray(qm[b]), interpret=True)
        _eq([tops.pqscore(*_t(cs_t[b], lut[b], codes[b], res[b], mask[b]),
                          th_r, torch.from_numpy(qm[b]))], [ref])
    port = tops.pqscore_batched(*_t(cs_t, lut, codes, res, mask), th_r,
                                torch.from_numpy(qm))
    _eq([port[0]], [rops.pqscore(*_j(cs_t[0], lut[0], codes[0], res[0],
                                     mask[0]), th_r, jnp.asarray(qm[0]),
                                 interpret=True)])


def test_valid_first_keeps_prefix_masks_and_lengths_as_they_are():
    """Prefix masks and lengths take the path they took before: the
    operands come back as the same tensors, no gather."""
    from repro_torch.kernels.prefilter import valid_first
    codes = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    lens = torch.tensor([0, 3, 8], dtype=torch.int32)
    prefix = torch.arange(8) < lens[:, None]
    for tm in (prefix, lens):
        got_lens, got = valid_first(tm, codes)
        assert got is codes and torch.equal(got_lens, lens)
    holey = prefix.clone()
    holey[1] = torch.tensor([0, 1, 0, 1, 1, 0, 0, 0], dtype=torch.bool)
    got_lens, got = valid_first(holey, codes)
    assert got_lens.tolist() == [0, 3, 8]
    assert got[1].tolist() == [9, 11, 12, 8, 10, 13, 14, 15]
    assert torch.equal(got[[0, 2]], codes[[0, 2]])
