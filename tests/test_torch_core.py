"""The port's core math (``repro_torch.core``) against the reference
(``repro.core``): bit-exact on identical numpy inputs, with and without a
query-term mask. Tie-heavy inputs are quantized to a few levels (``+ 0.0``
turns numpy's ``-0.0`` into ``0.0``, so no signed zero decides a max)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import interaction as rint
from repro.core import pq as rpq
from repro_torch.core import bitvector as tbv
from repro_torch.core import interaction as tint
from repro_torch.core import pq as tpq
from repro_torch.core.topk import topk
from repro_torch.kernels import topnprobe
from torch_inputs import topnprobe_inputs

torch.set_num_threads(1)


def _f32(x):
    return np.asarray(x, np.float32)


def _bits_eq(port: torch.Tensor, ref) -> None:
    """Same float32 bits (or same integers)."""
    a, b = port.numpy(), np.asarray(ref)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.astype(np.float32).view(np.uint32)
    np.testing.assert_array_equal(a, b)


def _cs(rng, shape, levels=None):
    cs = _f32(rng.normal(size=shape) * 0.5)
    if levels:
        cs = _f32(np.round(cs * levels) / levels + 0.0)
    return cs


def _q_mask(rng, lead, n_q):
    m = rng.random(lead + (n_q,)) < 0.7
    m[..., 0] = True
    return m


@pytest.mark.parametrize("levels", [None, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_build_bitvectors(levels, masked):
    rng = np.random.default_rng(0)
    cs = _cs(rng, (3, 32, 200), levels)
    qm = _q_mask(rng, (3,), 32) if masked else None
    ref = rbv.build_bitvectors(jnp.asarray(cs), 0.4,
                               None if qm is None else jnp.asarray(qm))
    port = tbv.build_bitvectors(torch.from_numpy(cs), 0.4,
                                None if qm is None else torch.from_numpy(qm))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy().view(np.uint32),
                                  np.asarray(ref))


def test_popcount_and_filter_score():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
    want = np.array([bin(int(w)).count("1") for w in words])
    got = tbv.popcount(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)

    n_c, n_docs, cap = 200, 77, 12
    cs = _cs(rng, (32, n_c), 4)
    bits = rbv.build_bitvectors(jnp.asarray(cs), 0.25)
    codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
    lens = rng.integers(1, cap + 1, size=n_docs)
    mask = np.arange(cap)[None, :] < lens[:, None]
    codes[~mask] = n_c                                   # pad sentinel
    ref = rbv.filter_score(bits, jnp.asarray(codes), jnp.asarray(mask))
    port = tbv.filter_score(
        torch.from_numpy(np.array(bits).view(np.int32)),
        torch.from_numpy(codes), torch.from_numpy(mask))
    _bits_eq(port, ref)


def test_filter_score_batch():
    """Eq. 4 over a batch of queries' words, shared codes and a mask with
    holes (real ids in them), with a row of no valid token."""
    rng = np.random.default_rng(2)
    n_c, n_docs, cap = 150, 90, 9
    cs = _cs(rng, (5, 32, n_c), 4)
    bits = rbv.build_bitvectors(jnp.asarray(cs), 0.25)      # (5, n_c)
    codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
    mask = rng.random((n_docs, cap)) < 0.5
    mask[0] = False
    ref = rbv.filter_score_batch(bits, jnp.asarray(codes), jnp.asarray(mask))
    port = tbv.filter_score_batch(
        torch.from_numpy(np.array(bits).view(np.int32)),
        torch.from_numpy(codes), torch.from_numpy(mask))
    assert port.shape == (5, n_docs)
    _bits_eq(port, ref)


@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_topk_centroids(levels, masked):
    rng = np.random.default_rng(2)
    cs = _cs(rng, (4, 32, 300), levels)
    qm = _q_mask(rng, (4,), 32) if masked else None
    ref = jax.vmap(lambda c, m: rbv.masked_topk_centroids(c, 0.4, 4, m))(
        jnp.asarray(cs), jnp.asarray(np.ones((4, 32), bool) if qm is None
                                     else qm))
    port = tbv.masked_topk_centroids(
        torch.from_numpy(cs), 0.4, 4,
        None if qm is None else torch.from_numpy(qm))
    _bits_eq(port, ref)


# (nprobe, n_c, th, CS dtype): fewer survivors than nprobe in some rows,
# ties before and after the -1e6 offset, entries equal to th and bf16(th)
# (torch_inputs.topnprobe_inputs); signed zeros survive at th < 0; a numpy
# th compares bf16 CS in float32 (hazard 8).
TOPNPROBE_CASES = {
    "nprobe4": (4, 301, 0.4, torch.float32),
    "nprobe1": (1, 301, 0.4, torch.float32),
    "nprobe33": (33, 301, 0.4, torch.float32),
    "odd_n_c": (4, 1001, 0.4, torch.float32),
    "signed_zeros": (4, 301, -0.25, torch.float32),
    "bf16": (4, 301, 0.4, torch.bfloat16),
    "bf16_numpy_th": (4, 301, np.float32(0.4), torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(TOPNPROBE_CASES))
def test_masked_topk_centroids_edges(case):
    """The CPU route of masked_topk_centroids (the plain version the card's
    topnprobe kernel is held to) == the reference on the kernel's edge
    cases, with a term mask."""
    nprobe, n_c, th, dtype = TOPNPROBE_CASES[case]
    cs, qm = topnprobe_inputs(5, 3, 32, n_c, nprobe, th)
    cs = cs.to(dtype)
    jcs = jnp.asarray(cs.float().numpy(),
                      jnp.bfloat16 if dtype == torch.bfloat16 else None)
    ref = jax.vmap(lambda c, m: rbv.masked_topk_centroids(c, th, nprobe, m))(
        jcs, jnp.asarray(qm.numpy()))
    port = tbv.masked_topk_centroids(cs, th, nprobe, qm)
    _bits_eq(port, ref)
    _bits_eq(topnprobe.masked_topk(cs, th, nprobe, qm), ref)


def test_topnprobe_wrapper_refuses():
    """The kernel's wrapper raises on nprobe > n_c (as torch.topk and
    lax.top_k fail) and on a CS it cannot read as rows, on every device."""
    cs = torch.zeros(2, 4, 9)
    with pytest.raises(ValueError, match="nprobe=10"):
        topnprobe.masked_topk(cs, 0.4, 10)
    with pytest.raises(ValueError, match="not contiguous"):
        topnprobe.masked_topk(cs.transpose(0, 1), 0.4, 2)
    with pytest.raises(ValueError, match="q_mask"):
        topnprobe.masked_topk(cs, 0.4, 2, torch.ones(2, 5, dtype=torch.bool))


def _interaction_inputs(seed, levels):
    rng = np.random.default_rng(seed)
    n_q, n_c, docs, cap, m, ksub = 32, 150, 41, 10, 8, 16
    cs = _cs(rng, (n_q, n_c), levels)
    lut = _cs(rng, (n_q, m, ksub), levels)
    codes = rng.integers(0, n_c + 1, size=(docs, cap)).astype(np.int32)
    lens = rng.integers(1, cap + 1, size=docs)
    mask = np.arange(cap)[None, :] < lens[:, None]
    res = rng.integers(0, ksub, size=(docs, cap, m)).astype(np.uint8)
    qm = _q_mask(rng, (), n_q)
    return cs, lut, codes, mask, res, qm


@pytest.mark.parametrize("levels", [None, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_centroid_interaction(levels, masked):
    cs, _, codes, mask, _, qm = _interaction_inputs(3, levels)
    qm = qm if masked else None
    ref = rint.centroid_interaction(jnp.asarray(cs.T), jnp.asarray(codes),
                                    jnp.asarray(mask),
                                    None if qm is None else jnp.asarray(qm))
    port = tint.centroid_interaction(
        torch.from_numpy(np.ascontiguousarray(cs.T)), torch.from_numpy(codes),
        torch.from_numpy(mask), None if qm is None else torch.from_numpy(qm))
    _bits_eq(port, ref)


@pytest.mark.parametrize("th_r", [None, 0.3])
@pytest.mark.parametrize("levels", [None, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_late_interaction_pq(th_r, levels, masked):
    cs, lut, codes, mask, res, qm = _interaction_inputs(4, levels)
    qm = qm if masked else None
    ref = rint.late_interaction_pq(
        jnp.asarray(cs.T), jnp.asarray(lut), jnp.asarray(codes),
        jnp.asarray(res), jnp.asarray(mask), th_r,
        q_mask=None if qm is None else jnp.asarray(qm))
    port = tint.late_interaction_pq(
        torch.from_numpy(np.ascontiguousarray(cs.T)), torch.from_numpy(lut),
        torch.from_numpy(codes), torch.from_numpy(res),
        torch.from_numpy(mask), th_r,
        q_mask=None if qm is None else torch.from_numpy(qm))
    _bits_eq(port, ref)


def test_interaction_batched_rows_equal_single():
    """The port's batched forms (leading B on every operand) give row b of
    the single-query result, bit for bit."""
    rows = [_interaction_inputs(s, 2) for s in (5, 6)]
    stack = [torch.from_numpy(np.stack(x)) for x in zip(*rows)]
    cs, lut, codes, mask, res, qm = stack
    cs_t = cs.transpose(1, 2).contiguous()
    sbar = tint.centroid_interaction(cs_t, codes, mask, qm)
    score = tint.late_interaction_pq(cs_t, lut, codes, res, mask, 0.3,
                                     q_mask=qm)
    for b in range(2):
        one = tint.centroid_interaction(cs_t[b], codes[b], mask[b], qm[b])
        assert torch.equal(sbar[b].view(torch.int32), one.view(torch.int32))
        one = tint.late_interaction_pq(cs_t[b], lut[b], codes[b], res[b],
                                       mask[b], 0.3, q_mask=qm[b])
        assert torch.equal(score[b].view(torch.int32), one.view(torch.int32))


@pytest.mark.parametrize("m,ksub", [(8, 16), (16, 256)])
def test_build_lut(m, ksub):
    rng = np.random.default_rng(7)
    q = _f32(rng.normal(size=(4, 32, 128)))
    cb = _f32(rng.normal(size=(m, ksub, 128 // m)) * 0.1)
    ref = jax.vmap(lambda x: rpq.build_lut(x, rpq.PQCodebooks(cb)))(
        jnp.asarray(q))
    port = tpq.build_lut(torch.from_numpy(q), tpq.PQCodebooks(
        torch.from_numpy(cb)))
    _bits_eq(port, ref)


def test_decode_pq():
    rng = np.random.default_rng(8)
    cb = _f32(rng.normal(size=(8, 16, 4)))
    codes = rng.integers(0, 16, size=(50, 8)).astype(np.uint8)
    ref = rpq.decode_pq(jnp.asarray(codes), rpq.PQCodebooks(cb))
    port = tpq.decode_pq(torch.from_numpy(codes),
                         tpq.PQCodebooks(torch.from_numpy(cb)))
    _bits_eq(port, ref)


@pytest.mark.parametrize("n_q", [4, 20, 32])
def test_term_sum(n_q):
    rng = np.random.default_rng(9)
    x = _f32(rng.normal(size=(64, n_q)) * 10.0 ** rng.integers(
        -3, 4, size=(64, n_q)))
    _bits_eq(tint.term_sum(torch.from_numpy(x)), rint.term_sum(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_topk_matches_lax_on_ties(dtype):
    rng = np.random.default_rng(10)
    rows = rng.integers(-3, 4, size=(6, 97)).astype(dtype)
    if dtype == np.float32:
        rows[0, :8] = [0.0, -0.0, 0.0, -0.0, np.inf, -np.inf, 1.0, 1.0]
    for k in (1, 5, 40, 97):
        vals, idx = topk(torch.from_numpy(rows), k)
        rv, ri = jax.lax.top_k(jnp.asarray(rows), k)
        _bits_eq(vals, rv)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    vals, idx = topk(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)
    assert idx.tolist() == [1, 2, 4]


@pytest.mark.parametrize("th_r", [0.0, 0.3])
@pytest.mark.parametrize("masked", [False, True])
def test_scored_term_fraction(th_r, masked):
    rng = np.random.default_rng(11)
    cs_t = _cs(rng, (60, 32), 4)
    codes = rng.integers(0, 60, size=(40, 12)).astype(np.int32)
    mask = np.arange(12) < rng.integers(0, 13, size=40)[:, None]
    qm = _q_mask(rng, (), 32) if masked else None
    ref = rint.scored_term_fraction(
        jnp.asarray(cs_t), jnp.asarray(codes), jnp.asarray(mask), th_r,
        None if qm is None else jnp.asarray(qm))
    port = tint.scored_term_fraction(
        torch.from_numpy(cs_t), torch.from_numpy(codes),
        torch.from_numpy(mask), th_r,
        None if qm is None else torch.from_numpy(qm))
    assert port.dtype == torch.float32 and port.shape == ()
    assert 0.0 < float(port) < 1.0
    _bits_eq(port, ref)
