"""The port at the shape of the paper's LoTTE deployment (the benchmark's
``emvb-lotte-k1000``): PQ at m = 32 with a trained OPQ rotation, long
docs, and the k = 1000 row's budgets, against the reference.

The reference builds a small LoTTE-like index (``make_ood_corpus``: shifted
topics, longer docs; ``use_opq=True``, so ``opq_rotation`` is a real
rotation, not the identity), saves it with ``repro.core.store.save_index``
and the port loads it. The budgets are the k = 1000 row's (n_filter 2,000,
n_docs 1,000, k 1,000; ``benchmarks/table2_ood.py:25-28``) cut to the small
corpus by the rule of the benchmark's CPU tests: each divided by 8, kept
``n_filter > n_docs >= k``. Caps of 160 and 300 tokens make the prefilter
and the S̄ pass walk docs of more than one 128-token chunk; d is 128, so
each of the 32 sub-spaces is 4 wide, as in the deployment.

The port's ``retrieve`` runs the rotation and the LUT itself; the CS, the
rotated queries and the LUT are first held bit for bit against the
reference's (so a failure names the layer), then the doc ids and float32
score bits of the port's fused lane against the reference's fused kernel
lane (Pallas in interpret mode), and of the port's unfused lane against the
same result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.index import build_index
from repro.core.pq import build_lut as ref_build_lut
from repro.data.synthetic import make_ood_corpus
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

# the k = 1000 row of emvb-lotte-k1000 (n_filter, n_docs, k)
ROW = (2000, 1000, 1000)
BUDGET_CUT = 8
M, NBITS, D, N_Q = 32, 8, 128, 32
CORPORA = {   # name: (n_docs, cap, min_len)
    "cap160": (640, 160, 96),
    "cap300": (400, 300, 100),
}
UNFUSED = dict(fused_prefilter=False, fused_late_interaction=False)


def small_budgets(n_filter, n_docs, k):
    """The row's budgets over a small corpus: each cut by ``BUDGET_CUT``,
    kept ``n_filter > n_docs >= k >= 1``."""
    k = max(1, k // BUDGET_CUT)
    n_docs = max(k, n_docs // BUDGET_CUT)
    return dict(n_filter=max(n_docs + 1, n_filter // BUDGET_CUT),
                n_docs=n_docs, k=k)


KW = dict(n_q=N_Q, nprobe=4, th=0.4, th_r=0.5, **small_budgets(*ROW))


@pytest.fixture(scope="module", params=sorted(CORPORA))
def lotte(request, tmp_path_factory):
    """(reference index, port index, queries (4, n_q, d))."""
    n_docs, cap, min_len = CORPORA[request.param]
    c = make_ood_corpus(0, n_docs=n_docs, cap=cap, min_len=min_len, d=D,
                        n_topics=16, n_queries=4, n_q=N_Q)
    ref, meta = build_index(jax.random.PRNGKey(0), c.doc_embs, c.doc_lens,
                            n_centroids=128, m=M, nbits=NBITS,
                            kmeans_iters=2, pq_train_size=4096,
                            use_opq=True)
    path = tmp_path_factory.mktemp("lotte") / "idx"
    port, _ = tstore.load_index(rstore.save_index(str(path), ref, meta),
                                device="cpu")
    return ref, port, np.asarray(c.queries, np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_index_has_the_deployment_shape(lotte):
    ref, port, _ = lotte
    r = np.asarray(ref.opq_rotation, np.float64)
    assert port.res_codes.shape[-1] == M and port.codes.shape[1] >= 160
    assert not np.allclose(r, np.eye(D), atol=1e-3)      # a real rotation
    np.testing.assert_allclose(r @ r.T, np.eye(D), atol=1e-4)
    np.testing.assert_array_equal(port.opq_rotation.numpy(),
                                  np.asarray(ref.opq_rotation))
    assert KW["n_filter"] < port.codes.shape[0]


def test_query_products_equal_the_reference(lotte):
    ref, port, q = lotte
    tq = torch.from_numpy(q)
    cs = jax.vmap(lambda x: reng.centroid_scores(x, ref.centroids))(
        jnp.asarray(q))
    rot = jax.vmap(lambda x: x @ ref.opq_rotation)(jnp.asarray(q))
    lut = jax.vmap(lambda x: ref_build_lut(x, ref.pq))(rot)
    np.testing.assert_array_equal(
        _bits(teng.centroid_scores(tq, port.centroids)), _bits(cs))
    np.testing.assert_array_equal(_bits(torch.matmul(tq, port.opq_rotation)),
                                  _bits(rot))
    np.testing.assert_array_equal(_bits(teng._query_lut(port, tq)),
                                  _bits(lut))


def test_retrieve_equals_the_reference(lotte):
    ref, port, q = lotte
    want = reng.retrieve(ref, jnp.asarray(q),
                         reng.EngineConfig(**KW, use_kernels=True))
    tq = torch.from_numpy(q)
    tops.reset_launches()
    for over in ({}, UNFUSED):
        got = teng.retrieve(port, tq, teng.EngineConfig(
            **KW, use_kernels=True, **over), device="cpu")
        np.testing.assert_array_equal(got.doc_ids.numpy(),
                                      np.asarray(want.doc_ids))
        np.testing.assert_array_equal(_bits(got.scores),
                                      _bits(want.scores))
    assert set(tops.launch_counts().values()) == {0}   # no CPU launch
    assert np.isfinite(np.asarray(want.scores)).all()
