"""Query-term pruning: ``repro_torch.core.engine.prune_queries`` against
``repro.core.engine.prune_queries``. The selection is ``lax.top_k``'s
(descending importance, the lower term first on ties), re-sorted to term
order, and the mask marks zero embeddings among the kept terms.

The default importance is each term's L2 norm, whose last bits depend on
the framework's reduction order, so the default is held on terms whose
norms are well apart (and on zero-padded terms, whose norm is exactly 0);
an injected importance, ties included, holds the selection itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro_torch.core import engine as teng
from repro_torch.core.index import index_from_arrays

torch.set_num_threads(1)


def _queries(seed, shape, pad=0):
    """(..., n_q, d) terms whose norms are well apart (term i scaled by a
    distinct factor), the last ``pad`` terms zero."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    n_q = shape[-2]
    scale = rng.permutation(n_q).astype(np.float32) * 0.5 + 1.0
    q *= scale[:, None]
    if pad:
        q[..., -pad:, :] = 0.0
    return q


def _same(port, ref):
    np.testing.assert_array_equal(port[0].numpy().view(np.uint32),
                                  np.asarray(ref[0]).view(np.uint32))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("shape,keep,pad", [
    ((3, 32, 16), 20, 0),
    ((3, 32, 16), 20, 15),      # pads outnumber the dropped terms
    ((2, 8, 4), 8, 3),          # keep == n_q: the identity
    ((32, 16), 5, 0),           # one query, no batch axis
])
def test_prune_by_norm_matches_reference(shape, keep, pad):
    q = _queries(keep, shape, pad)
    got = teng.prune_queries(torch.from_numpy(q), keep, device="cpu")
    _same(got, reng.prune_queries(jnp.asarray(q), keep))
    assert got[0].shape == (*shape[:-2], keep, shape[-1])
    if keep == shape[-2]:
        assert torch.equal(got[0], torch.from_numpy(q))
    if pad > shape[-2] - keep:
        assert not got[1].all()


@pytest.mark.parametrize("levels", [3, 100])
def test_prune_by_injected_importance_matches_reference(levels):
    """Importance with many ties (3 levels), zero and negative values on
    real terms: the selection breaks ties toward the lower term, and the
    mask follows the embedding's norm, never the importance's sign."""
    rng = np.random.default_rng(levels)
    q = _queries(levels, (4, 32, 8), pad=4)
    imp = (rng.integers(-1, levels - 1, size=(4, 32)) / 2).astype(np.float32)
    got = teng.prune_queries(torch.from_numpy(q), 12, torch.from_numpy(imp),
                             device="cpu")
    _same(got, reng.prune_queries(jnp.asarray(q), 12, jnp.asarray(imp)))


def test_prune_refuses_keep_above_n_q():
    with pytest.raises(ValueError, match="keep=9 exceeds n_q=8"):
        teng.prune_queries(torch.zeros(2, 8, 4), 9, device="cpu")


def test_pruned_queries_retrieve_as_the_reference(small_corpus, small_index):
    """Pruned queries (an injected importance: these queries' norms are
    all about 1) and their mask through retrieve at n_q = keep, on the
    fused kernel lane: the reference's ids and score bits."""
    ref, _ = small_index
    port = index_from_arrays({f: np.asarray(getattr(ref, f))
                              for f in ref._fields}, device="cpu")
    q = np.array(small_corpus.queries[:3], np.float32)
    q[:, -6:] = 0.0
    kw = dict(n_q=20, nprobe=4, th=0.3, th_r=0.4, n_filter=64, n_docs=16,
              k=10, use_kernels=True)
    imp = np.stack([np.random.default_rng(b).permutation(32)
                    for b in range(3)]).astype(np.float32)
    rq, rm = reng.prune_queries(jnp.asarray(q), 20, jnp.asarray(imp))
    tq, tm = teng.prune_queries(torch.from_numpy(q), 20,
                                torch.from_numpy(imp), device="cpu")
    assert not tm.all()
    _same((tq, tm), (rq, rm))
    want = reng.retrieve(ref, rq, reng.EngineConfig(**kw), rm)
    got = teng.retrieve(port, tq, teng.EngineConfig(**kw), tm, device="cpu")
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.scores.numpy().view(np.uint32),
                                  np.asarray(want.scores).view(np.uint32))
