"""The port's online maintenance (``repro_torch.serving.maintenance`` and
the store/engine primitives it drives), case for case with
tests/test_maintenance.py:

* ``merge_generations`` compaction is bit-exact under cut-lossless budgets
  on the reference-math lane and every kernel lane;
* ``MaintenancePolicy.decide`` returns the reference's actions on the same
  timelines (drift over merge, hierarchical same-tier merges, the size
  bound);
* ``reepoch_tail`` opens a fresh codebook epoch over the drifted tail,
  trained by the port's ``build_index`` from a seed, preserving global ids;
* the loop against a live ``RetrievalService``: merges and re-epochs hot
  swap (deferred behind a pending ticket), the served results equal
  ``retrieve_timeline`` on the new snapshot, untouched generations keep
  their cache entries.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as rindex
from repro.core import store as rstore
from repro.data.synthetic import make_corpus
from repro import serving as rserving
from repro_torch.core import (EngineConfig, EpochedTimeline, ShardedTimeline,
                              build_index, index_fingerprint,
                              merge_generations, new_generation,
                              retrieve_timeline, timeline_footprint)
from repro_torch.core.engine import RetrievalResult, merge_partial_topk_by_rank
from repro_torch.serving import (MaintenancePolicy, MaintenanceRunner,
                                 RetrievalService, reepoch_tail)

torch.set_num_threads(1)

CFG = EngineConfig(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48, k=10)
LOSSLESS = EngineConfig(nprobe=8, th=0.2, th_r=0.4, n_filter=600, n_docs=600,
                        k=10)

MERGE_CFGS = {
    "math": LOSSLESS,
    "prefilter-megakernel": dataclasses.replace(
        LOSSLESS, use_kernels=True, fused_late_interaction=False),
    "pqinter-megakernel": dataclasses.replace(
        LOSSLESS, use_kernels=True, fused_prefilter=False),
    "fused": dataclasses.replace(LOSSLESS, use_kernels=True),
}


def assert_same(got, want):
    assert torch.equal(got.doc_ids, want.doc_ids)
    assert torch.equal(got.scores.view(torch.int32),
                       want.scores.view(torch.int32))


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(7, n_docs=600, cap=24, min_len=8, n_queries=16,
                       n_topics=24)


@pytest.fixture(scope="module")
def timeline(corpus):
    """Three generations of 200 docs sharing gen 0's frozen codebooks,
    built by the port on the CPU."""
    c = corpus
    idx0, m0 = build_index(0, c.doc_embs[:200], c.doc_lens[:200],
                           n_centroids=128, m=8, nbits=4, kmeans_iters=3,
                           device="cpu")
    tl = ShardedTimeline.of((idx0, m0))
    for lo, hi in ((200, 400), (400, 600)):
        tl = tl.append(*new_generation(idx0, m0, c.doc_embs[lo:hi],
                                       c.doc_lens[lo:hi], device="cpu"))
    return tl


# ---------------------------------------------------------------------------
# Compaction: merge_generations is bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MERGE_CFGS))
def test_merge_generations_bit_exact(corpus, timeline, name):
    cfg = MERGE_CFGS[name]
    q = corpus.queries[:8]
    ref = retrieve_timeline(timeline, q, cfg, device="cpu")
    merged = merge_generations(timeline, 0, len(timeline))
    assert len(merged) == 1
    assert_same(retrieve_timeline(merged, q, cfg, device="cpu"), ref)


def test_merge_generations_partial_ranges(corpus, timeline):
    q = corpus.queries[:8]
    ref = retrieve_timeline(timeline, q, LOSSLESS, device="cpu")
    for lo, hi in ((0, 2), (1, 3)):
        merged = merge_generations(timeline, lo, hi)
        assert len(merged) == 2
        assert_same(retrieve_timeline(merged, q, LOSSLESS, device="cpu"),
                    ref)
    untouched = merge_generations(timeline, 0, 2)
    assert untouched.fingerprints[-1] == timeline.fingerprints[-1]
    assert untouched.fingerprints[0] not in timeline.fingerprints


def test_merge_generations_meta_accounting(timeline):
    m = merge_generations(timeline, 1, 3)
    assert m.metas[1].n_docs == 400
    assert m.n_docs == timeline.n_docs
    assert m.offsets == (0, 200)
    assert m.metas[1].n_grown == 400
    assert m.metas[1].train_quant_mse == timeline.metas[1].train_quant_mse
    full = merge_generations(timeline, 0, 3)
    assert full.metas[0].n_grown == 400
    assert full.metas[0].n_docs == 600


def test_merge_generations_validation(timeline):
    with pytest.raises(ValueError, match="single generation"):
        merge_generations(timeline, 0, 1)
    with pytest.raises(ValueError, match="not a valid"):
        merge_generations(timeline, 2, 1)
    with pytest.raises(ValueError, match="not a valid"):
        merge_generations(timeline, 0, 5)
    with pytest.raises(ValueError, match="not a valid"):
        merge_generations(timeline, 0.0, 2)


# ---------------------------------------------------------------------------
# Policy: drift > merge > size bound, as the reference decides
# ---------------------------------------------------------------------------

def _with_drift(tl: ShardedTimeline, gen: int,
                ratio: float) -> ShardedTimeline:
    """A copy of ``tl`` whose ``gen``-th meta reports the given drift."""
    metas = list(tl.metas)
    metas[gen] = dataclasses.replace(
        metas[gen], n_grown=max(metas[gen].n_grown, 1),
        train_quant_mse=1.0, grown_quant_mse=float(ratio))
    return ShardedTimeline(tl.generations, tuple(metas))


def test_policy_validation():
    with pytest.raises(ValueError, match="merge_factor"):
        MaintenancePolicy(merge_factor=1)
    with pytest.raises(ValueError, match="max_frozen_generations"):
        MaintenancePolicy(max_frozen_generations=0)
    with pytest.raises(ValueError, match="drift_threshold"):
        MaintenancePolicy(drift_threshold=1.0)


def test_policy_tiers():
    p = MaintenancePolicy(merge_factor=4)
    assert p.tier(1) == 0 and p.tier(3) == 0
    assert p.tier(4) == 1 and p.tier(15) == 1
    assert p.tier(16) == 2 and p.tier(200) == 3


def test_policy_drift_outranks_merge(timeline):
    p = MaintenancePolicy(merge_factor=2, drift_threshold=1.5)
    a = p.decide(_with_drift(timeline, 1, 2.0))
    assert a.kind == "reepoch" and (a.lo, a.hi) == (1, 3)
    assert "drift" in a.reason
    a2 = p.decide(timeline)
    assert a2.kind == "merge" and (a2.lo, a2.hi) == (0, 2)


def test_policy_hierarchical_and_size_bound(timeline):
    p = MaintenancePolicy(merge_factor=4, max_frozen_generations=1)
    a = p.decide(timeline)
    assert a.kind == "merge" and (a.lo, a.hi) == (0, 2)
    assert "frozen" in a.reason
    assert MaintenancePolicy(merge_factor=4,
                             max_frozen_generations=8).decide(timeline) \
        is None
    a3 = MaintenancePolicy(merge_factor=2).decide(timeline)
    assert a3.kind == "merge" and (a3.lo, a3.hi) == (0, 2)
    assert "tier" in a3.reason


def test_policy_accepts_epoched(timeline):
    et = EpochedTimeline.of(timeline)
    a = MaintenancePolicy(merge_factor=2).decide(et)
    assert a.kind == "merge" and (a.lo, a.hi) == (0, 2)


def reference_copy(tl: ShardedTimeline):
    """The reference's ShardedTimeline of the same arrays and metas."""
    return rstore.ShardedTimeline(
        tuple(rindex.PackedIndex(**{f: jnp.asarray(getattr(g, f).numpy())
                                    for f in g._fields})
              for g in tl.generations),
        tuple(rindex.IndexMeta(**dataclasses.asdict(m)) for m in tl.metas))


def _shapes(timeline, corpus):
    """Timelines of every shape the policy tells apart: drifted at each
    generation, hierarchical runs, the size bound, nothing to do."""
    c = corpus
    idx0, m0 = timeline.generations[0], timeline.metas[0]
    small = [new_generation(idx0, m0, c.doc_embs[lo:lo + 12],
                            c.doc_lens[lo:lo + 12], device="cpu")
             for lo in range(200, 296, 12)]
    many = ShardedTimeline.of((idx0, m0), *small)
    return {"plain": timeline, "drift0": _with_drift(timeline, 0, 3.0),
            "drift1": _with_drift(timeline, 1, 1.6),
            "drift2_low": _with_drift(timeline, 2, 1.4),
            "many_small": many,
            "many_small_drift": _with_drift(many, 5, 2.0)}


POLICIES = {"default": {}, "pairs": dict(merge_factor=2),
            "bound1": dict(max_frozen_generations=1),
            "bound3_f3": dict(merge_factor=3, max_frozen_generations=3),
            "strict_drift": dict(drift_threshold=1.3)}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policy_decides_as_reference(timeline, corpus, policy):
    ref = rserving.MaintenancePolicy(**POLICIES[policy])
    got = MaintenancePolicy(**POLICIES[policy])
    for name, tl in _shapes(timeline, corpus).items():
        want = ref.decide(reference_copy(tl))
        have = got.decide(tl)
        assert (None if have is None else tuple(have)) == \
            (None if want is None else tuple(want)), name
        et_want = ref.decide(rstore.EpochedTimeline.of(reference_copy(tl)))
        assert tuple(got.decide(EpochedTimeline.of(tl)) or ()) == \
            tuple(et_want or ()), name


# ---------------------------------------------------------------------------
# Cross-epoch rank merge
# ---------------------------------------------------------------------------

def test_merge_by_rank_interleaves_newest_first():
    old = RetrievalResult(torch.tensor([[9.0, 8.0, 7.0]]),
                          torch.tensor([[0, 1, 2]], dtype=torch.int32))
    new = RetrievalResult(torch.tensor([[5.0, 4.0, 3.0]]),
                          torch.tensor([[100, 101, 102]], dtype=torch.int32))
    m = merge_partial_topk_by_rank([old, new], 4, device="cpu")
    assert m.doc_ids.tolist() == [[100, 0, 101, 1]]
    assert m.scores.tolist() == [[5.0, 9.0, 4.0, 8.0]]
    assert merge_partial_topk_by_rank([old], 3, device="cpu") is old


# ---------------------------------------------------------------------------
# Re-epoching: fresh codebooks, stable global ids
# ---------------------------------------------------------------------------

def test_reepoch_tail_structure(corpus, timeline):
    et = reepoch_tail(timeline, 1, corpus.doc_embs[200:600],
                      corpus.doc_lens[200:600], seed=1, device="cpu",
                      n_centroids=64, kmeans_iters=2)
    assert isinstance(et, EpochedTimeline) and len(et) == 2
    assert et.epoch_offsets == (0, 200)
    assert et.n_docs == 600 and et.n_generations == 2
    assert et.epochs[0].fingerprints == timeline.fingerprints[:1]
    new_meta = et.epochs[1].metas[0]
    assert new_meta.n_docs == 400 and new_meta.drift == 1.0
    assert new_meta.n_centroids == 64
    fp = timeline_footprint(et)
    assert fp["n_epochs"] == 2 and fp["n_docs"] == 600

    q = corpus.queries[:8]
    res = retrieve_timeline(et, q, CFG, device="cpu")
    ids = res.doc_ids.numpy()
    assert ids.shape == (8, CFG.k)
    assert np.all((ids >= 0) & (ids < 600))
    assert np.all(ids[:, 0] >= 200)
    new_only = retrieve_timeline(et.epochs[1], q, CFG, device="cpu")
    np.testing.assert_array_equal(ids[:, 0],
                                  new_only.doc_ids.numpy()[:, 0] + 200)
    again = reepoch_tail(timeline, 1, corpus.doc_embs[200:600],
                         corpus.doc_lens[200:600], seed=1, device="cpu",
                         n_centroids=64, kmeans_iters=2)
    assert again.epochs[1].fingerprints == et.epochs[1].fingerprints


def test_reepoch_tail_full_rebuild(corpus, timeline):
    et = reepoch_tail(timeline, 0, corpus.doc_embs[:600],
                      corpus.doc_lens[:600], seed=2, device="cpu",
                      n_centroids=64, kmeans_iters=2)
    assert len(et) == 1 and et.n_docs == 600
    assert len(et.epochs[0]) == 1


def test_reepoch_tail_validation(corpus, timeline):
    kw = dict(seed=3, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        reepoch_tail(timeline, 3, corpus.doc_embs[:0], corpus.doc_lens[:0],
                     **kw)
    with pytest.raises(ValueError, match="EXACTLY the tail"):
        reepoch_tail(timeline, 1, corpus.doc_embs[200:500],
                     corpus.doc_lens[200:500], **kw)
    with pytest.raises(ValueError, match="do not match"):
        reepoch_tail(timeline, 1, corpus.doc_embs[100:500],
                     corpus.doc_lens[100:500], **kw)
    with pytest.raises(ValueError, match="expected"):
        reepoch_tail(timeline, 1, corpus.doc_embs[200:600, :, :64],
                     corpus.doc_lens[200:600], **kw)
    with pytest.raises(TypeError, match="lo must be an int"):
        reepoch_tail(timeline, 1.0, corpus.doc_embs[200:600],
                     corpus.doc_lens[200:600], **kw)


# ---------------------------------------------------------------------------
# The maintenance loop against a live service
# ---------------------------------------------------------------------------

def test_runner_merges_through_hot_swap(corpus, timeline):
    svc = RetrievalService(timeline, CFG, device="cpu")
    q = corpus.queries[:8]
    svc.query(q)
    runner = MaintenanceRunner(svc, MaintenancePolicy(merge_factor=2))
    applied = runner.run_once()
    assert [a.kind for a in applied] == ["merge"]
    assert len(svc.timeline) == 2 and svc.timeline.n_docs == 600
    assert svc.metrics.merges == 1 and svc.metrics.swaps == 1
    assert svc.metrics.deferred_swaps == 0
    assert_same(svc.query(q),
                retrieve_timeline(svc.timeline, q, CFG, device="cpu"))
    assert runner.run_once() == []


def test_runner_requires_fetcher_for_reepoch(timeline):
    svc = RetrievalService(_with_drift(timeline, 0, 9.0), CFG, device="cpu")
    runner = MaintenanceRunner(
        svc, MaintenancePolicy(merge_factor=4, max_frozen_generations=8))
    with pytest.raises(RuntimeError, match="fetch_embeddings"):
        runner.run_once()


@pytest.fixture(scope="module")
def drift_stream():
    c = make_corpus(5, n_docs=256, cap=16, min_len=8, n_queries=4,
                    n_topics=16, token_noise=0.05)
    idx0, m0 = build_index(0, c.doc_embs[:128], c.doc_lens[:128],
                           n_centroids=32, m=8, nbits=4, kmeans_iters=3,
                           device="cpu")
    rng = np.random.default_rng(99)
    ood_embs = rng.normal(size=(64, m0.cap, m0.d)).astype(np.float32)
    ood_embs /= np.linalg.norm(ood_embs, axis=-1, keepdims=True)
    ood_lens = np.full(64, m0.cap, np.int32)
    return c, idx0, m0, ood_embs, ood_lens


def run_drift_stream(drift_stream, build_seed):
    """The reference's drift stream on the port: an in-domain service
    grows an out-of-distribution generation, the runner re-epochs it with
    a pending ticket forcing a staged swap. -> (service, runner, ticket,
    queries, cache hits before the re-epoch)."""
    c, idx0, m0, ood_embs, ood_lens = drift_stream
    all_embs = np.concatenate([c.doc_embs[:128], ood_embs])
    all_lens = np.concatenate([c.doc_lens[:128], ood_lens])
    svc = RetrievalService(ShardedTimeline.of((idx0, m0)), CFG,
                           device="cpu")
    q = c.queries
    before = svc.query(q)
    assert before.doc_ids.max() < 128
    svc.new_generation(ood_embs, ood_lens)
    assert svc.timeline.metas[-1].drift > 1.5
    svc.query(q)
    svc.query(q)
    hits0 = svc.cache.hits
    runner = MaintenanceRunner(
        svc, MaintenancePolicy(),
        fetch_embeddings=lambda a, b: (all_embs[a:b], all_lens[a:b]),
        build_seed=build_seed,
        build_kwargs=dict(n_centroids=32, kmeans_iters=3))
    ticket = svc.submit(c.queries[0])
    applied = runner.run_once()
    assert [a.kind for a in applied] == ["reepoch"]
    return svc, runner, ticket, q, hits0


def test_drift_stream_end_to_end(drift_stream):
    svc, runner, ticket, q, hits0 = run_drift_stream(drift_stream, 3)
    assert svc.metrics.reepochs == 1
    assert len(svc.epoched) == 1              # still serving the old snap
    assert len(svc.latest_timeline) == 2      # the re-epoched one is staged
    assert not ticket.done
    svc.flush()
    assert ticket.done
    assert len(svc.epoched) == 2
    assert svc.metrics.swaps >= 1 and svc.metrics.deferred_swaps == 1
    new_epoch = svc.epoched.epochs[-1]
    assert new_epoch.metas[0].drift == 1.0 and new_epoch.n_docs == 64
    assert runner.run_once() == []
    after = svc.query(q)
    ids = after.doc_ids.numpy()
    assert ids.shape == (4, CFG.k) and np.all((ids >= 0) & (ids < 192))
    assert svc.cache.hits >= hits0 + 4
    # the epoched service equals retrieve_timeline on its snapshot, warm too
    want = retrieve_timeline(svc.epoched, q, CFG, device="cpu")
    assert_same(after, want)
    assert_same(svc.query(q), want)


def test_reepoch_is_deterministic_per_seed(drift_stream):
    a = run_drift_stream(drift_stream, 11)[0]
    b = run_drift_stream(drift_stream, 11)[0]
    c = run_drift_stream(drift_stream, 12)[0]
    for s in (a, b, c):
        s.flush()
    fa, fb, fc = (index_fingerprint(s.epoched.epochs[-1].generations[0])
                  for s in (a, b, c))
    assert fa == fb != fc
