"""The port's distributed serving plan (``repro_torch.launch.serve``)
against the reference's (``repro.launch.serve``), on the CPU over gloo.

* ``shard_index`` equals the reference's field by field at S in {1, 2, 4}
  (views of the index's per-doc fields, local IVFs in the global lists'
  order), neither warns of an overflow, and a doc count that does not
  split raises;
* S = 1 (a one-rank gloo group in this process) equals the reference's
  ``make_shardmap_retriever`` on a 1 x 1 mesh, ids and score bits, on the
  reference math and both kernel lanes, unmasked, with term masks and with
  a predicate filter: the reference's CS and LUT are injected (patched over
  ``engine.centroid_scores`` and ``engine._query_lut``, hazard 3);
* S in {2, 4}: four spawned gloo ranks (:func:`_rank_main`; one spawn)
  equal the reference's two-level top-k composed from its
  ``shard_index``, a ``retrieve`` per shard and ``lax.top_k``, as
  tests/test_serve_distributed.py composes it, ids and score bits, on every
  rank and every lane (the reference composed on its reference-math lane,
  which its own tests hold equal to its kernel lanes on float32 CS);
* ``make_timeline_retriever`` and ``make_service`` equal the port's
  ``retrieve_timeline`` and ``RetrievalService`` cold and warm, and
  ``retrieve_pjit`` is ``retrieve``.
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import build_index
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.bitvector import Pred as RPred
from repro.core.bitvector import compile_filter as rcompile
from repro.core.pq import build_lut as ref_build_lut
from repro.data.synthetic import make_corpus
from repro.launch import serve as rserve
from repro_torch.core import ShardedTimeline, new_generation
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.core.bitvector import Pred as TPred
from repro_torch.core.bitvector import compile_filter as tcompile
from repro_torch.launch import serve as tserve
from repro_torch.serving import RetrievalService

torch.set_num_threads(1)

# tests/test_serve_distributed.py's config
CFG = teng.EngineConfig(nprobe=8, th=0.3, th_r=0.4, n_filter=64, n_docs=16,
                        k=10)
CFGS = {"ref": CFG,
        "fused": dataclasses.replace(CFG, use_kernels=True),
        "unfused": dataclasses.replace(CFG, use_kernels=True,
                                       fused_prefilter=False,
                                       fused_late_interaction=False)}
CASES = ("plain", "masked", "filtered")
N_Q = 6


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def rcfg_of(cfg):
    return reng.EngineConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(5, n_docs=400, cap=24, min_len=8, n_queries=12,
                       n_topics=32)


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """The reference's index with a predicate plane, saved; the port's load
    of it; the path."""
    rng = np.random.default_rng(7)
    n = corpus.doc_embs.shape[0]
    preds = {"lang_en": rng.random(n) < 0.7, "recent": rng.random(n) < 0.4}
    idx, meta = build_index(jax.random.PRNGKey(0), corpus.doc_embs,
                            corpus.doc_lens, n_centroids=128, m=8, nbits=4,
                            kmeans_iters=3, predicates=preds)
    path = rstore.save_index(str(tmp_path_factory.mktemp("dist") / "ix"),
                             idx, meta)
    tidx, tmeta = tstore.load_index(path, device="cpu")
    return idx, meta, tidx, tmeta, path


@jax.jit
def _ref_cs_lut(index, q):
    cs = jax.vmap(lambda x: reng.centroid_scores(x, index.centroids))(q)
    q_rot = jax.vmap(lambda x: x @ index.opq_rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, index.pq))(q_rot)
    return cs, lut


@pytest.fixture(scope="module")
def queries(corpus, saved):
    """N_Q queries, a term mask with dead tail terms, and the reference's
    CS and LUT for them."""
    q = np.array(corpus.queries[:N_Q], np.float32)
    qm = np.ones(q.shape[:2], bool)
    qm[:, 24:] = False
    q[~qm] = 0.0
    cs, lut = _ref_cs_lut(saved[0], jnp.asarray(q))
    return dict(q=q, qm=qm, cs=np.array(cs), lut=np.array(lut))


@pytest.fixture
def inject(monkeypatch, queries):
    monkeypatch.setattr(teng, "centroid_scores",
                        lambda q, c, dtype="float32": torch.from_numpy(
                            queries["cs"][:q.shape[0]].copy()))
    monkeypatch.setattr(teng, "_query_lut", lambda index, q: torch.from_numpy(
        queries["lut"][:q.shape[0]].copy()))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group in this process."""
    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    yield None
    dist.destroy_process_group()


def _ref_kwargs(case, qb, meta):
    if case == "masked":
        return dict(q_masks=jnp.asarray(qb["qm"]))
    if case == "filtered":
        return dict(doc_filter=rcompile(RPred("lang_en") & ~RPred("recent"),
                                        meta.pred_names))
    return {}


def _port_kwargs(case, qb, meta):
    if case == "masked":
        return dict(q_masks=torch.from_numpy(qb["qm"]))
    if case == "filtered":
        return dict(doc_filter=tcompile(TPred("lang_en") & ~TPred("recent"),
                                        meta.pred_names))
    return {}


# ---------------------------------------------------------------------------
# shard_index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_index_equals_reference(saved, n_shards):
    idx, _, tidx, _, _ = saved
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = rserve.shard_index(idx, n_shards)
        got = tserve.shard_index(tidx, n_shards, device="cpu")
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert tuple(g.shape) == w.shape, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    per = tidx.codes.shape[0] // n_shards
    assert got.codes[n_shards - 1].data_ptr() == \
        tidx.codes[(n_shards - 1) * per].data_ptr()   # a view
    with pytest.raises(ValueError, match="shard multiple"):
        tserve.shard_index(tidx, 3, device="cpu")


# ---------------------------------------------------------------------------
# S = 1 against the reference's shard_map plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("case", CASES)
def test_one_rank_equals_reference_shardmap(saved, queries, inject, group,
                                            name, case):
    idx, meta, tidx, tmeta, _ = saved
    cfg = CFGS[name]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step = rserve.make_shardmap_retriever(mesh, rcfg_of(cfg))
    with mesh:
        want = step(rserve.shard_index(idx, 1), jnp.asarray(queries["q"]),
                    **_ref_kwargs(case, queries, meta))
    run = tserve.make_shardmap_retriever(group, cfg, device="cpu")
    got = run(tserve.shard_index(tidx, 1, device="cpu"),
              torch.from_numpy(queries["q"]),
              **_port_kwargs(case, queries, tmeta))
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(bits(got.scores), bits(want.scores))
    # one rank is retrieve on the whole index
    kw = _port_kwargs(case, queries, tmeta)
    one = tserve.retrieve_pjit(group, tidx, torch.from_numpy(queries["q"]),
                               cfg, device="cpu", **kw)
    np.testing.assert_array_equal(one.doc_ids.numpy(), got.doc_ids.numpy())
    np.testing.assert_array_equal(bits(one.scores), bits(got.scores))


# ---------------------------------------------------------------------------
# S in {2, 4}: spawned gloo ranks against the reference's two-level top-k
# ---------------------------------------------------------------------------

def _inject(cs: np.ndarray, lut: np.ndarray) -> None:
    """The reference's CS and LUT for the test's queries in place of the
    port's two matmuls, in a spawned rank (no monkeypatch there)."""
    teng.centroid_scores = lambda q, centroids, dtype="float32": \
        torch.from_numpy(cs[:q.shape[0]].copy())
    teng._query_lut = lambda index, q: torch.from_numpy(
        lut[:q.shape[0]].copy())


def _rank_main(rank: int, world: int, init_file: str, index_path: str,
               out_dir: str, arrays: dict, cfgs: dict) -> None:
    """One spawned rank: joins a gloo group through a file, loads the
    saved index, takes the reference's CS and LUT, and runs
    make_shardmap_retriever on the whole group (S = world) and on its pair
    of ranks (S = 2), unmasked, masked and filtered; every result goes to
    ``<out_dir>/rank<r>.npz``."""
    from repro_torch.core import store as tstore
    from repro_torch.core.bitvector import Pred, compile_filter
    from repro_torch.launch.serve import make_shardmap_retriever, shard_index
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    pairs = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
    groups = {world: None, 2: pairs[rank // 2]}
    index, meta = tstore.load_index(index_path, device="cpu")
    _inject(arrays["cs"], arrays["lut"])
    plan = compile_filter(Pred("lang_en") & ~Pred("recent"), meta.pred_names)
    q, qm = torch.from_numpy(arrays["q"]), torch.from_numpy(arrays["qm"])
    cases = {"plain": dict(), "masked": dict(q_masks=qm),
             "filtered": dict(doc_filter=plan)}
    out = {}
    for n_shards, group in groups.items():
        stacked = shard_index(index, n_shards, device="cpu")
        for name, cfg in cfgs.items():
            run = make_shardmap_retriever(group, cfg, device="cpu")
            for case, kw in cases.items():
                r = run(stacked, q, **kw)
                key = f"S{n_shards}-{name}-{case}"
                out[key + "-ids"] = r.doc_ids.numpy()
                out[key + "-scores"] = r.scores.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _ref_two_level(idx, q, rcfg, n_shards, **kw):
    """tests/test_serve_distributed.py's composition: the reference's
    shard_index, retrieve per shard, the shards' top-k concatenated
    shard-major and cut by lax.top_k."""
    st = rserve.shard_index(idx, n_shards)
    per = idx.codes.shape[0] // n_shards
    sc, ids = [], []
    for s in range(n_shards):
        local = jax.tree.map(lambda x: x[s], st)
        r = reng.retrieve(local, q, rcfg, **kw)
        sc.append(r.scores)
        ids.append(r.doc_ids + s * per)
    top, pos = jax.lax.top_k(jnp.concatenate(sc, 1), rcfg.k)
    return np.asarray(top), np.asarray(
        jnp.take_along_axis(jnp.concatenate(ids, 1), pos, axis=1))


def test_gloo_ranks_equal_reference_two_level_topk(saved, queries,
                                                   tmp_path):
    idx, meta, _, _, path = saved
    world = 4
    mp.spawn(_rank_main,
             args=(world, str(tmp_path / "init"), path, str(tmp_path),
                   queries, CFGS), nprocs=world, join=True)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for n_shards in (2, world):
        for case in CASES:
            want_sc, want_ids = _ref_two_level(
                idx, jnp.asarray(queries["q"]), rcfg_of(CFG), n_shards,
                **_ref_kwargs(case, queries, meta))
            for name in CFGS:
                key = f"S{n_shards}-{name}-{case}"
                for r in ranks:
                    np.testing.assert_array_equal(r[key + "-ids"], want_ids,
                                                  err_msg=key)
                    np.testing.assert_array_equal(
                        bits(r[key + "-scores"]), bits(want_sc),
                        err_msg=key)


# ---------------------------------------------------------------------------
# Timelines and the service on the sharded plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def timeline(corpus):
    """Two generations built by the port on the CPU (200 + 200 docs)."""
    from repro_torch.core import build_index as tbuild
    c = corpus
    idx0, m0 = tbuild(0, c.doc_embs[:200], c.doc_lens[:200],
                      n_centroids=128, m=8, nbits=4, kmeans_iters=3,
                      device="cpu")
    return ShardedTimeline.of((idx0, m0)).append(*new_generation(
        idx0, m0, c.doc_embs[200:], c.doc_lens[200:], device="cpu"))


@pytest.mark.parametrize("name", ["ref", "fused"])
def test_timeline_retriever_and_service(corpus, timeline, group, name):
    cfg = CFGS[name]
    q = np.asarray(corpus.queries[:8], np.float32)
    want = teng.retrieve_timeline(timeline, q, cfg, device="cpu")
    run = tserve.make_timeline_retriever(group, cfg, timeline, device="cpu")
    got = run(q)
    np.testing.assert_array_equal(got.doc_ids.numpy(), want.doc_ids.numpy())
    np.testing.assert_array_equal(bits(got.scores), bits(want.scores))
    qm = np.ones(q.shape[:2], bool)
    qm[:, 20:] = False
    got = run(q, qm)
    want = teng.retrieve_timeline(timeline, q, cfg, qm, device="cpu")
    np.testing.assert_array_equal(got.doc_ids.numpy(), want.doc_ids.numpy())
    ref_svc = RetrievalService(timeline, cfg, device="cpu")
    svc = tserve.make_service(group, cfg, timeline, device="cpu")
    for _ in range(2):      # cold, then warm
        a, b = svc.query(q), ref_svc.query(q)
        np.testing.assert_array_equal(a.doc_ids.numpy(), b.doc_ids.numpy())
        np.testing.assert_array_equal(bits(a.scores), bits(b.scores))
    assert svc.cache.stats() == ref_svc.cache.stats()
    assert svc.cache.hits == 8          # warm: generation 0 is immutable
    # a swap re-shards only the new generation
    grown = tstore.add_passages(timeline.generations[1], timeline.metas[1],
                                corpus.doc_embs[:4], corpus.doc_lens[:4],
                                device="cpu")
    tl2 = ShardedTimeline(timeline.generations[:1] + (grown[0],),
                          timeline.metas[:1] + (grown[1],))
    svc.update_timeline(tl2)
    np.testing.assert_array_equal(
        svc.query(q).doc_ids.numpy(),
        teng.retrieve_timeline(tl2, q, cfg, device="cpu").doc_ids.numpy())
