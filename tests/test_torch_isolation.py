"""The port stands alone: every module of ``repro_torch`` and ``chip_smoke``
import with ``jax`` and ``repro`` blocked; entry points refuse to run on the
CPU unless asked; the planted synthetic generator is deterministic per seed
and its IVF is the reference's ``_build_ivf`` layout."""
import dataclasses
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro.core.index import _build_ivf
from repro_torch.core import engine as teng
from repro_torch.core import index as tindex
from repro_torch.core import kmeans
from repro_torch.core import pq as tpq
from repro_torch.core import store as tstore
from repro_torch.core.index import build_ivf, index_from_arrays
from repro_torch.data import synthetic
from repro_torch.serving import RetrievalService, reepoch_tail

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_port_imports_without_jax_or_repro():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for name in ("repro_torch.kernels.prefilter", "repro_torch.models.colbert",
                 "repro_torch.models.transformer", "repro_torch.models.layers",
                 "repro_torch.train.trainer", "repro_torch.train.optimizer",
                 "repro_torch.train.checkpoint",
                 "repro_torch.train.compression",
                 "repro_torch.models.flat", "repro_torch.models.gcn",
                 "repro_torch.models.sampler",
                 "repro_torch.models.recsys.embedding_bag",
                 "repro_torch.models.recsys.mind",
                 "repro_torch.models.recsys.dlrm",
                 "repro_torch.models.recsys.dcn",
                 "repro_torch.models.recsys.dien",
                 "repro_torch.configs.registry", "repro_torch.configs.mind",
                 "repro_torch.configs.emvb_msmarco",
                 "repro_torch.configs.kimi_k2_1t",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.launch.steps", "repro_torch.launch.modelflops",
                 "repro_torch.launch.analysis", "repro_torch.launch.op_stats",
                 "repro_torch.launch.dryrun", "repro_torch.kernels._meta",
                 "repro_torch.sharding.rules",
                 "repro_torch.sharding.recsys_rules"):
        assert name in modules, name
    code = textwrap.dedent(f"""
        import importlib, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path[:0] = [{os.path.join(ROOT, "src")!r}, {ROOT!r}]
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules), "a blocked package got in"
        print("ok", len(sys.modules))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_every_module_imports_first():
    """Each module of the port imports on its own, as the first of the
    package to load (a kernel module first caught an import cycle through
    ``core/__init__.py``)."""
    modules = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for name in ("repro_torch.core.plaid", "repro_torch.obs.explain",
                 "repro_torch.launch", "repro_torch.launch.serve",
                 "repro_torch.launch.train", "repro_torch.configs.dcn_v2",
                 "repro_torch.models.recsys.dlrm", "repro_torch.models.gcn"):
        assert name in modules, name
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path[:0] = [{os.path.join(ROOT, "src")!r}]
        for name in {modules!r}:
            for m in [m for m in sys.modules if m.startswith("repro_torch")]:
                del sys.modules[m]
            importlib.import_module(name)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _port_sources() -> list:
    """Every Python source of the port: the package, chip_smoke.py, the
    card scripts beside it and the port's examples."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "examples", f"{n}_torch.py") for n in (
        "train_colbert", "mind_emvb_retrieval", "quickstart",
        "serve_retrieval", "streaming_index", "retrieval_service")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    scripts = os.path.join(ROOT, "scripts")
    files += [os.path.join(scripts, n) for n in os.listdir(scripts)
              if n.startswith("chip_") and n.endswith(".py")]
    return sorted(files)


def test_port_sources_import_no_jax_or_repro():
    """No import statement anywhere in the port's sources, inside functions
    too (which importing the modules does not run), names jax or the JAX
    package."""
    import ast
    files = _port_sources()
    assert any(f.endswith(os.path.join("core", "bitvector.py"))
               for f in files)
    for sub in (("serving", "service.py"), ("serving", "maintenance.py"),
                ("serving", "cache.py"), ("obs", "trace.py"),
                ("obs", "registry.py"), ("obs", "explain.py"),
                ("core", "plaid.py"), ("launch", "__init__.py"),
                ("launch", "serve.py"), ("models", "colbert.py"),
                ("models", "transformer.py"), ("models", "layers.py"),
                ("train", "trainer.py"), ("train", "optimizer.py"),
                ("train", "checkpoint.py"), ("train", "compression.py"),
                ("models", "flat.py"), ("models", "gcn.py"),
                ("models", "sampler.py"), ("recsys", "embedding_bag.py"),
                ("recsys", "mind.py"), ("recsys", "dlrm.py"),
                ("recsys", "dcn.py"), ("recsys", "dien.py"),
                ("configs", "registry.py"), ("configs", "dlrm_mlperf.py"),
                ("configs", "qwen2p5_3b.py"), ("launch", "train.py"),
                ("examples", "mind_emvb_retrieval_torch.py"),
                ("examples", "quickstart_torch.py"),
                ("examples", "serve_retrieval_torch.py"),
                ("examples", "streaming_index_torch.py"),
                ("examples", "retrieval_service_torch.py"),
                ("launch", "mesh.py"), ("launch", "steps.py"),
                ("launch", "modelflops.py"), ("launch", "analysis.py"),
                ("launch", "op_stats.py"), ("launch", "dryrun.py"),
                ("kernels", "_meta.py"), ("sharding", "rules.py"),
                ("sharding", "recsys_rules.py")):
        assert any(f.endswith(os.path.join(*sub)) for f in files), sub
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, small_index,
                                                  tmp_path):
    ref, _ = small_index
    arrays = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    index = index_from_arrays(arrays, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 32, 128)
    cfg = teng.EngineConfig(n_filter=64, n_docs=16, k=10, use_kernels=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.retrieve(index, q, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        index_from_arrays(arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.make_packed_index(0, n_docs=10, cap=4, min_len=1, d=8,
                                    n_centroids=4, m=2, nbits=2, list_cap=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.load_index(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.prune_queries(q, 8)
    assert teng.retrieve(index, q, cfg, device="cpu").doc_ids.shape == (1, 10)
    meta = tstore.IndexMeta(**{**dataclasses.asdict(small_index[1])})
    tl = tstore.ShardedTimeline.of((index, meta))
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.retrieve_timeline(tl, q, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.load_timeline(str(tmp_path))
    docs = np.zeros((2, meta.cap, meta.d), np.float32)
    lens = np.array([3, 0], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.new_generation(index, meta, docs, lens)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.add_passages(index, meta, docs, lens)
    assert teng.retrieve_timeline(tl, q, cfg, device="cpu").doc_ids.shape \
        == (1, 10)
    gen, gmeta = tstore.new_generation(index, meta, docs, lens, device="cpu")
    assert gmeta.n_docs == 2 and gen.device.type == "cpu"
    assert tstore.add_passages(index, meta, docs, lens,
                               device="cpu")[1].n_docs == meta.n_docs + 2
    rows = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.kmeans(0, rows, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.kmeans_spherical(0, rows, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpq.train_pq(0, rows, 2, nbits=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpq.train_opq(0, rows, 2, nbits=2)
    embs = np.zeros((3, 4, 8), np.float32)
    embs[:, :, 0] = 1.0
    with pytest.raises(RuntimeError, match="CUDA"):
        tindex.build_index(0, embs, np.array([4, 2, 3]), n_centroids=2,
                           m=2, nbits=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalService(tl, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        reepoch_tail(tl, 0, docs, lens, seed=0)
    assert kmeans.kmeans(0, rows, 4, device="cpu")[0].shape == (4, 8)
    assert tindex.build_index(0, embs, np.array([4, 2, 3]), n_centroids=2,
                              m=2, nbits=2, device="cpu")[1].n_docs == 3
    assert RetrievalService(tl, cfg, device="cpu").query(
        q.numpy()).doc_ids.shape == (1, 10)
    from repro_torch.core import plaid
    from repro_torch.launch import serve
    from repro_torch.obs import explain
    pcfg = plaid.PlaidConfig(n_docs=16, k=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        plaid.retrieve(index, q, pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        explain.explain(index, q[0].numpy(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        explain.explain_timeline(tl, q[0].numpy(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_shardmap_retriever(None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.shard_index(index, 1)
    assert plaid.retrieve(index, q, pcfg, device="cpu").doc_ids.shape == \
        (1, 10)
    assert explain.explain(index, q[0].numpy(), cfg, device="cpu").k == 10
    assert explain.explain_timeline(tl, q[0].numpy(), cfg,
                                    device="cpu").k == 10
    assert serve.shard_index(index, 1, device="cpu").codes.shape[0] == 1
    from repro_torch import models
    from repro_torch.models import colbert, transformer
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg_m = colbert.make_config(n_layers=1, d_model=16, n_heads=2, d_head=8,
                                d_ff=32, vocab=50, out_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        colbert.ColBERT(cfg_m)
    with pytest.raises(RuntimeError, match="CUDA"):
        colbert.init_params(0, cfg_m)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(0, cfg_m)
    enc = colbert.ColBERT(cfg_m, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.params_from_reference(models.params_to_reference(enc), cfg_m)
    args = (lambda p, b: colbert.contrastive_loss(p, b, cfg_m),
            optimizer.make("adamw"), lambda step: {}, TrainerConfig(), enc)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(*args)
    assert Trainer(*args, device="cpu").state.params.device.type == "cpu"
    from repro_torch.configs import registry
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import gcn, sampler
    from repro_torch.models.recsys import dcn, dien, dlrm, mind
    for mod, arch in ((mind, "mind"), (dlrm, "dlrm-mlperf"), (dcn, "dcn-v2"),
                      (dien, "dien"), (gcn, "gcn-cora")):
        small = registry.get(arch).make_smoke_config()
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.init_params(0, small)
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.build_smoke_trainer(arch)
        model = mod.init_params(0, small, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            models.params_from_reference(models.params_to_reference(model),
                                         small)
        assert tlaunch.build_smoke_trainer(arch, device="cpu").run(1)[
            "final_step"] == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        sampler.pad_adjacency(np.array([0, 1]), np.array([0]), 1, 2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", "gcn-cora", "--steps", "1"])


TINY = dict(n_docs=700, cap=12, min_len=5, d=32, n_centroids=96, m=4,
            nbits=4, list_cap=None, device="cpu")


def test_synthetic_index_is_deterministic_and_ivf_matches():
    a, meta = synthetic.make_packed_index(3, **TINY)
    b, _ = synthetic.make_packed_index(3, **TINY)
    c, _ = synthetic.make_packed_index(4, **TINY)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.codes, c.codes)
    codes = a.codes.numpy()
    want = _build_ivf(codes, TINY["n_centroids"], None)
    np.testing.assert_array_equal(a.ivf.numpy(), want[0])
    np.testing.assert_array_equal(a.ivf_lens.numpy(), want[1])
    assert (meta.list_cap, meta.n_dropped) == want[2:]
    got = build_ivf(a.codes, TINY["n_centroids"], None)
    assert torch.equal(got[0], a.ivf)
    # the layout the reference index uses: pad = n_c past each length
    lens = a.doc_lens.numpy()
    assert ((codes == TINY["n_centroids"])
            == (np.arange(TINY["cap"]) >= lens[:, None])).all()
    assert lens.min() >= TINY["min_len"] and lens.max() <= TINY["cap"]
    assert a.res_codes.dtype == torch.uint8
    assert torch.equal(a.opq_rotation, torch.eye(TINY["d"]))
    assert not a.pred_words.any()


def test_planted_queries_find_their_docs():
    index, _ = synthetic.make_packed_index(5, **TINY)
    q, gt = synthetic.make_queries(index, 6, n_queries=8, n_q=16)
    q2, gt2 = synthetic.make_queries(index, 6, n_queries=8, n_q=16)
    assert torch.equal(q, q2) and torch.equal(gt, gt2)
    assert torch.allclose(q.norm(dim=-1), torch.ones(8, 16))
    cfg = teng.EngineConfig(n_q=16, n_filter=64, n_docs=16, k=10,
                            use_kernels=True)
    ids = teng.retrieve(index, q, cfg, device="cpu").doc_ids.numpy()
    assert synthetic.success_at_k(ids, gt.numpy(), 10) >= 0.9


def test_numpy_corpus_copy_matches_reference():
    from repro.data import synthetic as rsyn
    kw = dict(n_docs=50, cap=8, min_len=3, n_queries=4, n_topics=5)
    a, b = synthetic.make_corpus(2, **kw), rsyn.make_corpus(2, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    ranked = np.arange(40).reshape(4, 10)
    gt = np.array([3, 15, 99, 30])
    assert synthetic.mrr_at_k(ranked, gt, 10) == rsyn.mrr_at_k(ranked, gt, 10)
    assert synthetic.success_at_k(ranked, gt, 10) == \
        rsyn.success_at_k(ranked, gt, 10)


def test_raw_docs_encode_into_a_generation_that_finds_them():
    """The timeline data of chip_smoke.py at a tiny width: raw passages for
    the planted index, deterministic per seed, encoded against its frozen
    codebooks by new_generation and add_passages; queries planted on them
    find their docs through retrieve_timeline."""
    index, meta = synthetic.make_packed_index(5, **TINY)
    a, la = synthetic.make_raw_docs(index, 2, 300, TINY["min_len"])
    a2, _ = synthetic.make_raw_docs(index, 2, 300, TINY["min_len"])
    assert torch.equal(a, a2)
    pad = torch.arange(TINY["cap"])[None] >= la[:, None]
    assert not a[pad].any()
    assert torch.allclose(a[~pad].norm(dim=-1), torch.ones(int((~pad).sum())))
    gen = tstore.new_generation(index, meta, a[:250].numpy(),
                                la[:250].numpy(), device="cpu")
    gen = tstore.add_passages(*gen, a[250:].numpy(), la[250:].numpy(),
                              device="cpu")
    assert gen[1].n_docs == 300 and gen[1].n_grown == 300
    assert gen[0].plaid_res.shape == (300, TINY["cap"], TINY["d"] // 4)
    tl = tstore.ShardedTimeline.of((index, meta), gen)
    q, gt = synthetic.make_raw_queries(a, la, 6, n_queries=8, n_q=16)
    cfg = teng.EngineConfig(n_q=16, n_filter=64, n_docs=16, k=10,
                            use_kernels=True)
    ids = teng.retrieve_timeline(tl, q, cfg, device="cpu").doc_ids.numpy()
    assert synthetic.success_at_k(ids, gt.numpy() + TINY["n_docs"], 10) \
        >= 0.9
