"""The port's examples run end to end on the CPU at a tiny size, in the
manner of ``tests/test_examples.py``. ``examples/train_colbert_torch.py``
trains the encoder, encodes, builds and retrieves; its embeddings then go
through the reference's ``build_index`` and ``retrieve`` with
``examples/train_colbert.py``'s config. ``examples/mind_emvb_retrieval_torch.py``
trains MIND, indexes its items and serves each user's 4 interests. The
counterparts of the reference's quickstart, serve_retrieval (two gloo
ranks here), streaming_index and retrieval_service examples run at the
reference examples test's tiny size.

Margin: the two packages' MRR@10 on the same embeddings within 0.15. The
index builds draw their k-means and PQ from different generators
(jax.random cannot be replayed), so the two indexes differ, and one of 32
queries moving by a rank moves MRR@10 by up to 0.016 (measured 0.02 and
0.04 apart at this size); exact MaxSim, with no index between, agrees to
1e-6.
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import EngineConfig, build_index, engine
from repro.data.synthetic import mrr_at_k

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
MARGIN = 0.15


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("jmpq", [False, True])
def test_train_colbert_torch_main(jmpq, capsys):
    mod = _load("train_colbert_torch")
    out = mod.main(steps=30, n_docs=256, jmpq=jmpq, device="cpu")
    printed = capsys.readouterr().out
    assert "mrr@10=" in printed and "exact MaxSim" in printed
    assert np.isfinite(out["losses"]).all()
    de, lens, qe, gt = (out[k] for k in ("doc_embs", "doc_lens", "queries",
                                         "gt"))
    index, _ = build_index(jax.random.PRNGKey(1), de, lens, n_centroids=256,
                           m=8, nbits=4, kmeans_iters=4)
    ids = np.asarray(engine.retrieve(index, qe, EngineConfig(
        **mod.ENGINE)).doc_ids)
    sim = np.einsum("qtd,nsd->qnts", qe, de)
    ids_exact = np.argsort(-sim.max(-1).sum(-1), axis=1)[:, :10]
    assert abs(mrr_at_k(ids_exact, gt) - out["mrr_exact"]) < 1e-6
    assert abs(mrr_at_k(ids, gt) - out["mrr_emvb"]) <= MARGIN
    assert out["mrr_exact"] > 0.3     # the encoder learned something


def test_mind_emvb_retrieval_torch_main(capsys):
    """The MIND x EMVB example at a tiny size: training lowers the loss, the
    fused lane's top-10 is well formed and close to exact MaxSim's."""
    mod = _load("mind_emvb_retrieval_torch")
    out = mod.main(n_items=5000, n_centroids=64, steps=20, n_users=16,
                   device="cpu")
    printed = capsys.readouterr().out
    assert "top-10 overlap vs exact" in printed and "score quality" in printed
    assert out["losses"][-1] < out["losses"][0]
    assert out["emvb_top"].shape == out["exact_top"].shape == (16, 10)
    ids = out["emvb_top"]
    assert ((ids >= 0) & (ids < 5000)).all()
    assert all(len(set(r.tolist())) == 10 for r in ids)
    assert torch.isfinite(out["emvb_scores"]).all()
    assert out["score_ratio"] > 0.8 and out["overlap"] > 0.3



TINY = dict(n_docs=256, n_centroids=32, n_queries=8, device="cpu")


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_retrieval_torch",
                                  "streaming_index_torch",
                                  "retrieval_service_torch"])
def test_port_example_main_runs_on_tiny_corpus(name, capsys):
    """The counterparts of the reference's four examples run end to end on
    the CPU at a tiny size: they narrate, and no bit-exactness check they
    print fails (``tests/test_examples.py``'s manner). The sharded plan
    runs on two gloo ranks here."""
    mod = _load(name)
    kw = dict(TINY, n_shards=2) if name == "serve_retrieval_torch" else TINY
    out = mod.main(**kw)
    printed = capsys.readouterr().out
    assert printed.strip()
    assert ": False" not in printed
    if name == "quickstart_torch":
        for ids in (out["emvb_ids"], out["plaid_ids"]):
            assert ids.shape == (8, 10) and ((ids >= 0) & (ids < 256)).all()
        assert out["mrr_emvb"] > 0.5 and out["mrr_plaid"] > 0.5
    if name == "serve_retrieval_torch":
        assert "top-1 agreement: 100%" in printed
    if name == "streaming_index_torch":
        assert out["round_trip_exact"] and out["timeline_same"]
    if name == "retrieval_service_torch":
        assert out["exact"] and out["padded_equals_prefix"]
