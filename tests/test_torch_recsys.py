"""The port's recommenders (``repro_torch.models.recsys``) against the
reference's (``repro.models.recsys``) on the CPU: EmbeddingBag (plain and
PQ, sum and mean, holes in ``valid``), MIND's interests and candidate
scores, and each smoke config's forward, loss and gradients on the
reference's weights (``params_from_reference``) and the reference's batches
(``repro.launch.train.recsys_batch_fn``, as numpy, with holes punched in
the validity masks); the parameter trees and checkpoints with list leaves
across the two packages; and the MIND x EMVB slice: the reference trains a
tiny MIND and saves its item index, the port loads it and retrieves each
user's 4 interests with ``th_r=None`` on every lane, ids and score bits
equal to the reference's with its CS and LUT injected.

Tolerances (ROADMAP hazard 3: the frameworks' products and reductions round
in other orders): forward values and losses at rtol 1e-5, gradients at rtol
1e-4, each with an atol of 1e-5 times the largest magnitude of the compared
tensor (an element near zero is a difference of larger terms and carries
their rounding). MIND's unit-norm interests at rtol 1e-5 / atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as ref_build_index
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.pq import build_lut as ref_build_lut
from repro.launch import train as rlaunch
from repro.models.recsys import dcn as rdcn
from repro.models.recsys import dien as rdien
from repro.models.recsys import dlrm as rdlrm
from repro.models.recsys import embedding_bag as reb
from repro.models.recsys import mind as rmind
from repro.train import checkpoint as rck
from repro.train import optimizer as ropt
from repro.train import trainer as rtrainer
from repro_torch import models, tree
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.launch import train as tlaunch
from repro_torch.models import flat
from repro_torch.models.recsys import dcn as tdcn
from repro_torch.models.recsys import dien as tdien
from repro_torch.models.recsys import dlrm as tdlrm
from repro_torch.models.recsys import embedding_bag as teb
from repro_torch.models.recsys import mind as tmind
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

VALUES = dict(rtol=1e-5, scaled_atol=1e-5)
GRAD = dict(rtol=1e-4, scaled_atol=1e-5)
UNIT = dict(rtol=1e-5, atol=1e-6)

# arch -> (reference module, port module, the reference's smoke config)
ARCHS = {
    "mind": (rmind, tmind, rmind.MINDConfig(
        name="mind-smoke", vocab_items=500, embed_dim=16, n_interests=4,
        capsule_iters=2, seq_len=12)),
    "dlrm-mlperf": (rdlrm, tdlrm, rdlrm.DLRMConfig(
        name="dlrm-smoke", vocab_sizes=(64,) * 26, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(64, 1), nnz=2)),
    "dcn-v2": (rdcn, tdcn, rdcn.DCNConfig(
        name="dcn-smoke", vocab_sizes=(64,) * 26, embed_dim=8,
        n_cross_layers=2, mlp_dims=(32, 16), nnz=2)),
    "dien": (rdien, tdien, rdien.DIENConfig(
        name="dien-smoke", vocab_items=200, vocab_cats=20, embed_dim=8,
        seq_len=12, gru_dim=16, mlp_dims=(32, 16))),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, err_msg=""):
    got, want = _np(got), _np(want)
    tol = dict(tol)
    if "scaled_atol" in tol:
        tol["atol"] = tol.pop("scaled_atol") * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)


def port_config(ref_cfg):
    """The port's config with the reference config's fields (float32)."""
    cls = {rmind.MINDConfig: tmind.MINDConfig,
           rdlrm.DLRMConfig: tdlrm.DLRMConfig,
           rdcn.DCNConfig: tdcn.DCNConfig,
           rdien.DIENConfig: tdien.DIENConfig}[type(ref_cfg)]
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg) if f.name != "dtype"}
    return cls(**kw)


def pair(arch, seed=0, **over):
    """(reference params as numpy, reference config), (port model, port
    config) for ``arch``'s smoke config with ``over`` replaced."""
    rmod, _, rcfg = ARCHS[arch]
    rcfg = dataclasses.replace(rcfg, **over)
    params = jax.tree.map(np.asarray,
                          rmod.init_params(jax.random.PRNGKey(seed), rcfg))
    tcfg = port_config(rcfg)
    return (params, rcfg), (models.params_from_reference(
        params, tcfg, device="cpu"), tcfg)


def with_holes(batch: dict, seed: int) -> dict:
    """``batch`` with about a fifth of its validity slots false (a row of
    DIEN's and MIND's histories keeps its first slot)."""
    rng = np.random.default_rng(seed)
    out = dict(batch)
    for key in ("sparse_valid", "hist_valid"):
        if key in out:
            v = np.asarray(out[key]).copy()
            v &= rng.random(v.shape) >= 0.2
            if key == "hist_valid":
                v[:, 0] = True
            out[key] = v
    return out


def ref_batch(arch, rcfg, step=0, holes=True) -> dict:
    b = {k: np.array(v) for k, v in
         rlaunch.recsys_batch_fn(arch, rcfg)(step).items()}
    return with_holes(b, step) if holes else b


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


# --- EmbeddingBag --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(-3, 55, size=(6, 4, 3)).astype(np.int32)  # clipped
    valid = rng.random((6, 4, 3)) < 0.6
    valid[0, 0] = False                                          # empty bag
    want = reb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                             jnp.asarray(valid), mode)
    got = teb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(valid), mode)
    _close(got, want, VALUES)
    assert not got[0, 0].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_pq_matches_reference(mode):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, size=(40, 4)).astype(np.uint8)
    books = rng.normal(size=(4, 16, 3)).astype(np.float32)
    idx = rng.integers(0, 45, size=(5, 2, 3)).astype(np.int32)
    valid = rng.random((5, 2, 3)) < 0.6
    want = reb.embedding_bag_pq(jnp.asarray(codes), jnp.asarray(books),
                                jnp.asarray(idx), jnp.asarray(valid), mode)
    got = teb.embedding_bag_pq(torch.from_numpy(codes),
                               torch.from_numpy(books), torch.from_numpy(idx),
                               torch.from_numpy(valid), mode)
    assert got.shape == (5, 2, 12)
    _close(got, want, VALUES)


def test_mlp_matches_reference():
    rng = np.random.default_rng(2)
    layers = reb.init_mlp(jax.random.PRNGKey(3), [7, 9, 5, 2])
    layers = jax.tree.map(np.asarray, layers)
    x = rng.normal(size=(4, 7)).astype(np.float32)
    port = flat.MLP([7, 9, 5, 2], torch.float32, "cpu")
    flat.load_reference_layout(port, tree.flatten(layers))
    for final_act in (False, True):
        _close(teb.mlp(port, torch.from_numpy(x), final_act),
               reb.mlp(layers, jnp.asarray(x), final_act), VALUES)


# --- models ------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_loss_and_grads_match_reference(arch):
    rmod, tmod, _ = ARCHS[arch]
    (params, rcfg), (model, tcfg) = pair(arch)
    rb, tb = _both(ref_batch(arch, rcfg))
    if arch != "mind":
        _close(tmod.forward(model, tb, tcfg),
               rmod.forward(params, rb, rcfg), VALUES)
    loss, grads = jax.value_and_grad(rmod.loss_fn)(
        jax.tree.map(jnp.asarray, params), rb, rcfg)
    got = tmod.loss_fn(model, tb, tcfg)
    _close(got, loss, VALUES)
    g = torch.autograd.grad(got, list(model.parameters()),
                            allow_unused=True)
    g = models.to_reference_layout(model, [
        torch.zeros_like(p) if x is None else x
        for p, x in zip(model.parameters(), g)])
    want = tree.flatten(jax.tree.map(np.asarray, grads))
    assert list(g) == list(want)          # the reference's leaf order
    for path, w in want.items():
        _close(g[path], w, GRAD, err_msg=str(path))


def test_mind_interests_and_candidate_scores_match_reference():
    (params, rcfg), (model, tcfg) = pair("mind", seed=4, capsule_iters=3)
    b = ref_batch("mind", rcfg, step=3)
    want = rmind.user_interests(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(b["hist_items"]),
                                jnp.asarray(b["hist_valid"]), rcfg)
    got = tmind.user_interests(model, torch.from_numpy(b["hist_items"]),
                               torch.from_numpy(b["hist_valid"]), tcfg)
    assert got.shape == (32, 4, 16)
    _close(got, want, UNIT)
    items = params["item_emb"]
    _close(tmind.score_candidates(got, torch.from_numpy(np.array(items))),
           rmind.score_candidates(want, jnp.asarray(items)), VALUES)
    rb, tb = _both(b)
    _close(tmind.forward(model, tb, tcfg), rmind.forward(
        jax.tree.map(jnp.asarray, params), rb, rcfg), VALUES)


def test_dien_runs_over_its_twelve_steps():
    """Every step of the two loops counts: a history valid only in its
    first slot and one valid throughout give the reference's logits, and
    changing the last item moves the latter's."""
    (params, rcfg), (model, tcfg) = pair("dien", seed=5)
    b = ref_batch("dien", rcfg, step=7, holes=False)
    assert b["hist_items"].shape[1] == 12
    b["hist_valid"][0, 1:] = False
    rb, tb = _both(b)
    want = rdien.forward(jax.tree.map(jnp.asarray, params), rb, rcfg)
    got = tdien.forward(model, tb, tcfg)
    _close(got, want, VALUES)
    b2 = dict(b, hist_items=b["hist_items"].copy())
    b2["hist_items"][1, -1] = (b2["hist_items"][1, -1] + 1) % 200
    moved = tdien.forward(model, _both(b2)[1], tcfg)
    assert moved[1] != got[1] and torch.equal(moved[2:], got[2:])


def test_dlrm_pq_tables_forward_matches_and_training_raises():
    (params, rcfg), (model, tcfg) = pair("dlrm-mlperf", use_pq_tables=True,
                                         pq_m=4, pq_k=16)
    assert model.tables.t0.codes.dtype == torch.uint8
    assert list(dict(model.named_buffers())) == [
        f"tables.t{f}.codes" for f in range(26)]
    rb, tb = _both(ref_batch("dlrm-mlperf", rcfg))
    _close(tdlrm.forward(model, tb, tcfg), rdlrm.forward(params, rb, rcfg),
           VALUES)
    # the reference refuses to differentiate its uint8 codes; so does the
    # port's trainer
    with pytest.raises(TypeError):
        rtrainer.Trainer(lambda p, x: rdlrm.loss_fn(p, x, rcfg),
                         ropt.make("adagrad"), lambda s: rb,
                         rtrainer.TrainerConfig(), params).run(1)
    with pytest.raises(TypeError, match="integer"):
        Trainer(lambda p, x: tdlrm.loss_fn(p, x, tcfg), topt.make("adagrad"),
                lambda s: tb, TrainerConfig(), model, device="cpu").run(1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_parameter_trees_round_trip(arch):
    """params_to_reference gives the reference's tree, lists included;
    params_from_reference of it gives the same module."""
    (params, _), (model, tcfg) = pair(arch, seed=6)
    back = models.params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (pa, a), (pb, b) in zip(tree.leaves(back), tree.leaves(params)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = models.params_from_reference(back, tcfg, device="cpu")
    for a, b in zip(again.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)


def test_tree_nest_rebuilds_lists():
    flat_tree = {("bot", 0, "w"): 1, ("bot", 1, "w"): 2, ("t", "a"): 3,
                 ("gap", 0): 4, ("gap", 2): 5, ("x",): 6}
    assert tree.nest(flat_tree) == {"bot": [{"w": 1}, {"w": 2}],
                                    "t": {"a": 3}, "gap": {0: 4, 2: 5},
                                    "x": 6}
    assert tree.flatten(tree.nest(flat_tree)) == dict(
        sorted(flat_tree.items(), key=lambda kv: str(kv[0])))


def _ckpt_case():
    arch = "dlrm-mlperf"
    (params, rcfg), (model, tcfg) = pair(arch, seed=8)
    batch = ref_batch(arch, rcfg, holes=False)
    return params, rcfg, model, tcfg, batch


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A port Trainer's checkpoint (params with lists, adagrad's state) is
    a tree the reference's ``checkpoint.restore`` reads back into its own
    structure, leaf for leaf."""
    params, rcfg, model, tcfg, batch = _ckpt_case()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tr = Trainer(lambda p, x: tdlrm.loss_fn(p, x, tcfg), topt.make("adagrad"),
                 lambda s: tb, TrainerConfig(ckpt_dir=str(tmp_path),
                                             ckpt_every=2), model,
                 device="cpu")
    tr.run(2)
    like = {"params": params,
            "opt": jax.tree.map(np.asarray, ropt.make("adagrad").init(
                jax.tree.map(jnp.asarray, params)))}
    got, step = rck.restore(str(tmp_path), like)
    assert step == 2
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert isinstance(got["params"]["bot"], list)
    want = tr._tree()
    for (pa, a), (pb, b) in zip(tree.leaves(got), tree.leaves(want)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 2 steps and checkpoints; a port Trainer resumes
    from it and holds its parameters and adagrad state."""
    params, rcfg, model, tcfg, batch = _ckpt_case()
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rtr = rtrainer.Trainer(lambda p, x: rdlrm.loss_fn(p, x, rcfg),
                           ropt.make("adagrad"), lambda s: rb,
                           rtrainer.TrainerConfig(ckpt_dir=str(tmp_path),
                                                  ckpt_every=2),
                           jax.tree.map(jnp.asarray, params))
    rtr.run(2)
    tr = Trainer(lambda p, x: tdlrm.loss_fn(p, x, tcfg), topt.make("adagrad"),
                 lambda s: {}, TrainerConfig(ckpt_dir=str(tmp_path)), model,
                 device="cpu")
    assert tr.maybe_resume() == 2
    want = {"params": rtr.state.params, "opt": rtr.state.opt_state}
    got = tr._tree()
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for (pa, a), (pb, b) in zip(tree.leaves(got), tree.leaves(
            jax.tree.map(np.asarray, want))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


# --- the MIND x EMVB slice -------------------------------------------------------

N_ITEMS = 3000
MIND_ENGINE = dict(n_q=4, k=10, nprobe=8, th=0.3, th_r=None, n_filter=512,
                   n_docs=128)


@pytest.fixture(scope="module")
def mind_slice(tmp_path_factory):
    """The reference trains a tiny MIND in-batch, builds the EMVB index
    over its normalized item table (one token per item) and saves it;
    the port loads it. -> (reference index, port index, interests)."""
    cfg = rmind.MINDConfig(name="mind-tiny", vocab_items=N_ITEMS,
                           embed_dim=64, n_interests=4, capsule_iters=3,
                           seq_len=16)

    def make_batch(step):
        rng = np.random.default_rng(step)
        anchor = rng.integers(0, N_ITEMS - 64, (32, 1))
        hist = anchor + rng.integers(0, 64, (32, cfg.seq_len))
        return {"hist_items": jnp.asarray(hist, jnp.int32),
                "hist_valid": jnp.ones((32, cfg.seq_len), bool),
                "target_item": jnp.asarray(anchor[:, 0] + 32, jnp.int32)}
    tr = rtrainer.Trainer(lambda p, b: rmind.loss_fn(p, b, cfg),
                          ropt.make("adamw", lr=1e-2), make_batch,
                          rtrainer.TrainerConfig(log_every=5),
                          rmind.init_params(jax.random.PRNGKey(0), cfg))
    tr.run(10)
    params = tr.state.params
    items = np.asarray(params["item_emb"], np.float32)
    items = items / np.maximum(np.linalg.norm(items, axis=-1, keepdims=True),
                               1e-9)
    index, meta = ref_build_index(jax.random.PRNGKey(1), items[:, None, :],
                                  np.ones(N_ITEMS, np.int32), n_centroids=128,
                                  m=16, nbits=8, kmeans_iters=3)
    path = str(tmp_path_factory.mktemp("mind_index"))
    rstore.save_index(path, index, meta)
    port_index, port_meta = tstore.load_index(path, device="cpu")
    assert port_meta.cap == 1 and port_meta.d == 64
    b = make_batch(99)
    q = np.asarray(rmind.user_interests(params, b["hist_items"][:9],
                                        b["hist_valid"][:9], cfg))
    return index, port_index, q


@jax.jit
def _ref_cs_lut(index, q):
    cs = jax.vmap(lambda x: reng.centroid_scores(x, index.centroids))(q)
    q_rot = jax.vmap(lambda x: x @ index.opq_rotation)(q)
    lut = jax.vmap(lambda x: ref_build_lut(x, index.pq))(q_rot)
    return cs, lut


LANES = {"fused": dict(use_kernels=True),
         "unfused": dict(use_kernels=True, fused_prefilter=False,
                         fused_late_interaction=False),
         "reference_math": dict(use_kernels=False)}


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("rows", [slice(0, 8), slice(8, 9)],
                         ids=["b8", "b1"])
def test_mind_emvb_retrieval_matches_reference(mind_slice, lane, rows):
    """n_q = 4, cap = 1, d = 64 with m = 16, th_r None: the port's lane on
    the loaded index with the reference's CS and LUT == the reference's
    retrieve (its kernel lane for the port's kernel lanes, its math for
    the port's math), ids and float32 score bits."""
    ref_index, port_index, q = mind_slice
    q = q[rows]
    cs, lut = _ref_cs_lut(ref_index, jnp.asarray(q))
    kernels = LANES[lane]["use_kernels"]
    want = reng.retrieve(ref_index, jnp.asarray(q), reng.EngineConfig(
        **MIND_ENGINE, use_kernels=kernels))
    got = teng._retrieve_batch(
        port_index, torch.from_numpy(q), teng.EngineConfig(
            **MIND_ENGINE, **LANES[lane]),
        cs=torch.from_numpy(np.array(cs)), lut=torch.from_numpy(np.array(lut)))
    np.testing.assert_array_equal(got.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_array_equal(
        got.scores.numpy().view(np.uint32),
        np.asarray(want.scores, np.float32).view(np.uint32))
    assert np.isfinite(got.scores.numpy()).all()


def test_mind_emvb_lanes_agree_through_retrieve(mind_slice):
    """retrieve itself (the port's own CS and LUT) on the loaded index:
    the fused and unfused lanes give the same ids and score bits."""
    _, port_index, q = mind_slice
    tq = torch.from_numpy(q)
    a = teng.retrieve(port_index, tq, teng.EngineConfig(
        **MIND_ENGINE, **LANES["fused"]), device="cpu")
    b = teng.retrieve(port_index, tq, teng.EngineConfig(
        **MIND_ENGINE, **LANES["unfused"]), device="cpu")
    assert torch.equal(a.doc_ids, b.doc_ids)
    assert torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32))


def test_recsys_modules_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch, (_, tmod, rcfg) in ARCHS.items():
        cfg = port_config(rcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmod.init_params(0, cfg)
        assert tmod.init_params(0, cfg, "cpu") is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.build_smoke_trainer("mind")
