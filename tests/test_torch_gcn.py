"""The port's GCN and neighbour sampler (``repro_torch.models.gcn``,
``sampler``) against the reference's (``repro.models.gcn``, ``sampler``) on
the CPU: ``segment_sum`` against ``jax.ops.segment_sum``, one propagation,
the full-graph forward, loss and gradients on the reference's weights and
its launcher's batches; ``forward_sampled`` and its loss on blocks the
reference's own sampler drew; ``pad_adjacency`` exactly; the port's draws
(jax.random's cannot be replayed) against the adjacency, degree-0 seeds
masked; checkpoints of a GCN across the two packages.

Tolerances as ``tests/test_torch_recsys.py``: values and losses rtol 1e-5,
gradients rtol 1e-4, each with an atol of 1e-5 times the largest magnitude
of the compared tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as rlaunch
from repro.models import gcn as rgcn
from repro.models import sampler as rsampler
from repro.train import checkpoint as rck
from repro.train import optimizer as ropt
from repro.train import trainer as rtrainer
from repro_torch import models, tree
from repro_torch.models import gcn as tgcn
from repro_torch.models import sampler as tsampler
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

VALUES = dict(rtol=1e-5, scaled_atol=1e-5)
GRAD = dict(rtol=1e-4, scaled_atol=1e-5)
RCFG = rgcn.GCNConfig(name="gcn-smoke", n_layers=2, d_feat=32, d_hidden=8,
                      n_classes=4)
TCFG = tgcn.GCNConfig(name="gcn-smoke", n_layers=2, d_feat=32, d_hidden=8,
                      n_classes=4)


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


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray,
                          rgcn.init_params(jax.random.PRNGKey(0), RCFG))
    return params, models.params_from_reference(params, TCFG, device="cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _grads(model, loss) -> dict:
    g = torch.autograd.grad(loss, list(model.parameters()))
    return models.to_reference_layout(model, list(g))


def _hold_grads(got: dict, ref_grads) -> None:
    want = tree.flatten(jax.tree.map(np.asarray, ref_grads))
    assert list(got) == list(want)
    for path, w in want.items():
        _close(got[path], w, GRAD, err_msg=str(path))


def test_segment_sum_equals_jax():
    """Sums in edge order, empty segments 0: the same bits as XLA's
    scatter-add on the CPU."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(300, 5)).astype(np.float32)
    ids = rng.integers(0, 40, size=300).astype(np.int32)
    ids[ids == 7] = 8                                    # an empty segment
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=41)
    got = tgcn.segment_sum(_t(data), _t(ids), 41)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[7].any() and not got[40].any()


def test_propagate_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    edges = rng.integers(0, 30, size=(2, 90)).astype(np.int32)
    mask = rng.random(90) < 0.8
    want = rgcn.propagate(jnp.asarray(x), jnp.asarray(edges),
                          jnp.asarray(mask), 30)
    _close(tgcn.propagate(_t(x), _t(edges), _t(mask), 30), want, VALUES)


@pytest.mark.parametrize("step", [0, 3])
def test_full_graph_forward_loss_and_grads_match_reference(pair, step):
    params, model = pair
    b = {k: np.array(v) for k, v in rlaunch.gnn_batch_fn(RCFG)(step).items()}
    b["edge_mask"][::7] = False                # masked edges
    b["labels"][::5] = -1                      # unlabeled nodes
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    _close(tgcn.forward(model, tb["feats"], tb["edges"], tb["edge_mask"],
                        TCFG),
           rgcn.forward(params, rb["feats"], rb["edges"], rb["edge_mask"],
                        RCFG), VALUES)
    loss, grads = jax.value_and_grad(rgcn.loss_fn)(
        jax.tree.map(jnp.asarray, params), rb, RCFG)
    got = tgcn.loss_fn(model, tb, TCFG)
    _close(got, loss, VALUES)
    _hold_grads(_grads(model, got), grads)


def _graph(seed: int, n: int = 120, max_deg: int = 9):
    """A CSR graph with some degree-0 nodes and some above max_deg."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 4, size=n)
    deg[::11] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col_idx = rng.integers(0, n, size=int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col_idx


def test_pad_adjacency_equals_reference():
    row_ptr, col_idx = _graph(2)
    nbr, deg = rsampler.pad_adjacency(row_ptr, col_idx, 120, 9, 120)
    tnbr, tdeg = tsampler.pad_adjacency(row_ptr, col_idx, 120, 9, 120,
                                        device="cpu")
    assert tnbr.dtype == torch.int32 and tdeg.dtype == torch.int32
    np.testing.assert_array_equal(tnbr.numpy(), np.asarray(nbr))
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(deg))


@pytest.fixture(scope="module")
def sampled():
    """Blocks the reference's sampler drew (fanouts 4 and 3 from 16
    seeds, some of degree 0) and each hop's features."""
    row_ptr, col_idx = _graph(3)
    nbr, deg = rsampler.pad_adjacency(row_ptr, col_idx, 120, 9, 0)
    seeds = jnp.asarray(np.r_[0, 11, 22, np.arange(1, 14)], jnp.int32)
    hops, blocks = rsampler.sample_blocks(jax.random.PRNGKey(4), seeds, nbr,
                                          deg, [4, 3])
    feats = np.random.default_rng(5).normal(size=(120, 32)).astype(
        np.float32)
    batch = {"feats0": feats[np.asarray(hops[0])],
             "labels": np.random.default_rng(6).integers(0, 4, 16).astype(
                 np.int32)}
    for i, blk in enumerate(blocks):
        batch[f"edges{i}"] = np.asarray(blk["edges"])
        batch[f"edge_mask{i}"] = np.asarray(blk["edge_mask"])
        batch[f"feats{i + 1}"] = feats[np.asarray(hops[i + 1])]
    return batch


def test_forward_sampled_on_reference_blocks_matches(pair, sampled):
    params, model = pair
    rb = {k: jnp.asarray(v) for k, v in sampled.items()}
    tb = {k: _t(v) for k, v in sampled.items()}
    assert not sampled["edge_mask0"].all()     # degree-0 seeds masked
    blocks_r = [{"edges": rb[f"edges{i}"], "edge_mask": rb[f"edge_mask{i}"]}
                for i in range(2)]
    blocks_t = [{"edges": tb[f"edges{i}"], "edge_mask": tb[f"edge_mask{i}"]}
                for i in range(2)]
    _close(tgcn.forward_sampled(model, blocks_t, tb["feats0"],
                                [tb["feats1"], tb["feats2"]], TCFG),
           rgcn.forward_sampled(params, blocks_r, rb["feats0"],
                                [rb["feats1"], rb["feats2"]], RCFG), VALUES)
    loss, grads = jax.value_and_grad(rgcn.loss_fn_sampled)(
        jax.tree.map(jnp.asarray, params), rb, RCFG)
    got = tgcn.loss_fn_sampled(model, tb, TCFG)
    _close(got, loss, VALUES)
    _hold_grads(_grads(model, got), grads)


def test_port_sampler_respects_the_adjacency():
    """Each drawn neighbour is one of its seed's first ``degree`` table
    entries; a degree-0 seed's draws are masked, and a sentinel seed's
    pass the sentinel on; the edges link hop i + 1 positions to their
    seeds; one seed, one draw."""
    row_ptr, col_idx = _graph(7)
    nbr, deg = tsampler.pad_adjacency(row_ptr, col_idx, 120, 9, 120,
                                      device="cpu")
    seeds = torch.tensor([0, 11, 5, 6, 7, 8, 9, 10], dtype=torch.int32)
    hops, blocks = tsampler.sample_blocks(8, seeds, nbr, deg, [5, 4])
    again, _ = tsampler.sample_blocks(8, seeds, nbr, deg, [5, 4])
    assert all(torch.equal(a, b) for a, b in zip(hops, again))
    assert [h.shape[0] for h in hops] == [8, 40, 160]
    for i, (blk, fan) in enumerate(zip(blocks, [5, 4])):
        cur, nxt = hops[i].long(), hops[i + 1].long()
        src, dst = blk["edges"].long()
        assert torch.equal(src, torch.arange(len(nxt)))
        assert torch.equal(dst, torch.arange(len(cur)).repeat_interleave(fan))
        owner = cur[dst]
        inside = owner < 120              # not the sentinel of a hop before
        d = torch.where(inside, deg[torch.where(inside, owner, 0)], 0)
        assert torch.equal(blk["edge_mask"], d > 0)
        assert torch.equal(nxt[~inside], owner[~inside])
        live = d > 0
        rows = nbr[owner[live]]
        hit = (rows == nxt[live][:, None]) & (
            torch.arange(9)[None] < d[live][:, None])
        assert hit.any(1).all()
    assert not blocks[0]["edge_mask"][:10].any()     # seeds 0 and 11: deg 0


def test_gcn_checkpoints_cross_packages(tmp_path, pair):
    """A port Trainer's checkpoint restores in the reference with its
    structure; the reference's resumes in a port Trainer, leaf for leaf."""
    params, model = pair
    b = {k: np.array(v) for k, v in rlaunch.gnn_batch_fn(RCFG)(1).items()}
    tb = {k: _t(v) for k, v in b.items()}
    tr = Trainer(lambda p, x: tgcn.loss_fn(p, x, TCFG), topt.make("adamw"),
                 lambda s: tb, TrainerConfig(ckpt_dir=str(tmp_path / "p"),
                                             ckpt_every=2), model,
                 device="cpu")
    tr.run(2)
    like = {"params": params, "opt": jax.tree.map(
        np.asarray, ropt.make("adamw").init(jax.tree.map(jnp.asarray,
                                                         params)))}
    got, step = rck.restore(str(tmp_path / "p"), like)
    assert step == 2 and jax.tree.structure(got) == jax.tree.structure(like)
    for (pa, a), (pb, w) in zip(tree.leaves(got), tree.leaves(tr._tree())):
        assert pa == pb
        np.testing.assert_array_equal(a, w)

    rb = {k: jnp.asarray(v) for k, v in b.items()}
    rtr = rtrainer.Trainer(lambda p, x: rgcn.loss_fn(p, x, RCFG),
                           ropt.make("adamw"), lambda s: rb,
                           rtrainer.TrainerConfig(
                               ckpt_dir=str(tmp_path / "r"), ckpt_every=2),
                           jax.tree.map(jnp.asarray, params))
    rtr.run(2)
    back = Trainer(lambda p, x: tgcn.loss_fn(p, x, TCFG), topt.make("adamw"),
                   lambda s: tb, TrainerConfig(ckpt_dir=str(tmp_path / "r")),
                   model, device="cpu")
    assert back.maybe_resume() == 2
    want = jax.tree.map(np.asarray, {"params": rtr.state.params,
                                     "opt": rtr.state.opt_state})
    for (pa, a), (pb, w) in zip(tree.leaves(back._tree()),
                                tree.leaves(want)):
        assert pa == pb
        np.testing.assert_array_equal(a, w)


def test_gcn_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgcn.init_params(0, TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsampler.pad_adjacency(np.array([0, 0]), np.array([], np.int32), 1,
                               2, 1)
    assert tgcn.init_params(0, TCFG, device="cpu").layer0.w.shape == (32, 8)
