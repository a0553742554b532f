"""The port's training substrate (``repro_torch.train``) against the
reference's (``repro.train``) on the CPU: each optimizer's update, the
state trees, int8 compression, checkpoints in both directions, and the
trainer's contracts (resume == continuous, grad_accum == the unsplit step,
compressed gradients descend, SIGTERM saves and stops, the loss curve of
the reference's trainer) on the small causal LM of ``tests/test_train.py``.

Tolerances: the elementwise optimizers (adamw, adagrad, adafactor) at rtol
1e-6 with an atol of 1e-6 times the leaf's largest magnitude (a few float32
ulps: pow, sqrt, rsqrt and mean round otherwise in the two frameworks, and
an element near zero carries the rounding of the larger terms of its
update; measured up to 8 ulps of the largest); muon at rtol 1e-5 with an
atol of 1e-5 times the leaf's largest magnitude, its five Newton-Schulz
steps being float32 products (hazard 3). The trainer's losses at rtol
1e-4 over 8 steps: the gradients differ at ~1e-6 relative
(test_torch_models.py) and Adam normalizes them, so the weights drift
apart by that much a step.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rtr
from repro.models.layers import ModelConfig as RConfig
from repro.train import checkpoint as rck
from repro.train import compression as rcomp
from repro.train import optimizer as ropt
from repro.train import trainer as rtrainer
from repro_torch import models, tree
from repro_torch.models import layers as tlay
from repro_torch.models import transformer as ttr
from repro_torch.train import checkpoint as tck
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (TrainState, Trainer, TrainerConfig,
                                       make_train_step)

torch.set_num_threads(1)

CFG = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
           d_ff=64, vocab=64)
ELEMENTWISE = dict(rtol=1e-6, scaled_atol=1e-6)
MUON = dict(rtol=1e-5, scaled_atol=1e-5)
NAMES = ["adamw", "adagrad", "adafactor", "muon"]


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, rtr.init_params(jax.random.PRNGKey(0),
                                                    RConfig(**CFG)))


def _port_model(ref_params):
    return models.params_from_reference(ref_params, tlay.ModelConfig(**CFG),
                                        device="cpu")


def _batch_np(step: int) -> dict:
    toks = np.random.default_rng(step).integers(0, CFG["vocab"], (4, 16))
    return {"tokens": toks, "labels": toks}


def _port_batch(step: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in _batch_np(step).items()}


def _ref_batch(step: int) -> dict:
    return {k: jnp.asarray(v) for k, v in _batch_np(step).items()}


def _port_loss(model, batch):
    return ttr.loss_fn(model, batch, model.cfg)


def _ref_loss(params, batch):
    return rtr.loss_fn(params, batch, RConfig(**CFG))


def _close(got, want, tol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = dict(tol)
    if "scaled_atol" in tol:
        tol["atol"] = tol.pop("scaled_atol") * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _flat_port(ref_tree) -> dict:
    return {p: torch.from_numpy(np.array(a)) for p, a in
            tree.leaves(ref_tree)}


# --- optimizers --------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_optimizer_update_equals_reference(name, ref_params):
    """Two updates from the same gradients: the first from the initial
    state, the second from the state the first left (converted both ways
    between the packages' state trees)."""
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 0.1, ref_params) for _ in range(2)]
    r_opt, t_opt = ropt.make(name), topt.make(name)
    r_params = jax.tree.map(jnp.asarray, ref_params)
    t_params = _flat_port(ref_params)
    r_state, t_state = r_opt.init(r_params), t_opt.init(t_params)
    tol = MUON if name == "muon" else ELEMENTWISE
    for g in grads:
        r_params, r_state = r_opt.update(jax.tree.map(jnp.asarray, g),
                                         r_state, r_params)
        t_params, t_state = t_opt.update(_flat_port(g), t_state, t_params)
        for path, want in tree.leaves(jax.tree.map(np.asarray, r_params)):
            _close(t_params[path], want, tol, str(path))
        got_state = topt.state_to_reference(t_state)
        want_state = jax.tree.map(np.asarray, r_state)
        assert jax.tree.structure(got_state) == jax.tree.structure(want_state)
        for (pa, a), (pb, b) in zip(tree.leaves(got_state),
                                    tree.leaves(want_state)):
            assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
            _close(a, b, tol, str(pa))
        # continue from the reference's state, carried into the port
        t_state = topt.state_from_reference(want_state, t_state)


def test_make():
    for name in NAMES:
        opt = topt.make(name)
        assert isinstance(opt, topt.Optimizer)
    assert topt.make("adamw", lr=5e-3) is not None
    with pytest.raises(KeyError):
        topt.make("sgd")


# --- compression -------------------------------------------------------------

def test_compress_tree_equals_reference():
    rng = np.random.default_rng(2)
    grads = {"a": rng.normal(size=(5, 7)).astype(np.float32),
             "b": {"c": (rng.normal(size=(11,)) * 1e-3).astype(np.float32),
                   "z": np.zeros((3,), np.float32)}}
    want = jax.tree.map(np.asarray, rcomp.compress_tree(
        jax.tree.map(jnp.asarray, grads)))
    got = tcomp.compress_tree(_flat_port(grads))
    for path, w in tree.leaves(want):
        np.testing.assert_array_equal(got[path].numpy(), w)
    q, s = tcomp.quantize_int8(torch.from_numpy(grads["a"]))
    qr, sr = rcomp.quantize_int8(jnp.asarray(grads["a"]))
    assert q.dtype == torch.int8 and float(s) == float(sr)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))


def test_stochastic_rounding_is_one_step_and_seeded():
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 64)).astype(np.float32))
    q0, s = tcomp.quantize_int8(g)
    a, _ = tcomp.quantize_int8(g, torch.Generator().manual_seed(4))
    b, _ = tcomp.quantize_int8(g, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    exact = g / s
    assert ((a.float() == torch.floor(exact)) |
            (a.float() == torch.ceil(exact))).all()
    assert (a != q0).any()


# --- checkpoints -------------------------------------------------------------

def _state_tree(ref_params):
    opt = ropt.make("adamw")
    return {"params": ref_params,
            "opt": jax.tree.map(np.asarray, opt.init(ref_params))}


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_checkpoints_restore_across_packages(ref_params, n_chunks):
    """The reference's save restores in the port and the port's in the
    reference, leaf for leaf; the two write the same manifest."""
    want = _state_tree(ref_params)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "ref"), os.path.join(d, "port")
        rck.save(a, want, 7, n_chunks=n_chunks)
        tck.save(b, want, 7, n_chunks=n_chunks)
        for x in (a, b):
            assert tck.latest_step(x) == rck.latest_step(x) == 7
        with open(os.path.join(a, "step_7", "manifest.json")) as f:
            man_a = f.read()
        with open(os.path.join(b, "step_7", "manifest.json")) as f:
            assert f.read() == man_a
        for restore, src in ((tck.restore, a), (rck.restore, b)):
            got, step = restore(src, want)
            assert step == 7
            for (pa, x), (pb, y) in zip(tree.leaves(got), tree.leaves(want)):
                assert pa == pb
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        with pytest.raises(FileNotFoundError):
            tck.restore(os.path.join(d, "none"), want)


def test_reference_trainer_checkpoint_resumes_in_the_port(ref_params):
    """A checkpoint the reference's Trainer wrote at step 4 resumes in the
    port's, which then follows the reference's own continuation."""
    with tempfile.TemporaryDirectory() as d:
        rcfg = rtrainer.TrainerConfig(ckpt_dir=d, ckpt_every=4, log_every=1)
        rtrainer.Trainer(_ref_loss, ropt.make("adamw"), _ref_batch, rcfg,
                         jax.tree.map(jnp.asarray, ref_params)).run(4)
        ref_out = rtrainer.Trainer(_ref_loss, ropt.make("adamw"), _ref_batch,
                                   rcfg, jax.tree.map(jnp.asarray,
                                                      ref_params)).run(6)
        port = Trainer(_port_loss, topt.make("adamw"), _port_batch,
                       TrainerConfig(ckpt_dir=d, ckpt_every=100,
                                     log_every=1),
                       _port_model(ref_params), device="cpu")
        # the reference's run to 6 wrote no step past 4: both resume at 4
        out = port.run(6)
    assert out["log"][0]["step"] == 5
    for got, want in zip(out["log"], ref_out["log"]):
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


# --- the trainer -------------------------------------------------------------

def _trainer(ref_params, cfg, opt="adamw", **kw):
    return Trainer(_port_loss, topt.make(opt, **kw), _port_batch, cfg,
                   _port_model(ref_params), device="cpu")


def test_resume_equals_continuous(ref_params):
    """Stopped at 4 (checkpoint in 3 chunks) and resumed to 9 in a new
    Trainer: the same weights, bit for bit, as 9 steps in one run."""
    with tempfile.TemporaryDirectory() as d:
        cfg = TrainerConfig(ckpt_dir=d, ckpt_every=4, ckpt_chunks=3,
                            log_every=1)
        _trainer(ref_params, cfg).run(4)
        resumed = _trainer(ref_params, cfg)
        out = resumed.run(9)
    assert out["log"][0]["step"] == 5 and out["final_step"] == 9
    whole = _trainer(ref_params, TrainerConfig(log_every=1))
    out_whole = whole.run(9)
    assert out["log"][-1]["loss"] == out_whole["log"][-1]["loss"]
    for a, b in zip(resumed.state.params.parameters(),
                    whole.state.params.parameters()):
        assert torch.equal(a, b)


def test_trainers_from_one_module_start_alike(ref_params):
    model = _port_model(ref_params)
    before = [p.clone() for p in model.parameters()]
    _trainer(ref_params, TrainerConfig()).run(1)
    tr = Trainer(_port_loss, topt.make("adamw"), _port_batch,
                 TrainerConfig(), model, device="cpu")
    tr.run(2)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_grad_accum_equals_the_unsplit_step(ref_params):
    opt = topt.make("adamw")
    s1 = make_train_step(_port_loss, opt, TrainerConfig(grad_accum=1))
    s2 = make_train_step(_port_loss, opt, TrainerConfig(grad_accum=2))
    states = []
    for _ in range(2):
        m = _port_model(ref_params)
        states.append(TrainState(0, m, opt.init(ttr.to_reference_layout(m))))
    b = _port_batch(0)
    st1, m1 = s1(states[0], b)
    st2, m2 = s2(states[1], {k: torch.stack([v, v]) for k, v in b.items()})
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-6)
    for a, c in zip(st1.params.parameters(), st2.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   atol=1e-6)


def test_compressed_grads_still_descend(ref_params):
    tr = _trainer(ref_params, TrainerConfig(compress_grads=True,
                                            log_every=1), lr=5e-3)
    losses = [m["loss"] for m in tr.run(8)["log"]]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()


def test_sigterm_saves_and_stops(ref_params):
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(ref_params, TrainerConfig(ckpt_dir=d, ckpt_every=1000,
                                                log_every=1))
        orig = tr.make_batch

        def make_and_interrupt(step):
            if step == 3:
                tr._stop = True    # what the SIGTERM handler sets
            return orig(step)
        tr.make_batch = make_and_interrupt
        out = tr.run(10)
        assert out["interrupted"] and out["final_step"] == 4
        assert tck.latest_step(d) == 4


@pytest.mark.parametrize("name", NAMES)
def test_trainer_follows_the_reference(name, ref_params):
    """8 steps of each optimizer from the reference's initial weights on
    the same batches: the port's losses follow the reference's."""
    ref = rtrainer.Trainer(_ref_loss, ropt.make(name), _ref_batch,
                           rtrainer.TrainerConfig(log_every=1),
                           jax.tree.map(jnp.asarray, ref_params))
    want = [m["loss"] for m in ref.run(8)["log"]]
    got = [m["loss"] for m in _trainer(ref_params, TrainerConfig(
        log_every=1), name).run(8)["log"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_run_restores_the_sigterm_handler(ref_params):
    """run() routes SIGTERM to its stop flag only while it runs."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    tr = _trainer(ref_params, TrainerConfig(log_every=1))
    orig = tr.make_batch

    def make(step):
        seen.append(signal.getsignal(signal.SIGTERM))
        return orig(step)
    tr.make_batch = make
    tr.run(2)
    assert signal.getsignal(signal.SIGTERM) is before
    import threading
    if threading.current_thread() is threading.main_thread():
        assert seen and seen[0] is not before   # installed while running
