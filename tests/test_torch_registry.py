"""The port's architecture registry (``repro_torch.configs``) and ``--arch``
launcher (``repro_torch.launch.train``) against the reference's on the CPU:
the same names, specs, shapes and configs (dtypes mapped jax -> torch),
every LM config included; ``build_smoke_trainer`` for every recsys arch,
``gcn-cora`` and every LM smoke config (the two with experts, kimi's with
Muon and a shared expert, among them) follows the reference's losses over 8
steps when both start from the reference's weights and see the reference's
batches; grad accumulation and ``main``.

Tolerance: losses at rtol 1e-4 over 8 steps (the gradients differ by ~1e-6
relative, ``tests/test_torch_recsys.py``; Adam and Adagrad normalize them,
so the weights drift apart by about that much a step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.launch import train as rlaunch
from repro_torch import models, tree
from repro_torch.configs import registry as treg
from repro_torch.launch import train as tlaunch

torch.set_num_threads(1)

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
TRAINED = ("mind", "dlrm-mlperf", "dcn-v2", "dien", "gcn-cora",
           "qwen2.5-3b", "qwen2.5-32b", "internlm2-20b",
           "granite-moe-1b-a400m", "kimi-k2-1t-a32b")
EXPERTS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")


# EngineConfig's Pallas interpret-mode switch: the port's kernels have no
# interpret mode, so its EngineConfig has no such field.
PALLAS_ONLY = {"kernel_interpret"}


def _fields(cfg) -> dict:
    """A config's fields, dtypes as torch's, nested configs as dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name in PALLAS_ONLY:
            continue
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif not isinstance(v, (str, int, float, bool, tuple, type(None),
                                torch.dtype)):
            v = DTYPES.get(v, v)
        out[f.name] = v
    return out


def test_names_equal_the_reference():
    assert treg.names() == rreg.names()
    assert len(treg.names()) == 11


@pytest.mark.parametrize("name", rreg.names())
def test_spec_and_smoke_config_equal_the_reference(name):
    want, got = rreg.get(name), treg.get(name)
    for f in ("name", "family", "optimizer", "model_flops_params", "fsdp",
              "notes"):
        assert getattr(got, f) == getattr(want, f), f
    assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    ref_cfg = want.make_smoke_config()
    cfg = got.make_smoke_config()
    assert _fields(cfg) == _fields(ref_cfg)


@pytest.mark.parametrize("name", rreg.names())
def test_full_config_equals_the_reference_or_names_what_is_missing(name):
    spec = treg.get(name)
    if name in EXPERTS:
        assert spec.make_config().is_moe and spec.make_smoke_config().is_moe
    kw = [dict(shape=s) for s in spec.shapes] if name == "gcn-cora" else [{}]
    for k in kw:
        assert _fields(spec.make_config(**k)) == _fields(
            rreg.get(name).make_config(**k))


def _ref_params(name: str, cfg):
    spec = rreg.get(name)
    key = jax.random.PRNGKey(0)
    if spec.family == "lm":
        from repro.models import transformer as M
    elif spec.family == "gnn":
        from repro.models import gcn as M
    else:
        from repro.launch.steps import _recsys_model
        M = _recsys_model(name)
    return jax.tree.map(np.asarray, M.init_params(key, cfg))


def _ref_batch_fn(name: str, cfg):
    spec = rreg.get(name)
    if spec.family == "lm":
        return rlaunch.lm_batch_fn(cfg.vocab)
    if spec.family == "gnn":
        return rlaunch.gnn_batch_fn(cfg)
    return rlaunch.recsys_batch_fn(name, cfg)


@pytest.mark.parametrize("name", TRAINED)
def test_smoke_trainer_follows_the_reference(name):
    """Both launchers' smoke trainers, the port's given the reference's
    initial weights and batches, log every step: the same losses at rtol
    1e-4 over 8 steps."""
    ref = rlaunch.build_smoke_trainer(name)
    port = tlaunch.build_smoke_trainer(name, device="cpu")
    rcfg = rreg.get(name).make_smoke_config()
    params = _ref_params(name, rcfg)
    models.load_reference_layout(port.state.params, tree.flatten(params))
    make = _ref_batch_fn(name, rcfg)
    port.make_batch = lambda step: {k: torch.from_numpy(np.array(v))
                                    for k, v in make(step).items()}
    for tr in (ref, port):
        tr.cfg = dataclasses.replace(tr.cfg, log_every=1)
    want = [m["loss"] for m in ref.run(8)["log"]]
    got = [m["loss"] for m in port.run(8)["log"]]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert port.state.step == 8


def test_smoke_trainer_starts_from_the_reference_init_distribution():
    """The port's own weights (seed 0, drawn with torch) have the
    reference's tree, dtypes and scales."""
    for name in ("mind", "dlrm-mlperf", "dcn-v2", "dien", "gcn-cora") + \
            EXPERTS:
        port = tlaunch.build_smoke_trainer(name, device="cpu")
        ref = _ref_params(name, rreg.get(name).make_smoke_config())
        got = models.params_to_reference(port.state.params)
        assert jax.tree.structure(got) == jax.tree.structure(ref), name
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if b.size > 100:
                assert abs(a.std() - b.std()) < 0.2 * b.std() + 1e-6, name


def test_grad_accum_and_main(capsys, tmp_path):
    tr = tlaunch.build_smoke_trainer("dcn-v2", grad_accum=2, device="cpu")
    assert tr.make_batch(0)["dense"].shape == (2, 32, 13)
    out = tr.run(3)
    assert out["final_step"] == 3 and np.isfinite(out["log"][-1]["loss"])
    tlaunch.main(["--arch", "gcn-cora", "--steps", "6", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "done at step 6" in printed and "loss" in printed
    tlaunch.main(["--arch", "gcn-cora", "--steps", "8", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path)])
    assert "done at step 8" in capsys.readouterr().out


def test_unknown_arch_and_family_refused():
    with pytest.raises(KeyError):
        tlaunch.build_smoke_trainer("no-such-arch", device="cpu")
    with pytest.raises(ValueError):
        tlaunch.recsys_batch_fn("gcn-cora", None)(0)
