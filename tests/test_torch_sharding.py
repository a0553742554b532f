"""The sharding hooks change no bit in one process, and ``make_ood_corpus``
is the reference's.

``ModelConfig``'s ``attn_act_specs``, ``residual_spec`` and ``moe_specs``
(the specs ``launch/steps.py`` sets on the production meshes), ``Trainer``'s
``micro_param_layout`` and muon's ``mats_spec`` are where the reference
constrains a sharding; in one process each leaves every number as it was,
as ``with_sharding_constraint`` does. Held bit for bit on the CPU against
the same config without them: ``forward``, ``prefill`` and 4 decode steps
of the MoE and the dense smoke configs (and the long-prompt path through
the chunked attention), and train steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import synthetic as rsyn
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.models import to_reference_layout
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import TrainerConfig, TrainState, make_train_step

torch.set_num_threads(1)

DAX = ("data",)
HOOKS = dict(attn_act_specs=((DAX, None, "model", None, None, None),
                             (DAX, None, None, None, None)),
             residual_spec=(DAX, "model", None),
             moe_specs=((DAX, None, None), None))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,chunked", [
    ("granite-moe-1b-a400m", False), ("kimi-k2-1t-a32b", False),
    ("qwen2.5-3b", False), ("qwen2.5-3b", True)])
def test_hooks_change_no_bit(arch, chunked):
    base = registry.get(arch).make_smoke_config()
    if chunked:
        base = dataclasses.replace(base, attn_q_chunk=16, attn_kv_chunk=32,
                                   attn_chunk_min_seq=64)
    hooked = dataclasses.replace(base, **HOOKS)
    model = T.init_params(5, base, "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab, (2, 64)).astype(np.int64))
    with torch.no_grad():
        la, aa = T.forward(model, tok, base, remat=False)
        lb, ab = T.forward(model, tok, hooked, remat=False)
        assert _same(la, lb) and _same(aa, ab)
        la, ca = T.prefill(model, tok[:, :48], base)
        lb, cb = T.prefill(model, tok[:, :48], hooked)
        assert _same(la, lb)
        assert _same(ca.k, cb.k) and _same(ca.v, cb.v)
        ca, cb = (T.init_cache(c, 2, 52, "cpu") for c in (base, hooked))
        for pos in range(48, 52):
            la, ca = T.decode_step(model, ca, tok[:, pos], pos, base)
            lb, cb = T.decode_step(model, cb, tok[:, pos], pos, hooked)
            assert _same(la, lb)
        assert _same(ca.k, cb.k) and _same(ca.v, cb.v)


def _step_bits(cfg, opt, layout=None, ga: int = 2):
    model = T.init_params(7, cfg, "cpu")
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab, (ga, 2, 16), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=-1)}
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt,
                           TrainerConfig(grad_accum=ga),
                           micro_param_layout=layout)
    state = TrainState(0, model, opt.init(to_reference_layout(model)))
    for _ in range(2):
        state, metrics = step(state, batch)
    return to_reference_layout(state.params), metrics


def test_identity_micro_param_layout_and_mats_spec_change_no_bit():
    cfg = registry.get("qwen2.5-3b").make_smoke_config()
    want, wm = _step_bits(cfg, opt_lib.make("adamw"))
    got, gm = _step_bits(cfg, opt_lib.make("adamw"), layout=lambda p: p)
    assert all(_same(got[k], want[k]) for k in want)
    assert _same(gm["loss"], wm["loss"])
    def mats_spec(shape):
        return (None,) * (len(shape) - 2) + (DAX, "model")
    want, wm = _step_bits(cfg, opt_lib.make("muon"))
    got, gm = _step_bits(cfg, opt_lib.make("muon", mats_spec=mats_spec))
    assert all(_same(got[k], want[k]) for k in want)
    assert _same(gm["grad_norm"], wm["grad_norm"])


@pytest.mark.parametrize("seed", [0, 7])
def test_make_ood_corpus_equals_reference(seed):
    kw = dict(n_docs=300, n_queries=12, n_topics=16, d=32)
    got, want = synthetic.make_ood_corpus(seed, **kw), \
        rsyn.make_ood_corpus(seed, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.doc_embs.shape[1] == 96 and got.doc_lens.min() >= 48
    # a caller's sizes win over the defaults, as in the reference
    small = synthetic.make_ood_corpus(seed, cap=40, min_len=8, **kw)
    assert np.array_equal(small.doc_lens,
                          rsyn.make_ood_corpus(seed, cap=40, min_len=8,
                                               **kw).doc_lens)
