"""The port's LM serving path (``repro_torch.models``: ``moe``, the chunked
causal attention, attention over a decode cache, ``transformer.prefill`` /
``decode_step`` / ``KVCache`` / ``abstract_params``) against the reference's
(``repro.models``) on the CPU, on the reference's weights carried across by
``params_from_reference``, at one or two layers, d <= 192, float32. Inputs
come from numpy seeds. The reference runs in plain JAX (its own LM tests are
marked slow, so its functions are called directly here).

Tolerances (ROADMAP hazard 3: torch's and XLA's products round in other
orders): values at rtol 1e-5 with an atol of 1e-5 times the largest
magnitude of the compared tensor (an element near zero is a difference of
large terms and carries their rounding); gradients at rtol 1e-4 with the
same scaled atol. Selections are compared exactly: the routed expert ids and
the tokens each expert takes, zero-gate picks in lax tie order included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import layers as rlay
from repro.models import moe as rmoe
from repro.models import transformer as rtr
from repro_torch import models, tree
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlay
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

torch.set_num_threads(1)

VALS = dict(rtol=1e-5, scaled_atol=1e-5)
GRAD = dict(rtol=1e-4, scaled_atol=1e-5)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
          d_ff=128, vocab=300)
EXPERTS = dict(LM, d_ff=32, n_experts=8, top_k=2)
CHUNKS = dict(attn_q_chunk=8, attn_kv_chunk=16, attn_chunk_min_seq=16)
LM_ARCHS = ("granite-moe-1b-a400m", "internlm2-20b", "kimi-k2-1t-a32b",
            "qwen2.5-32b", "qwen2.5-3b")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=VALS, err_msg=""):
    got, want = _np(got), _np(want)
    tol = dict(tol)
    tol["atol"] = tol.pop("scaled_atol") * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)


def _configs(**kw):
    return rlay.ModelConfig(**kw), tlay.ModelConfig(**kw)


def _block(cfg_r, cfg_t, seed: int = 3):
    """A reference block's weights (numpy) and the port's Block holding
    them."""
    lp = jax.tree.map(np.asarray,
                      rlay.init_layer_params(jax.random.PRNGKey(seed), cfg_r))
    block = tlay.Block(cfg_t, "cpu")
    ttr.load_reference_layout(block, tree.flatten(lp))
    return lp, block


def _lm(cfg_r, cfg_t, seed: int = 1, biases: bool = False):
    params = jax.tree.map(np.asarray,
                          rtr.init_params(jax.random.PRNGKey(seed), cfg_r))
    if biases:   # non-zero QKV biases, so they are exercised
        rng = np.random.default_rng(seed)
        for b in ("bq", "bk", "bv"):
            leaf = params["layers"]["attn"][b]
            params["layers"]["attn"][b] = rng.normal(
                size=leaf.shape).astype(np.float32)
    return params, models.params_from_reference(params, cfg_t, device="cpu")


class _Picks:
    """Records each top-k's indices, the reference's (``jax.lax.top_k``
    inside ``repro.models.moe``) or the port's (``moe.topk``)."""

    def __init__(self, fn):
        self.fn, self.idx = fn, []

    def __call__(self, x, k):
        v, i = self.fn(x, k)
        self.idx.append(np.asarray(i))
        return v, i


# --- experts -----------------------------------------------------------------

# (capacity_factor, moe_groups): ample, tight (tokens dropped) and over the
# routed count (experts fill up with zero-gate tokens in tie order)
MOE_CASES = {"gather_ample": (100.0, 0), "gather_tight": (0.5, 0),
             "gather_over": (2.5, 0), "grouped_ample": (100.0, 2),
             "grouped_tight": (1.0, 4), "grouped_over": (2.5, 2)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_equals_the_reference(case, monkeypatch):
    """Output and aux loss of both dispatch modes; the routed expert ids
    and each expert's picks exactly; gradients of a weighted sum plus aux
    with respect to the input and the four expert weights."""
    cf, groups = MOE_CASES[case]
    cfg_r, cfg_t = _configs(**EXPERTS, capacity_factor=cf, moe_groups=groups)
    lp, block = _block(cfg_r, cfg_t)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    w = rng.normal(size=(2, 24, 64)).astype(np.float32)

    want_picks = _Picks(jax.lax.top_k)
    got_picks = _Picks(tmoe.topk)
    monkeypatch.setattr(jax.lax, "top_k", want_picks)
    monkeypatch.setattr(tmoe, "topk", got_picks)
    want, want_aux = rmoe.moe_block(lp["moe"], jnp.asarray(x), cfg_r)
    xt = torch.from_numpy(x).requires_grad_(True)
    got, got_aux = tmoe.moe_block(block.moe, xt, cfg_t)
    monkeypatch.undo()
    assert len(got_picks.idx) == len(want_picks.idx) == (1 if groups else 2)
    for g, wi in zip(got_picks.idx, want_picks.idx):
        np.testing.assert_array_equal(g, wi)
    _close(got, want)
    _close(got_aux, want_aux)

    t, k, e = 48, cfg_t.top_k, cfg_t.n_experts
    if not groups:   # what the case is about: drops, zero-gate picks
        routed = np.bincount(got_picks.idx[0].ravel(), minlength=e)
        cap = tmoe.gather_capacity(t, cfg_t)
        assert cap == int(max(1, min(t, round(t * k / e * cf))))
        dropped = np.maximum(routed - cap, 0).sum()
        zero_picks = np.maximum(cap - routed, 0).sum()
        assert (dropped > 0) == (case == "gather_tight")
        assert zero_picks > 0 or case == "gather_tight"
    else:
        assert tmoe.grouped_capacity(t // groups, cfg_t) == min(
            int(max(1, -(-(t // groups) * k // e) * max(1.0, cf))),
            t // groups)

    def ref_loss(p, xx):
        out, aux = rmoe.moe_block(p, xx, cfg_r)
        return jnp.sum(out * w) + aux
    g_p, g_x = jax.grad(ref_loss, argnums=(0, 1))(lp["moe"], jnp.asarray(x))
    (torch.sum(got * torch.from_numpy(w)) + got_aux).backward()
    _close(xt.grad, g_x, GRAD)
    for name in ("router", "wi_gate", "wi_up", "wo"):
        _close(getattr(block.moe, name).grad, g_p[name], GRAD, name)


def test_moe_modes_agree_at_ample_capacity():
    """The reference's own property (``tests/test_props.py:614``): with
    capacity above the tokens of a group, nothing drops and the grouped
    dispatch computes the capacity gather's function."""
    _, cfg = _configs(**EXPERTS, capacity_factor=100.0)
    _, block = _block(*_configs(**EXPERTS, capacity_factor=100.0))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 16, 64)).astype(np.float32))
    with torch.no_grad():
        out, aux = tmoe.moe_block(block.moe, x, cfg)
        for groups in (1, 2, 4):
            out_g, aux_g = tmoe.moe_block(
                block.moe, x, dataclasses.replace(cfg, moe_groups=groups))
            _close(out_g, out)
            _close(aux_g, aux)


def test_moe_gather_is_deterministic_and_refuses_uneven_groups():
    _, cfg = _configs(**EXPERTS, capacity_factor=0.5)
    _, block = _block(*_configs(**EXPERTS, capacity_factor=0.5))
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, 20, 64)).astype(np.float32))
    with torch.no_grad():
        a = tmoe.moe_block(block.moe, x, cfg)[0]
        b = tmoe.moe_block(block.moe, x, cfg)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_block(block.moe, x, dataclasses.replace(cfg, moe_groups=7))


# --- attention ---------------------------------------------------------------

@pytest.mark.parametrize("qc,kc", [(16, 16), (32, 8), (8, 32)])
def test_chunked_causal_attention_equals_the_reference(qc, kc):
    """The online softmax over kv chunks, and its gradient; skipping the
    chunks wholly in a query chunk's future and the mask of those wholly in
    its past changes no bit."""
    rng = np.random.default_rng(qc * 100 + kc)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    w = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)

    def ref(*qkv):
        out = rlay.chunked_causal_attention(*qkv, qc, kc)
        return jnp.sum(out * w), out
    (_, want), grads = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                          has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tlay.chunked_causal_attention(tq, tk, tv, qc, kc)
    _close(got, want)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), grads):
        _close(t.grad, g, GRAD)
    with torch.no_grad():
        every = tlay.chunked_causal_attention(tq, tk, tv, qc, kc,
                                              shortcuts=False)
    assert torch.equal(got, every)
    with torch.no_grad():
        dense = tlay.gqa_attention(tq, tk, tv, torch.tril(torch.ones(
            (64, 64), dtype=torch.bool)))
    _close(got, dense)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("s", [1, 3])
def test_attention_block_with_a_cache(qkv_bias, s):
    """New k/v written at pos into the caller's cache, attention over the
    whole cache under the mask; out and the merged k/v."""
    cfg_r, cfg_t = _configs(**LM, qkv_bias=qkv_bias)
    lp, block = _block(cfg_r, cfg_t)
    if qkv_bias:
        rng = np.random.default_rng(4)
        for b in ("bq", "bk", "bv"):
            lp["attn"][b] = rng.normal(size=lp["attn"][b].shape).astype(
                np.float32)
        ttr.load_reference_layout(block, tree.flatten(lp))
    rng = np.random.default_rng(5)
    b, t, pos = 2, 12, 7
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    kc = rng.normal(size=(b, t, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(b, t, 2, 16)).astype(np.float32)
    positions = np.full((b, s), pos, np.int32) + np.arange(s, dtype=np.int32)
    mask = (np.arange(t) <= pos + s - 1)[None, None, None, None, :]
    want, (wk, wv) = rlay.attention_block(
        lp["attn"], jnp.asarray(x), cfg_r, jnp.asarray(positions),
        jnp.asarray(mask), cache=(jnp.asarray(kc), jnp.asarray(vc), pos))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.no_grad():
        got, (gk, gv) = tlay.attention_block(
            block.attn, torch.from_numpy(x), cfg_t,
            torch.from_numpy(positions), torch.from_numpy(mask),
            cache=(tk, tv, pos))
    assert gk is tk and gv is tv        # written in place
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    with pytest.raises(ValueError, match="outside"):
        tlay.attention_block(block.attn, torch.from_numpy(x), cfg_t,
                             torch.from_numpy(positions), None,
                             cache=(tk, tv, t - s + 1))


def test_uses_chunked_is_the_reference_condition():
    cfg = tlay.ModelConfig(**LM, **CHUNKS)
    assert tlay.uses_chunked(cfg, 16) and tlay.uses_chunked(cfg, 32)
    assert not tlay.uses_chunked(cfg, 8)          # below attn_chunk_min_seq
    assert not tlay.uses_chunked(cfg, 24)         # kv chunk does not divide
    assert not tlay.uses_chunked(cfg, 32, cached=True)
    assert not tlay.uses_chunked(dataclasses.replace(cfg, causal=False), 32)
    assert not tlay.uses_chunked(tlay.ModelConfig(**LM), 1 << 14)


# --- prefill and decode ------------------------------------------------------

def _smoke(name: str):
    return rreg.get(name).make_smoke_config(), treg.get(name).make_smoke_config()


PREFILL = {"dense": lambda: _configs(**LM, **CHUNKS),
           "granite_smoke": lambda: tuple(
               dataclasses.replace(c, **CHUNKS)
               for c in _smoke("granite-moe-1b-a400m"))}


@pytest.mark.parametrize("name", sorted(PREFILL))
def test_prefill_equals_the_reference(name):
    """Last-position logits and the KVCache's k/v, with the chunked path
    forced (attn_chunk_min_seq = 16, as tests/test_perf_features.py)."""
    cfg_r, cfg_t = PREFILL[name]()
    params, model = _lm(cfg_r, cfg_t)
    tok = np.random.default_rng(11).integers(0, cfg_t.vocab, (2, 32))
    assert tlay.uses_chunked(cfg_t, 32)
    want, wcache = rtr.prefill(params, jnp.asarray(tok), cfg_r)
    got, gcache = ttr.prefill(model, torch.from_numpy(tok), cfg_t)
    assert isinstance(gcache, ttr.KVCache)
    assert gcache.k.shape == wcache.k.shape == (cfg_t.n_layers, 2, 32, 2, 16)
    _close(got, want)
    _close(gcache.k, wcache.k)
    _close(gcache.v, wcache.v)


DECODE = {"dense": (lambda: _configs(**LM), False),
          "qkv_bias": (lambda: _configs(**LM, qkv_bias=True), True),
          "granite_smoke": (lambda: _smoke("granite-moe-1b-a400m"), False),
          "kimi_smoke": (lambda: _smoke("kimi-k2-1t-a32b"), False)}


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_steps_equal_the_reference(name):
    """A 12-token prefill, its cache padded to 16, then 4 consecutive
    decode steps fed the reference's greedy tokens: logits and both caches
    after every step; the port's cache is the caller's, written in
    place."""
    make, biases = DECODE[name]
    cfg_r, cfg_t = make()
    params, model = _lm(cfg_r, cfg_t, biases=biases)
    b, s, s_max = 2, 12, 16
    tok = np.random.default_rng(12).integers(0, cfg_t.vocab, (b, s))
    want, wc = rtr.prefill(params, jnp.asarray(tok), cfg_r)
    got, gc = ttr.prefill(model, torch.from_numpy(tok), cfg_t)
    _close(got, want)
    pad = [(0, 0), (0, 0), (0, s_max - s), (0, 0), (0, 0)]
    wc = rtr.KVCache(jnp.pad(wc.k, pad), jnp.pad(wc.v, pad))
    cache = ttr.init_cache(cfg_t, b, s_max, "cpu")
    cache.k[:, :, :s] = gc.k
    cache.v[:, :, :s] = gc.v
    for step in range(4):
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        pos = s + step
        want, wc = rtr.decode_step(params, wc, jnp.asarray(nxt),
                                   jnp.int32(pos), cfg_r)
        got, out = ttr.decode_step(model, cache, torch.from_numpy(nxt),
                                   pos, cfg_t)
        assert out is cache
        _close(got, want, err_msg=f"step {step}")
        _close(cache.k, wc.k, err_msg=f"step {step}")
        _close(cache.v, wc.v, err_msg=f"step {step}")
    assert not cache.k[:, :, s + 4:].any()


@pytest.mark.parametrize("name", LM_ARCHS)
def test_abstract_params_equal_the_reference(name):
    """Every leaf's path, shape and dtype of the full config, kimi's
    1.04T parameters included; neither side allocates."""
    want = tree.flatten(rtr.abstract_params(rreg.get(name).make_config()))
    model = ttr.abstract_params(treg.get(name).make_config())
    got = models.to_reference_layout(model)
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert leaf.dtype == DTYPES[want[path].dtype.type], path
    if name == "kimi-k2-1t-a32b":
        assert sum(t.numel() for t in got.values()) > 1.0e12


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_with_experts(dtype):
    """params_from_reference -> params_to_reference gives the reference's
    tree back, the float32 router of a bf16 config included."""
    kw = dict(EXPERTS, n_shared_experts=1)
    cfg_r = rlay.ModelConfig(**kw, dtype=dtype)
    cfg_t = tlay.ModelConfig(**kw, dtype=DTYPES[dtype])
    params = jax.tree.map(np.asarray,
                          rtr.init_params(jax.random.PRNGKey(2), cfg_r))
    model = models.params_from_reference(params, cfg_t, device="cpu")
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.wi_gate.dtype == DTYPES[dtype]
    assert model.layers[0].shared_mlp.w_down.shape == (32, 64)
    back = models.params_to_reference(model)
    want = tree.flatten(params)
    got = tree.flatten(back)
    assert list(got) == list(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(a, np.float32),
                                      err_msg=str(path))


def test_init_draws_experts_as_the_reference():
    """The port's own draws: the reference's order of leaves, the float32
    router, and fan-in = shape[0] (E for the expert weights), by scale."""
    kw = dict(EXPERTS, n_shared_experts=2)
    cfg = tlay.ModelConfig(**kw, dtype=torch.bfloat16)
    block = tlay.init_layer_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    assert block.moe.router.dtype == torch.float32
    for name, fan_in in (("router", 64), ("wi_gate", 8), ("wi_up", 8),
                         ("wo", 8)):
        std = float(getattr(block.moe, name).detach().float().std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.1, name
    assert block.shared_mlp.w_gate.shape == (64, 64)
    assert not hasattr(block, "mlp")
