"""The port's encoder (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU: each layer op, the transformer's forward and
loss, the ColBERT encoder, its MaxSim scores and contrastive loss (with and
without straight-through PQ), and their gradients, on the reference's
weights carried across by ``params_from_reference``. Inputs come from a
numpy seed; token ids are in range (the port's embedding raises on others,
where ``jnp.take`` fills).

Tolerances (ROADMAP hazard 3: torch's and XLA's products and reductions
round in other orders). Encoder outputs, unit vectors: rtol 1e-5 / atol
1e-6 (measured ~5e-7). Unnormalized values (hidden states, logits, MaxSim
scores) and gradients: rtol 1e-5 (1e-4 for gradients) with an atol of 1e-5
times the largest magnitude of the compared tensor, about 80 float32 ulps
of it: an element near zero is a difference of large terms and carries
their rounding (measured ~1e-6 of the largest). bf16 values: rtol / atol
2e-2, about two bf16 ulps, as one rounding of a float32 difference can
flip a bf16 result by an ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as rpq
from repro.models import colbert as rcol
from repro.models import layers as rlay
from repro.models import transformer as rtr
from repro_torch import models, tree
from repro_torch.core import engine as teng
from repro_torch.core import pq as tpq
from repro_torch.core import precision
from repro_torch.core.index import index_from_arrays
from repro_torch.models import colbert as tcol
from repro_torch.models import layers as tlay
from repro_torch.models import transformer as ttr

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)        # unit-norm embeddings
SCALED = dict(rtol=1e-5, scaled_atol=1e-5)   # atol relative to max |want|
GRAD = dict(rtol=1e-4, scaled_atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
WIDTH = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128,
             vocab=300, out_dim=32)
LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
          d_ff=128, vocab=300)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


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


def _pair(x: np.ndarray, jdt, tdt):
    """The same values as a jax and a torch array of the two dtypes."""
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.fixture(scope="module")
def colbert_pair():
    cfg_r = rcol.make_config(**WIDTH)
    params = jax.tree.map(np.asarray,
                          rcol.init_params(jax.random.PRNGKey(0), cfg_r))
    cfg_t = tcol.make_config(**WIDTH)
    return (params, cfg_r), (models.params_from_reference(
        params, cfg_t, device="cpu"), cfg_t)


@pytest.fixture(scope="module")
def lm_pair():
    cfg_r = rlay.ModelConfig(**LM)
    params = jax.tree.map(np.asarray,
                          rtr.init_params(jax.random.PRNGKey(1), cfg_r))
    cfg_t = tlay.ModelConfig(**LM)
    return (params, cfg_r), (models.params_from_reference(
        params, cfg_t, device="cpu"), cfg_t)


def _batch(seed: int, b: int = 4, sq: int = 8, sd: int = 16):
    """Tokens and ragged validity (one doc of a single token, one query
    with padding)."""
    rng = np.random.default_rng(seed)
    d_len = np.array([16, 12, 5, 1][:b])
    q_len = np.array([8, 6, 8, 3][:b])
    return {"q_tokens": rng.integers(0, WIDTH["vocab"], (b, sq)),
            "q_valid": np.arange(sq)[None] < q_len[:, None],
            "d_tokens": rng.integers(0, WIDTH["vocab"], (b, sd)),
            "d_valid": np.arange(sd)[None] < d_len[:, None]}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _grads_match(ref_grads, model, tol=GRAD):
    got = ttr.to_reference_layout(
        model, [torch.zeros_like(p) if p.grad is None else p.grad
                for p in model.parameters()])
    want = tree.flatten(jax.tree.map(np.asarray, ref_grads))
    assert set(got) == set(want)
    for path, g in want.items():
        _close(got[path], g, tol, err_msg=str(path))


# --- layer ops ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32)
    (xj, xt), (sj, st) = _pair(x, jdt, tdt), _pair(s, jdt, tdt)
    got = tlay.rms_norm(xt, st, 1e-6)
    assert got.dtype == tdt
    _close(got, rlay.rms_norm(xj, sj, 1e-6), tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    cj, sj = rlay.rope_tables(jnp.asarray(pos), 16, 1e6)
    ct, st = tlay.rope_tables(torch.from_numpy(pos), 16, 1e6)
    _close(ct, cj, F32)
    _close(st, sj, F32)
    x = np.random.default_rng(1).normal(size=(2, 12, 4, 16)).astype(
        np.float32)
    xj, xt = _pair(x, jdt, tdt)
    got = tlay.apply_rope(xt, ct, st)
    assert got.dtype == tdt
    _close(got, rlay.apply_rope(xj, cj, sj), tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_attention_with_mask(dtype):
    """Four query heads over two KV heads, a key mask with padding and one
    row masked everywhere (a uniform softmax, finite)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
    valid = np.arange(6)[None] < np.array([6, 4])[:, None]
    mask = (valid[:, None, :] & valid[:, :, None])[:, None, None]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, jdt, tdt) for a in (q, k, v))
    want = rlay.gqa_attention(qj, kj, vj, jnp.asarray(mask))
    got = tlay.gqa_attention(qt, kt, vt, torch.from_numpy(mask))
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    _close(got, want, tol)
    _close(tlay.gqa_attention(qt, kt, vt, None),
           rlay.gqa_attention(qj, kj, vj, None), tol)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_block_and_swiglu(qkv_bias):
    cfg_r = rlay.ModelConfig(**LM, qkv_bias=qkv_bias)
    cfg_t = tlay.ModelConfig(**LM, qkv_bias=qkv_bias)
    lp = jax.tree.map(np.asarray,
                      rlay.init_layer_params(jax.random.PRNGKey(3), cfg_r))
    if qkv_bias:   # non-zero biases, so they are exercised
        rng = np.random.default_rng(3)
        for b in ("bq", "bk", "bv"):
            lp["attn"][b] = rng.normal(size=lp["attn"][b].shape).astype(
                np.float32)
    block = tlay.Block(cfg_t, "cpu")
    ttr.load_reference_layout(block, tree.flatten(lp))
    x = np.random.default_rng(4).normal(size=(2, 7, 64)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0)
    mask = np.tril(np.ones((7, 7), bool))
    want, (kr, vr) = rlay.attention_block(lp["attn"], jnp.asarray(x), cfg_r,
                                          jnp.asarray(pos), jnp.asarray(mask))
    got, (kt, vt) = tlay.attention_block(block.attn, torch.from_numpy(x),
                                         cfg_t, torch.from_numpy(pos),
                                         torch.from_numpy(mask))
    for g, w in ((got, want), (kt, kr), (vt, vr)):
        _close(g, w, F32)
    _close(tlay.swiglu(block.mlp, torch.from_numpy(x)),
           rlay.swiglu(lp["mlp"], jnp.asarray(x)), F32)


def test_model_config_refuses_what_the_slice_leaves_out():
    """Nothing of the reference's is left out any more: the sharding hooks
    (specs as tuples of axis names), experts, chunked attention and the
    grouped dispatch are accepted, with the reference's fields; only a
    remat policy the reference does not know is refused."""
    for kw in (dict(attn_act_specs=(("data", None, "model", None, None,
                                     None), ("data", None, None, None,
                                             None))),
               dict(residual_spec=("data", "model", None)),
               dict(moe_specs=(("data", None, None), None)),
               dict(n_experts=4, top_k=2, n_shared_experts=1,
                    capacity_factor=1.0),
               dict(attn_q_chunk=128, attn_kv_chunk=256,
                    attn_chunk_min_seq=512),
               dict(n_experts=4, top_k=1, moe_groups=2)):
        cfg = tlay.ModelConfig(**kw)
        want = rlay.ModelConfig(**kw)
        assert cfg.is_moe == want.is_moe
        for k, v in kw.items():
            assert getattr(cfg, k) == getattr(want, k) == v
        block = tlay.Block(cfg, "cpu")
        assert hasattr(block, "moe") == cfg.is_moe
        assert hasattr(block, "mlp") != cfg.is_moe
    with pytest.raises(ValueError):
        tlay.ModelConfig(remat_policy="some")


# --- the transformer ---------------------------------------------------------

@pytest.mark.parametrize("remat,policy", [(False, "dots"), (True, "dots"),
                                          (True, "full")])
def test_forward_hidden_and_its_gradient(lm_pair, remat, policy):
    """Causal GQA forward_hidden and the gradient of a weighted sum of its
    output, with and without remat (which changes no value)."""
    import dataclasses
    (params, cfg_r), (model, cfg_t) = lm_pair
    cfg_t = dataclasses.replace(cfg_t, remat_policy=policy)
    tok = np.random.default_rng(5).integers(0, LM["vocab"], (3, 10))
    w = np.random.default_rng(6).normal(size=(3, 10, 64)).astype(np.float32)

    def ref(p):
        h, _ = rtr.forward_hidden(p, jnp.asarray(tok), cfg_r, remat=remat)
        return jnp.sum(h * w), h
    (_, h_r), g_r = jax.value_and_grad(ref, has_aux=True)(params)
    model.zero_grad()
    h_t, aux = ttr.forward_hidden(model, torch.from_numpy(tok), cfg_t,
                                  remat=remat)
    (h_t * torch.from_numpy(w)).sum().backward()
    assert float(aux) == 0.0
    _close(h_t, h_r, SCALED)
    _grads_match(g_r, model)


@pytest.mark.parametrize("tie", [False, True])
def test_forward_and_loss_fn(lm_pair, tie):
    """Logits, the next-token loss (-1 labels ignored) and its gradient;
    with tied embeddings the head is ``embed.T`` and there is no
    ``lm_head``."""
    (params, cfg_r), (model, cfg_t) = lm_pair
    if tie:
        cfg_r = rlay.ModelConfig(**LM, tie_embeddings=True)
        cfg_t = tlay.ModelConfig(**LM, tie_embeddings=True)
        params = {k: v for k, v in params.items() if k != "lm_head"}
        model = models.params_from_reference(params, cfg_t, device="cpu")
        assert not hasattr(model, "lm_head")
    rng = np.random.default_rng(7)
    tok = rng.integers(0, LM["vocab"], (3, 10))
    labels = np.where(rng.random((3, 10)) < 0.2, -1, tok)
    logits_r, _ = rtr.forward(params, jnp.asarray(tok), cfg_r)
    logits_t, _ = ttr.forward(model, torch.from_numpy(tok), cfg_t)
    _close(logits_t, logits_r, SCALED)
    batch = {"tokens": tok, "labels": labels}
    loss_r, g_r = jax.value_and_grad(rtr.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_r)
    model.zero_grad()
    loss_t = ttr.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, cfg_t)
    loss_t.backward()
    _close(loss_t, loss_r, F32)
    _grads_match(g_r, model)


# --- ColBERT -----------------------------------------------------------------

def test_colbert_encode(colbert_pair):
    """Equal to the reference's; unit norms on valid tokens, zeros on
    padding."""
    (params, cfg_r), (model, cfg_t) = colbert_pair
    b = _batch(8)
    want = rcol.encode(params, jnp.asarray(b["d_tokens"]),
                       jnp.asarray(b["d_valid"]), cfg_r)
    with torch.no_grad():
        got = model(torch.from_numpy(b["d_tokens"]),
                    torch.from_numpy(b["d_valid"]))
    _close(got, want, F32)
    norms = np.linalg.norm(got.numpy(), axis=-1)
    np.testing.assert_allclose(norms[b["d_valid"]], 1.0, rtol=1e-5)
    assert (got.numpy()[~b["d_valid"]] == 0).all()


def test_maxsim_scores():
    rng = np.random.default_rng(9)
    b = _batch(9)
    qe = rng.normal(size=(4, 8, 32)).astype(np.float32)
    de = rng.normal(size=(4, 16, 32)).astype(np.float32)
    want = rcol.maxsim_scores(jnp.asarray(qe), jnp.asarray(b["q_valid"]),
                              jnp.asarray(de), jnp.asarray(b["d_valid"]))
    got = tcol.maxsim_scores(torch.from_numpy(qe),
                             torch.from_numpy(b["q_valid"]),
                             torch.from_numpy(de),
                             torch.from_numpy(b["d_valid"]))
    _close(got, want, SCALED)


def _codebooks(seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(4, 16, 8)) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("jmpq", [False, True])
def test_contrastive_loss_and_gradient(colbert_pair, jmpq):
    """The loss and jax.grad against autograd, with and without the
    straight-through PQ of the documents (JMPQ). With PQ the two encoders'
    document embeddings are first checked to give the same codes (no
    near-tie at this seed), so the forward compares like with like."""
    (params, cfg_r), (model, cfg_t) = colbert_pair
    bj, bt = _both(_batch(10))
    cb = _codebooks(11) if jmpq else None
    if jmpq:
        de_r = rcol.encode(params, bj["d_tokens"], bj["d_valid"], cfg_r)
        with torch.no_grad():
            de_t = model(bt["d_tokens"], bt["d_valid"])
        codes_r = rpq.encode_pq(de_r.reshape(-1, 32), rpq.PQCodebooks(
            jnp.asarray(cb)))
        codes_t = tpq.encode_pq(de_t.reshape(-1, 32), tpq.PQCodebooks(
            torch.from_numpy(cb)))
        np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_r))
    loss_r, g_r = jax.value_and_grad(rcol.contrastive_loss)(
        params, bj, cfg_r, None if cb is None else jnp.asarray(cb))
    model.zero_grad()
    loss_t = tcol.contrastive_loss(
        model, bt, cfg_t, None if cb is None else torch.from_numpy(cb))
    loss_t.backward()
    assert np.isfinite(float(loss_t.detach()))
    _close(loss_t, loss_r, F32)
    _grads_match(g_r, model)


def test_pq_ste_forward_and_identity_backward():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(40, 32)).astype(np.float32) * 0.3
    cb = _codebooks(13)
    w = rng.normal(size=(40, 32)).astype(np.float32)
    ref_cb = rpq.PQCodebooks(jnp.asarray(cb))
    val_r, g_r = jax.value_and_grad(
        lambda v: jnp.sum(rpq.pq_ste(v, ref_cb) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tpq.pq_ste(xt, tpq.PQCodebooks(torch.from_numpy(cb)))
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, rpq.pq_ste(jnp.asarray(x), ref_cb), F32)
    _close(out, tpq.decode_pq(tpq.encode_pq(xt.detach(), tpq.PQCodebooks(
        torch.from_numpy(cb))), tpq.PQCodebooks(torch.from_numpy(cb))), F32)
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    np.testing.assert_array_equal(np.asarray(g_r), w)


# --- weights -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    """params_from_reference ∘ params_to_reference is the identity; the
    reference's tree comes back leaf for leaf (bf16 as float32 values)."""
    jdt, tdt, _ = DTYPES[dtype]
    cfg_r = rcol.make_config(**WIDTH, dtype=jdt)
    ref = jax.tree.map(np.asarray,
                       rcol.init_params(jax.random.PRNGKey(14), cfg_r))
    cfg_t = tcol.make_config(**WIDTH, dtype=tdt)
    model = models.params_from_reference(ref, cfg_t, device="cpu")
    assert isinstance(model, tcol.ColBERT)
    back = models.params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for (pa, a), (pb, b) in zip(tree.leaves(back), tree.leaves(ref)):
        assert pa == pb and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = models.params_from_reference(back, cfg_t, device="cpu")
    for (na, a), (nb, b) in zip(model.named_parameters(),
                                again.named_parameters()):
        assert na == nb and a.dtype == tdt and torch.equal(a, b)


def test_init_params_shapes_dtypes_and_scales():
    """The port's init draws the reference's shapes, dtypes and scales
    (not its bits: jax.random cannot be replayed), the same from a seed on
    any device."""
    cfg_r = rcol.make_config(**WIDTH)
    ref = jax.tree.map(np.asarray,
                       rcol.init_params(jax.random.PRNGKey(0), cfg_r))
    model = tcol.init_params(0, tcol.make_config(**WIDTH), device="cpu")
    got = tree.flatten(models.params_to_reference(model))
    want = tree.flatten(ref)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path[-1] == "scale":
            assert (g == 1).all()
        else:   # N(0, s^2): s = 0.02 or 1/sqrt(fan_in)
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.15,
                                       err_msg=str(path))
    again = tcol.ColBERT(tcol.make_config(**WIDTH), 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


# --- matmul flags ------------------------------------------------------------

def test_matmul_flags_are_restored(small_index, colbert_pair):
    """retrieve and encode set the three process-wide matmul flags only
    around their products (precision.exact_matmuls): set either way before,
    they read the same after. The flags can be set without CUDA."""
    ref, _ = small_index
    index = index_from_arrays({f: np.asarray(getattr(ref, f))
                               for f in ref._fields}, device="cpu")
    q = torch.from_numpy(np.random.default_rng(15).normal(
        size=(2, 32, index.centroids.shape[1])).astype(np.float32))
    cfg = teng.EngineConfig(n_filter=64, n_docs=16, k=10)
    (_, _), (model, cfg_t) = colbert_pair
    b = _batch(16)
    saved = precision._matmul_flags()
    try:
        for flags in ((True, True, True), (False, True, True),
                      (True, False, False)):
            precision._set_matmul_flags(flags)
            teng.retrieve(index, q, cfg, device="cpu")
            assert precision._matmul_flags() == flags
            with torch.no_grad():
                model(torch.from_numpy(b["d_tokens"]),
                      torch.from_numpy(b["d_valid"]))
            assert precision._matmul_flags() == flags
            with precision.exact_matmuls():
                with precision.exact_matmuls():
                    assert precision._matmul_flags() == (False,) * 3
                assert precision._matmul_flags() == (False,) * 3
            assert precision._matmul_flags() == flags
    finally:
        precision._set_matmul_flags(saved)
