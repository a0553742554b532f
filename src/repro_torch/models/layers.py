"""Transformer layers (counterpart of ``repro/models/layers.py``): RMS norm,
RoPE, grouped-query attention with optional QKV bias, the chunked causal
attention of long prefills, attention over a decode cache, the SwiGLU MLP.

A block's parameters live in ``nn.Module``s whose attribute names are the
reference's dict keys (``attn.wq``, ``ln1.scale``, ``mlp.w_gate``, ...) and
whose weights keep its layout (``x @ wq``), so a reference tree loads leaf
for leaf (:func:`repro_torch.models.params_from_reference`). The ops are
plain functions on tensors, as in the reference.

Compute dtype policy, as the reference's: matmuls in ``cfg.dtype``, softmax
and norm statistics in float32.

The sharding hooks (``attn_act_specs``, ``residual_spec``, ``moe_specs``)
are specs of the logical mesh (``repro_torch.sharding``). One process holds
every tensor whole, so they change no number, as the reference's
``with_sharding_constraint`` changes none; the dry run
(``launch/op_stats.py``) reads them from the config.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` (``layers.py:20``), field for field;
    ``dtype`` is a torch dtype.

    ``n_experts`` > 0 makes each block's FFN a mixture of experts
    (``models/moe.py``): ``top_k`` experts a token, ``n_shared_experts``
    SwiGLUs of width ``d_ff`` every token also goes through, expert capacity
    sized by ``capacity_factor``, and ``moe_groups`` > 0 for the grouped
    dispatch in place of the capacity gather. A causal attention without a
    cache runs in ``attn_q_chunk`` x ``attn_kv_chunk`` blocks
    (:func:`chunked_causal_attention`) when ``attn_q_chunk`` > 0, the
    sequence is at least ``attn_chunk_min_seq`` long and both chunks divide
    it. ``attn_act_specs`` ((qg_spec, kv_spec): context parallelism),
    ``residual_spec`` (the residual stream's spec: sequence parallelism)
    and ``moe_specs`` ((token spec, expert spec)) are the reference's
    sharding hooks: specs as ``repro_torch.sharding.rules`` writes them,
    which change no number."""

    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 32
    d_ff: int = 256
    vocab: int = 1024
    qkv_bias: bool = False            # Qwen2.5 uses QKV bias
    causal: bool = True               # False for the ColBERT encoder
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    out_proj: int = 0                 # ColBERT's projection width (0 = none)
    tie_embeddings: bool = False
    # "dots" recomputes all but the weight products' outputs in the
    # backward pass, "full" recomputes everything (forward_hidden's remat)
    remat_policy: str = "dots"
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    attn_q_chunk: int = 0
    attn_kv_chunk: int = 0
    attn_chunk_min_seq: int = 8192
    attn_act_specs: Any = None
    residual_spec: Any = None
    moe_groups: int = 0
    moe_specs: Any = None

    def __post_init__(self):
        if self.remat_policy not in ("dots", "full"):
            raise ValueError(f"remat_policy {self.remat_policy!r}: 'dots' "
                             "or 'full'")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Norm(nn.Module):
    """An RMS norm's ``scale``."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (d, heads · d_head), ``wo`` (heads · d_head,
    d) and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
        self.wq = _param((d, h * dh), cfg.dtype, device)
        self.wk = _param((d, kv * dh), cfg.dtype, device)
        self.wv = _param((d, kv * dh), cfg.dtype, device)
        self.wo = _param((h * dh, d), cfg.dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h * dh,), cfg.dtype, device)
            self.bk = _param((kv * dh,), cfg.dtype, device)
            self.bv = _param((kv * dh,), cfg.dtype, device)


class MLP(nn.Module):
    """SwiGLU's ``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d); f is
    ``d_ff``, or ``d_ff · n_shared_experts`` for the shared expert."""

    def __init__(self, cfg: ModelConfig, device, f: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, f or cfg.d_ff
        self.w_gate = _param((d, f), cfg.dtype, device)
        self.w_up = _param((d, f), cfg.dtype, device)
        self.w_down = _param((f, d), cfg.dtype, device)


class Experts(nn.Module):
    """The experts' ``router`` (d, E), float32 in any config, as the
    reference's, and the SwiGLU weights ``wi_gate``, ``wi_up`` (E, d, d_ff)
    and ``wo`` (E, d_ff, d) in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = _param((d, e), torch.float32, device)
        self.wi_gate = _param((e, d, f), cfg.dtype, device)
        self.wi_up = _param((e, d, f), cfg.dtype, device)
        self.wo = _param((e, f, d), cfg.dtype, device)


class Block(nn.Module):
    """One transformer block: ``attn``, ``ln1``, ``ln2`` and either ``mlp``
    or, with experts, ``moe`` and (with shared experts) ``shared_mlp``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.ln1 = Norm(cfg.d_model, cfg.dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.dtype, device)
        if cfg.is_moe:
            self.moe = Experts(cfg, device)
            if cfg.n_shared_experts:
                self.shared_mlp = MLP(cfg, device,
                                      cfg.d_ff * cfg.n_shared_experts)
        else:
            self.mlp = MLP(cfg, device)


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws times ``scale`` (1/sqrt(fan_in) by default), made in
    float32 on the CPU and cast (ref ``layers.py:80``). fan_in is
    ``shape[0]``, as the reference's: E for the (E, d, f) and (E, f, d)
    expert weights."""
    fan_in = shape[0]
    s = torch.tensor(scale if scale is not None else 1.0 / fan_in ** 0.5,
                     dtype=torch.float32)
    return (torch.randn(shape, generator=gen) * s).to(dtype)


@torch.no_grad()
def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      device=None, block: Optional[Block] = None) -> Block:
    """One block's parameters (ref ``layers.py:86``), drawn from ``gen`` (a
    CPU generator, so a seed gives the same weights on any device) in the
    reference's order: the four attention weights, then the three MLP
    weights, or the experts' router, ``wi_gate``, ``wi_up``, ``wo`` and the
    shared expert's three; the norm scales one, the QKV biases zero. Fills
    ``block`` when given."""
    block = block if block is not None else Block(cfg, device)
    a = block.attn
    ffn = ((block.moe.router, block.moe.wi_gate, block.moe.wi_up,
            block.moe.wo) if cfg.is_moe else ())
    for m in (getattr(block, "mlp", None), getattr(block, "shared_mlp", None)):
        if m is not None:
            ffn += (m.w_gate, m.w_up, m.w_down)
    for p in (a.wq, a.wk, a.wv, a.wo) + ffn:
        p.copy_(_dense_init(gen, tuple(p.shape), p.dtype))
    block.ln1.scale.fill_(1)
    block.ln2.scale.fill_(1)
    if cfg.qkv_bias:
        for b in (a.bq, a.bk, a.bv):
            b.zero_()
    return block


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d tensor of ``value`` on ``device``, made once: making
    one from a Python number on the card is a host-to-device copy that waits
    for the stream, which once a layer kept the host from running ahead."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=torch.float32, device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Statistics in float32, cast back to ``x.dtype`` before the scale
    (ref ``layers.py:133``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_tables(positions: torch.Tensor, d_head: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos, sin (..., d_head // 2) float32 (ref
    ``layers.py:139``)."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(_scalar(theta, positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, Dh); cos/sin (..., S, Dh // 2), broadcast over heads
    (ref ``layers.py:148``). bf16 ``x`` times the float32 tables computes
    in float32 and is cast back once."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, S, H, Dh), k/v (B, T, KV, Dh) -> (B, S, H, Dh) (ref
    ``layers.py:157``). Softmax in float32; masked logits are -1e30, not
    -inf, so a query row masked everywhere (a padding token) gets a
    uniform softmax, finite with a finite gradient. The probabilities are
    cast to ``q.dtype`` before the PV product. Plain products: no fused
    attention, which would compute another softmax."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / torch.sqrt(_scalar(float(dh), q.device))
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_chunk: int, kv_chunk: int,
                             shortcuts: bool = True) -> torch.Tensor:
    """Causal attention by blocks, the online softmax of flash attention in
    plain products (ref ``layers.py:173``): q (B, S, H, Dh), k/v (B, S, KV,
    Dh) -> (B, S, H, Dh); both chunks divide S. The largest intermediate is
    a (B, KV, G, q_chunk, kv_chunk) block of logits, not (B, KV, G, S, S).

    Each query chunk runs over the kv chunks in order 0, 1, ... with the
    reference's arithmetic: float32 logits scaled by 1/sqrt(Dh), -1e30 where
    a key lies in the query's future and as the initial running max, p cast
    to ``q.dtype`` before the PV product, whose output is cast to float32.
    Two shortcuts change no bit. A kv chunk wholly in the query chunk's
    future is skipped: every row's running max is finite after chunk 0
    (which holds position 0), so there alpha = exp(0) = 1 and p = 0, and m,
    l and acc would stay as they are. A kv chunk wholly in its past is not
    masked: the mask would select every logit. ``shortcuts=False`` runs
    every chunk under the mask, as the reference does."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / torch.sqrt(_scalar(float(dh), q.device))
    nq, nk = s // q_chunk, s // kv_chunk
    assert nq * q_chunk == s and nk * kv_chunk == s, (s, q_chunk, kv_chunk)
    qg = q.reshape(b, nq, q_chunk, kvh, g, dh)
    kc = k.reshape(b, nk, kv_chunk, kvh, dh)
    vc = v.reshape(b, nk, kv_chunk, kvh, dh)
    arange_q = torch.arange(q_chunk, device=q.device)
    arange_k = torch.arange(kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]                                 # (B, qc, KV, G, Dh)
        q_lo, q_hi = qi * q_chunk, qi * q_chunk + q_chunk - 1
        m = torch.full((b, kvh, g, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        for ki in range(min(nk, q_hi // kv_chunk + 1) if shortcuts else nk):
            k_lo = ki * kv_chunk
            logits = torch.einsum("bqkgd,btkd->bkgqt", qblk,
                                  kc[:, ki]).float().mul_(scale)
            if k_lo + kv_chunk - 1 > q_lo or not shortcuts:
                future = (q_lo + arange_q)[:, None] < (k_lo + arange_k)[None]
                logits.masked_fill_(future, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            lsum = lsum * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(q.dtype),
                              vc[:, ki]).float()
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = (acc / torch.clamp(lsum, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))         # (B, qc, KV, G, Dh)
    return torch.stack(outs, dim=1).reshape(b, s, h, dh)


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`gqa_attention` over a decode cache k/v (B, T, KV, Dh): the
    same logits, masking, float32 softmax and cast of the probabilities,
    with one product for the logits and one for the output, each over a
    sequence's cache rows (T, KV · Dh) as they lie, read once and never
    copied into another layout. Each kv head's queries sit on that head's
    block of a (KV · G · S, KV · Dh) matrix of zeros, whose products add
    exact zeros; PV keeps each head's diagonal block. Both run KV times the
    operations of one product a head, which decode's few query rows
    afford."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    eye = torch.eye(kvh, dtype=q.dtype, device=q.device)
    qg = q.reshape(b, s, kvh, g, dh).permute(0, 2, 3, 1, 4)   # (B,KV,G,S,Dh)
    qbd = qg[..., None, :] * eye[None, :, None, None, :, None]
    logits = torch.bmm(qbd.reshape(b, kvh * g * s, kvh * dh),
                       k.reshape(b, t, kvh * dh).transpose(1, 2))
    logits = logits.reshape(b, kvh, g, s, t).float()
    logits = logits / torch.sqrt(_scalar(float(dh), q.device))
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    full = torch.bmm(probs.reshape(b, kvh * g * s, t),
                     v.reshape(b, t, kvh * dh))
    out = torch.diagonal(full.reshape(b, kvh, g, s, kvh, dh), dim1=1,
                         dim2=4)                              # (B,G,S,Dh,KV)
    return out.permute(0, 2, 4, 1, 3).reshape(b, s, h, dh)


def uses_chunked(cfg: ModelConfig, s: int, cached: bool = False) -> bool:
    """Whether an attention over ``s`` positions runs
    :func:`chunked_causal_attention`: the reference's condition
    (``layers.py:271``), no more and no less."""
    return (not cached and cfg.causal and cfg.attn_q_chunk > 0
            and s >= cfg.attn_chunk_min_seq and s % cfg.attn_q_chunk == 0
            and s % cfg.attn_kv_chunk == 0)


def attention_block(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, mask: Optional[torch.Tensor],
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          int]] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """-> (out, (k, v)) (ref ``layers.py:241``).

    Without ``cache``, k/v are this call's keys and values, and a long
    causal sequence runs :func:`chunked_causal_attention` (which ignores
    ``mask``) under :func:`uses_chunked`'s condition. With ``cache=(k_layer,
    v_layer, pos)`` (decode), the new k/v are written into ``k_layer`` and
    ``v_layer`` (B, T, KV, Dh) at position ``pos`` in place, attention runs
    over the whole cache under ``mask``, and the cache tensors are
    returned. A write past the cache's end raises, where the reference's
    ``dynamic_update_slice`` moves it back inside."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kvh, dh)
    v = v.reshape(b, s, kvh, dh)
    cos, sin = rope_tables(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        k_layer, v_layer, pos = cache
        pos = int(pos)
        if not 0 <= pos <= k_layer.shape[1] - s:
            raise ValueError(f"position {pos} + {s} new entries lies outside "
                             f"a cache of {k_layer.shape[1]}")
        k_layer[:, pos:pos + s] = k.to(k_layer.dtype)
        v_layer[:, pos:pos + s] = v.to(v_layer.dtype)
        out = cache_attention(q, k_layer, v_layer, mask)
        k, v = k_layer, v_layer
    elif uses_chunked(cfg, s):
        out = chunked_causal_attention(q, k, v, cfg.attn_q_chunk,
                                       cfg.attn_kv_chunk)
    else:
        out = gqa_attention(q, k, v, mask)
    return out.reshape(b, s, h * dh) @ p.wo, (k, v)


def swiglu(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """(silu(x W_gate) * x W_up) W_down (ref ``layers.py:292``)."""
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
