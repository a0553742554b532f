"""Transformer layers (counterpart of ``repro/models/layers.py``): RMS norm,
RoPE, grouped-query attention with optional QKV bias, the SwiGLU MLP.

A block's parameters live in ``nn.Module``s whose attribute names are the
reference's dict keys (``attn.wq``, ``ln1.scale``, ``mlp.w_gate``, ...) and
whose weights keep its layout (``x @ wq``), so a reference tree loads leaf
for leaf (:func:`repro_torch.models.params_from_reference`). The ops are
plain functions on tensors, as in the reference.

Compute dtype policy, as the reference's: matmuls in ``cfg.dtype``, softmax
and norm statistics in float32.

Left out (ROADMAP Queue 1 item 3): experts (``models/moe.py``), the chunked
causal attention, the KV cache and the sharding hooks. A config that asks
for one of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_LEFT_OUT = "not ported yet: the LM serving slice (ROADMAP Queue 1 item 3)"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` (``layers.py:20``), with the fields
    the dense encoder and LM compute with. ``dtype`` is a torch dtype.

    ``n_experts``, ``attn_q_chunk``, ``attn_act_specs``, ``residual_spec``,
    ``moe_groups`` and ``moe_specs`` are kept only to refuse them: any value
    but the default raises ``NotImplementedError`` naming the module that
    is missing. ``top_k``, ``n_shared_experts``, ``capacity_factor``,
    ``attn_kv_chunk`` and ``attn_chunk_min_seq`` go with them and are
    unused."""

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
        asked = [(name, module) for name, module, on in (
            ("n_experts", "models/moe.py", self.n_experts > 0),
            ("attn_q_chunk", "layers.chunked_causal_attention",
             self.attn_q_chunk > 0),
            ("attn_act_specs", "the sharding hooks",
             self.attn_act_specs is not None),
            ("residual_spec", "the sharding hooks",
             self.residual_spec is not None),
            ("moe_groups", "models/moe.py", self.moe_groups > 0),
            ("moe_specs", "models/moe.py", self.moe_specs is not None)) if on]
        if asked:
            raise NotImplementedError(
                f"ModelConfig({', '.join(n for n, _ in asked)}) needs "
                f"{', '.join(dict.fromkeys(m for _, m in asked))}, "
                f"{_LEFT_OUT}")
        if self.remat_policy not in ("dots", "full"):
            raise ValueError(f"remat_policy {self.remat_policy!r}: 'dots' "
                             "or 'full'")


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
    """SwiGLU's ``w_gate``, ``w_up`` (d, d_ff) and ``w_down`` (d_ff, d)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), cfg.dtype, device)
        self.w_up = _param((d, f), cfg.dtype, device)
        self.w_down = _param((f, d), cfg.dtype, device)


class Block(nn.Module):
    """One transformer block: ``attn``, ``ln1``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.ln1 = Norm(cfg.d_model, cfg.dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.dtype, device)
        self.mlp = MLP(cfg, device)


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws times ``scale`` (1/sqrt(fan_in) by default), made in
    float32 on the CPU and cast (ref ``layers.py:80``)."""
    fan_in = shape[0]
    s = torch.tensor(scale if scale is not None else 1.0 / fan_in ** 0.5,
                     dtype=torch.float32)
    return (torch.randn(shape, generator=gen) * s).to(dtype)


@torch.no_grad()
def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      device=None, block: Optional[Block] = None) -> Block:
    """One block's parameters (ref ``layers.py:86``): the four attention
    and three MLP weights drawn from ``gen`` (a CPU generator, so a seed
    gives the same weights on any device) in that order, the norm scales
    one, the QKV biases zero. Fills ``block`` when given."""
    block = block if block is not None else Block(cfg, device)
    a, m = block.attn, block.mlp
    for p in (a.wq, a.wk, a.wv, a.wo, m.w_gate, m.w_up, m.w_down):
        p.copy_(_dense_init(gen, tuple(p.shape), cfg.dtype))
    block.ln1.scale.fill_(1)
    block.ln2.scale.fill_(1)
    if cfg.qkv_bias:
        for b in (a.bq, a.bk, a.bv):
            b.zero_()
    return block


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

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
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
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
    logits = logits / torch.sqrt(torch.tensor(float(dh), device=q.device))
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def attention_block(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """-> (out, (k, v)): this call's keys and values (ref
    ``layers.py:241``, without its decode cache and chunking)."""
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
    out = gqa_attention(q, k, v, mask)
    return out.reshape(b, s, h * dh) @ p.wo, (k, v)


def swiglu(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """(silu(x W_gate) * x W_up) W_down (ref ``layers.py:292``)."""
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
