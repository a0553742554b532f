"""Decoder-only transformer over token ids, dense or with experts, with GQA,
RoPE and SwiGLU (counterpart of ``repro/models/transformer.py``): the ColBERT
encoder's body, the causal LM the trainer's contracts use, and its serving
path, prefill and decode over a KV cache.

The reference stacks the layers' parameters on a leading ``n_layers`` axis
and runs them under ``lax.scan``; here a :class:`Transformer` holds them
unstacked in a ``ModuleList`` and runs them in a loop. Its attribute names
are the reference tree's keys (``embed``, ``layers``, ``final_norm.scale``,
``lm_head``, ``proj``), so :func:`reference_path` maps each parameter to its
reference leaf and :func:`to_reference_layout` / :func:`load_reference_layout`
stack and unstack the layer axis.

Entry points: :func:`init_params` (on ``resolve_device(device)``),
:func:`abstract_params` (on the ``meta`` device), :func:`forward_hidden`,
:func:`forward`, :func:`loss_fn`, :func:`prefill`, :func:`decode_step` and
:func:`init_cache`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.kmeans import Seed, generator
from ..core.precision import exact_matmuls
from ..device import resolve_device
from .flat import take_rows
from .layers import (Block, ModelConfig, Norm, _dense_init, _param,
                     attention_block, init_layer_params, rms_norm, swiglu,
                     uses_chunked)
from .moe import moe_block


class KVCache(NamedTuple):
    """Keys and values of every layer, (L, B, S, KV, Dh) each: the
    reference's stacked layout (``transformer.py:26``)."""
    k: torch.Tensor
    v: torch.Tensor


class Transformer(nn.Module):
    """The parameters of a dense transformer: ``embed`` (vocab, d),
    ``layers`` (a ``ModuleList`` of :class:`~.layers.Block`),
    ``final_norm``, ``lm_head`` (d, vocab) unless the embeddings are tied,
    and ``proj`` (d, out_proj) when ``cfg.out_proj``. Made with
    :func:`init_params` or ``params_from_reference``; the constructor leaves
    the values unset."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg.dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.dtype, dev)
        if not cfg.tie_embeddings and cfg.vocab > 0:
            self.lm_head = _param((cfg.d_model, cfg.vocab), cfg.dtype, dev)
        if cfg.out_proj:
            self.proj = _param((cfg.d_model, cfg.out_proj), cfg.dtype, dev)

    @property
    def device(self) -> torch.device:
        """The device the parameters live on."""
        return self.embed.device


@torch.no_grad()
def fill_params(model: Transformer, seed: Seed) -> Transformer:
    """Draw ``model``'s parameters from ``seed`` (an int or a CPU
    ``torch.Generator``) with the reference's shapes, dtypes and scales
    (ref ``transformer.py:31``): ``embed`` N(0, 0.02²), each layer as
    :func:`~.layers.init_layer_params`, then ``lm_head`` and ``proj``
    N(0, 0.02²), in that order. The draws are made on the CPU, so a seed
    gives the same weights on the CPU and on the card; jax.random's cannot
    be replayed, so they are not the reference's bits."""
    cfg, gen = model.cfg, generator(seed)
    model.embed.copy_(_dense_init(gen, tuple(model.embed.shape), cfg.dtype,
                                  0.02))
    for block in model.layers:
        init_layer_params(gen, cfg, block=block)
    model.final_norm.scale.fill_(1)
    for name in ("lm_head", "proj"):
        p = getattr(model, name, None)
        if p is not None:
            p.copy_(_dense_init(gen, tuple(p.shape), cfg.dtype, 0.02))
    return model


def init_params(seed: Seed, cfg: ModelConfig, device=None) -> Transformer:
    """A :class:`Transformer` on ``resolve_device(device)`` with weights
    drawn from ``seed`` (:func:`fill_params`)."""
    return fill_params(Transformer(cfg, device), seed)


def abstract_params(cfg: ModelConfig) -> Transformer:
    """A :class:`Transformer` on the ``meta`` device: every parameter's
    shape and dtype, no memory (ref ``transformer.py:50``)."""
    return Transformer(cfg, "meta")


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None
               ) -> KVCache:
    """A zero :class:`KVCache` of ``seq`` positions for ``batch`` sequences
    in ``cfg.dtype`` on ``resolve_device(device)``."""
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


# ---------------------------------------------------------------------------
# the reference's layout
# ---------------------------------------------------------------------------

def reference_path(name: str) -> Tuple[tuple, Optional[int]]:
    """A parameter's name (``layers.3.attn.wq``) -> (its reference leaf's
    path, ``("layers", "attn", "wq")``, and its index on the stacked layer
    axis, or None outside the layers)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def to_reference_layout(model: nn.Module, tensors=None) -> dict:
    """``{path: tensor}`` in the reference's layout and leaf order: the
    layer leaves stacked on a leading ``n_layers`` axis. ``tensors`` (one
    per parameter, in ``named_parameters`` order; the detached parameters
    by default) are what is laid out: gradients, for instance."""
    names = [n for n, _ in model.named_parameters()]
    if tensors is None:
        tensors = [p.detach() for p in model.parameters()]
    groups: dict = {}
    for name, t in zip(names, tensors):
        path, i = reference_path(name)
        groups.setdefault(path, []).append((i, t))
    out = {}
    for path in sorted(groups):
        items = groups[path]
        if items[0][0] is None:
            out[path] = items[0][1]
        else:
            out[path] = torch.stack([t for _, t in sorted(
                items, key=lambda it: it[0])])
    return out


@torch.no_grad()
def load_reference_layout(model: nn.Module, flat: dict) -> None:
    """Copy ``{path: array or tensor}`` in the reference's layout into
    ``model``'s parameters, unstacking the layer axis and casting to each
    parameter's dtype."""
    for name, p in model.named_parameters():
        path, i = reference_path(name)
        src = flat[path]
        src = as_tensor(src) if not isinstance(src, torch.Tensor) else src
        p.copy_((src if i is None else src[i]).to(p.dtype))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of their own, copied once (off
    the card, or on the CPU); bf16 as float32, which holds them exactly
    (numpy has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()


def as_tensor(a) -> torch.Tensor:
    """A numpy array (bf16 ones from jax included, by their bits) as a CPU
    tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(lp: Block, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, mask: Optional[torch.Tensor], cache=None
           ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                      torch.Tensor]:
    """One block (ref ``transformer.py:59``) -> (x, (k, v), aux): attention
    (over ``cache`` when given, ``layers.attention_block``), then the SwiGLU
    MLP, or the experts plus the shared experts' SwiGLU; aux is the
    experts' load-balance loss, 0 for a dense block."""
    h, kv = attention_block(lp.attn, rms_norm(x, lp.ln1.scale, cfg.norm_eps),
                            cfg, positions, mask, cache)
    x = x + h
    hin = rms_norm(x, lp.ln2.scale, cfg.norm_eps)
    if cfg.is_moe:
        ff, aux = moe_block(lp.moe, hin, cfg)
        if cfg.n_shared_experts:
            ff = ff + swiglu(lp.shared_mlp, hin)
    else:
        ff = swiglu(lp.mlp, hin)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ff, kv, aux


def _saves_weight_products(ctx, op, *args, **kwargs):
    """remat policy "dots": keep the outputs of products without batch
    dimensions (x @ W), as ``dots_with_no_batch_dims_saveable``; recompute
    the rest."""
    mm = op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    return (ckpt.CheckpointPolicy.MUST_SAVE if mm
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(lp, x, cfg, positions, mask):
    """:func:`_layer` under activation checkpointing (the reference's
    ``jax.checkpoint`` of the scan body, policy ``cfg.remat_policy``)."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _saves_weight_products)
    x, _, aux = ckpt.checkpoint(_layer, lp, x, cfg, positions, mask,
                                use_reentrant=False, **kw)
    return x, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _causal_mask(cfg: ModelConfig, s: int, device) -> Optional[torch.Tensor]:
    """The (S, S) causal mask, or None where the chunked attention, which
    masks by blocks, runs in its place (the reference builds the mask and
    leaves it unused there)."""
    if uses_chunked(cfg, s):
        return None
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))


def forward_hidden(params: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, attn_mask: Optional[torch.Tensor] = None,
                   remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux scalar) (ref
    ``transformer.py:87``). Token ids must lie in [0, vocab): the
    embedding lookup (``flat.take_rows``: its backward sums each row in one
    fixed order) raises on others, where the reference's ``jnp.take`` does
    not. ``attn_mask`` broadcasts against the (B, KV, G, S, T)
    logits; by default a causal config masks the future and a
    bidirectional one nothing. With ``remat`` and autograd on, each layer's
    activations are recomputed in the backward pass
    (``torch.utils.checkpoint``)."""
    b, s = tokens.shape
    x = take_rows(params.embed, tokens).to(cfg.dtype)
    positions = _positions(b, s, tokens.device)
    if attn_mask is not None:
        mask = attn_mask
    elif cfg.causal:
        mask = _causal_mask(cfg, s, tokens.device)
    else:
        mask = None
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp in params.layers:
        if remat and torch.is_grad_enabled():
            x, a = _remat_layer(lp, x, cfg, positions, mask)
        else:
            x, _, a = _layer(lp, x, cfg, positions, mask)
        aux = aux + a
    return rms_norm(x, params.final_norm.scale, cfg.norm_eps), aux


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux) (ref
    ``transformer.py:114``)."""
    h, aux = forward_hidden(params, tokens, cfg, remat=remat)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h @ head, aux


def loss_fn(params: Transformer, batch: dict, cfg: ModelConfig,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` (B, S), -1 ignored (ref ``transformer.py:122``)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    logits = logits.float()
    labels = batch["labels"]
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          torch.clamp(labels, min=0)[..., None].long())[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1) + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill and decode over a KV cache
# ---------------------------------------------------------------------------

def _logits(params: Transformer, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    h = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    return h @ (params.embed.T if cfg.tie_embeddings else params.lm_head)


@torch.no_grad()
@exact_matmuls()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, KVCache]:
    """tokens (B, S) -> (the last position's logits (B, V), the
    :class:`KVCache` of the S positions) (ref ``transformer.py:140``). A
    long causal prompt runs the chunked attention (``layers.uses_chunked``);
    each layer's keys and values are written into the cache as it runs."""
    b, s = tokens.shape
    x = take_rows(params.embed, tokens).to(cfg.dtype)
    positions = _positions(b, s, tokens.device)
    mask = _causal_mask(cfg, s, tokens.device)
    cache = init_cache(cfg, b, s, tokens.device)
    for i, lp in enumerate(params.layers):
        x, (k, v), _ = _layer(lp, x, cfg, positions, mask)
        cache.k[i].copy_(k)
        cache.v[i].copy_(v)
    return _logits(params, x[:, -1], cfg), cache


@torch.no_grad()
@exact_matmuls()
def decode_step(params: Transformer, cache: KVCache, token: torch.Tensor,
                pos, cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """One decode step (ref ``transformer.py:158``): token (B,) at position
    ``pos`` (an int or a 0-d tensor: the cache holds ``pos`` valid entries
    before the call) -> (logits (B, V), cache). The new token's keys and
    values are written into the caller's ``cache`` at ``pos`` in place, and
    that cache is returned: the reference donates the decode cache to the
    step (``launch/steps.py:428-436``), so its input is consumed there too.
    Attention runs over the whole cache, positions after ``pos`` masked."""
    b, s_max = token.shape[0], cache.k.shape[2]
    pos = int(pos)
    x = take_rows(params.embed, token[:, None]).to(cfg.dtype)
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    mask = (torch.arange(s_max, device=token.device) <= pos)[
        None, None, None, None, :]
    for i, lp in enumerate(params.layers):
        x, _, _ = _layer(lp, x, cfg, positions, mask,
                         cache=(cache.k[i], cache.v[i], pos))
    return _logits(params, x[:, 0], cfg), cache
