"""DIEN (Zhou et al., arXiv:1809.03672): interest evolution with AUGRU
(counterpart of ``repro/models/recsys/dien.py``).

The behaviour sequence goes through a GRU interest extractor, attention
against the target item, and an AUGRU (the update gate scaled by the
attention) interest evolver; the final state, the target and the mean of
the history go through an MLP to a CTR logit. The reference's two
``lax.scan``s are Python loops over the sequence here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ...core.kmeans import Seed
from ...core.precision import exact_matmuls
from ...device import resolve_device
from ..flat import MLP, draw, generator, param, take_rows
from .embedding_bag import bce_with_logits, mlp


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    """The reference's ``DIENConfig`` (``dien.py:22``); ``dtype`` is a
    torch dtype."""

    name: str = "dien"
    vocab_items: int = 100000
    vocab_cats: int = 1000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: Tuple[int, ...] = (200, 80)
    dtype: torch.dtype = torch.float32

    @property
    def item_dim(self) -> int:
        return 2 * self.embed_dim  # item embedding ++ category embedding


class GRU(nn.Module):
    """A GRU's ``wx`` (d_in, 3H), ``wh`` (H, 3H) and ``b`` (3H,), the gates
    in the order reset, update, candidate."""

    def __init__(self, d_in: int, d_h: int, dtype, device):
        super().__init__()
        self.wx = param((d_in, 3 * d_h), dtype, device)
        self.wh = param((d_h, 3 * d_h), dtype, device)
        self.b = param((3 * d_h,), dtype, device)

    @torch.no_grad()
    def fill(self, gen: torch.Generator) -> None:
        """``wx`` ~ N(0, 1/d_in), ``wh`` ~ N(0, 1/H), ``b`` = 0 (ref
        ``dien.py:37``)."""
        draw(self.wx, gen, 1.0 / self.wx.shape[0] ** 0.5)
        draw(self.wh, gen, 1.0 / self.wh.shape[0] ** 0.5)
        self.b.zero_()


def _gru_cell(p: GRU, h: torch.Tensor, x: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A GRU step (ref ``dien.py:47``); with ``att`` (B, 1) the update gate
    is scaled by it (AUGRU, the DIEN contribution)."""
    gx = x @ p.wx + p.b
    gh = h @ p.wh
    xr, xz, xn = torch.chunk(gx, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    if att is not None:
        z = att * z
    return (1.0 - z) * h + z * n


class DIEN(nn.Module):
    """``item_emb``, ``cat_emb`` (vocab, D), ``gru1`` and ``gru2``
    (:class:`GRU`), ``att_w`` (2D, H) and the ``head`` MLP, on
    ``resolve_device(device)``, values unset (see :func:`init_params`)."""

    def __init__(self, cfg: DIENConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d_in = cfg.item_dim
        self.item_emb = param((cfg.vocab_items, cfg.embed_dim), cfg.dtype,
                              dev)
        self.cat_emb = param((cfg.vocab_cats, cfg.embed_dim), cfg.dtype, dev)
        self.gru1 = GRU(d_in, cfg.gru_dim, cfg.dtype, dev)
        self.gru2 = GRU(cfg.gru_dim, cfg.gru_dim, cfg.dtype, dev)
        self.att_w = param((d_in, cfg.gru_dim), cfg.dtype, dev)
        self.head = MLP([cfg.gru_dim + 2 * d_in, *cfg.mlp_dims, 1], cfg.dtype,
                        dev)


@torch.no_grad()
def init_params(seed: Seed, cfg: DIENConfig, device=None) -> DIEN:
    """A :class:`DIEN` drawn on its device from ``seed`` (ref
    ``dien.py:63``): the embeddings and ``att_w`` N(0, 0.05²), the GRUs as
    :meth:`GRU.fill`, the head MLP."""
    model = DIEN(cfg, device)
    gen = generator(seed, model.item_emb.device)
    draw(model.item_emb, gen, 0.05)
    draw(model.cat_emb, gen, 0.05)
    model.gru1.fill(gen)
    model.gru2.fill(gen)
    draw(model.att_w, gen, 0.05)
    model.head.fill(gen)
    return model


def _embed_items(params: DIEN, items, cats) -> torch.Tensor:
    return torch.cat([take_rows(params.item_emb, items),
                      take_rows(params.cat_emb, cats)], dim=-1)


@exact_matmuls()
def forward(params: DIEN, batch: dict, cfg: DIENConfig) -> torch.Tensor:
    """batch: hist_items/hist_cats (B, L) int, hist_valid (B, L) bool,
    target_item/target_cat (B,) int -> logits (B,) (ref ``dien.py:85``)."""
    hist = _embed_items(params, batch["hist_items"], batch["hist_cats"])
    target = _embed_items(params, batch["target_item"], batch["target_cat"])
    valid = batch["hist_valid"].to(cfg.dtype)
    h = torch.zeros((hist.shape[0], cfg.gru_dim), dtype=cfg.dtype,
                    device=hist.device)
    h0 = h

    # interest extractor GRU over the sequence
    states = []
    for t in range(hist.shape[1]):
        v = valid[:, t, None]
        h = v * _gru_cell(params.gru1, h, hist[:, t]) + (1 - v) * h
        states.append(h)
    states = torch.stack(states, dim=1)                        # (B, L, H)

    # attention of the target against the extracted interests
    att_logits = torch.einsum("bh,blh->bl", target @ params.att_w, states)
    att_logits = torch.where(batch["hist_valid"], att_logits, -1e9)
    att = torch.softmax(att_logits.float(), dim=-1).to(cfg.dtype)

    # AUGRU interest evolution
    h = h0
    for t in range(states.shape[1]):
        v = valid[:, t, None]
        hn = _gru_cell(params.gru2, h, states[:, t], att=att[:, t, None])
        h = v * hn + (1 - v) * h

    hist_mean = (hist * valid[..., None]).sum(1) / torch.clamp(
        valid.sum(1, keepdim=True), min=1)
    feat = torch.cat([h, target, hist_mean], dim=-1)
    return mlp(params.head, feat)[:, 0]


def loss_fn(params: DIEN, batch: dict, cfg: DIENConfig) -> torch.Tensor:
    """Binary cross-entropy on ``batch["labels"]`` (ref ``dien.py:125``)."""
    return bce_with_logits(forward(params, batch, cfg), batch["labels"])
