"""DCN-v2 (Wang et al., arXiv:2008.13535): cross network + deep MLP
(counterpart of ``repro/models/recsys/dcn.py``).

x_{l+1} = x_0 ⊙ (W_l x_l + b_l) + x_l (full-rank cross layers), stacked:
the cross tower, then the deep tower on its output, then a one-unit head.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ...core.kmeans import Seed
from ...core.precision import exact_matmuls
from ...device import resolve_device
from ..flat import MLP, Dense, draw, generator, param
from .embedding_bag import bce_with_logits, embedding_bag, mlp


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    """The reference's ``DCNConfig`` (``dcn.py:20``); ``dtype`` is a torch
    dtype."""

    name: str = "dcn"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    vocab_sizes: Tuple[int, ...] = (1000,) * 26
    n_cross_layers: int = 3
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512)
    nnz: int = 1
    dtype: torch.dtype = torch.float32

    @property
    def x0_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


class DCN(nn.Module):
    """``tables.t<f>`` (V_f, D), ``cross`` (a list of (x0_dim, x0_dim)
    layers), ``deep`` and ``head`` MLPs, on ``resolve_device(device)``,
    values unset (see :func:`init_params`)."""

    def __init__(self, cfg: DCNConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tables = nn.Module()
        for f, v in enumerate(cfg.vocab_sizes):
            setattr(self.tables, f"t{f}",
                    param((v, cfg.embed_dim), cfg.dtype, dev))
        d0 = cfg.x0_dim
        self.cross = nn.ModuleList(Dense(d0, d0, cfg.dtype, dev)
                                   for _ in range(cfg.n_cross_layers))
        self.deep = MLP([d0, *cfg.mlp_dims], cfg.dtype, dev)
        self.head = MLP([cfg.mlp_dims[-1], 1], cfg.dtype, dev)


@torch.no_grad()
def init_params(seed: Seed, cfg: DCNConfig, device=None) -> DCN:
    """A :class:`DCN` drawn on its device from ``seed`` (ref
    ``dcn.py:36``): tables N(0, 0.05²), cross weights N(0, 1/x0_dim) with
    zero biases, then the deep and head MLPs."""
    model = DCN(cfg, device)
    gen = generator(seed, model.head[0].w.device)
    for f in range(cfg.n_sparse):
        draw(getattr(model.tables, f"t{f}"), gen, 0.05)
    for lp in model.cross:
        draw(lp.w, gen, 1.0 / cfg.x0_dim ** 0.5)
        lp.b.zero_()
    model.deep.fill(gen)
    model.head.fill(gen)
    return model


@exact_matmuls()
def forward(params: DCN, batch: dict, cfg: DCNConfig) -> torch.Tensor:
    """batch as DLRM's -> logits (B,) (ref ``dcn.py:54``)."""
    embs = [embedding_bag(getattr(params.tables, f"t{f}"),
                          batch["sparse_idx"][:, f],
                          batch["sparse_valid"][:, f])
            for f in range(cfg.n_sparse)]
    x0 = torch.cat([batch["dense"].to(cfg.dtype), *embs], dim=-1)
    x = x0
    for lp in params.cross:
        x = x0 * (x @ lp.w + lp.b) + x
    x = mlp(params.deep, x, final_act=True)
    return mlp(params.head, x)[:, 0]


def loss_fn(params: DCN, batch: dict, cfg: DCNConfig) -> torch.Tensor:
    """Binary cross-entropy on ``batch["labels"]`` (ref ``dcn.py:66``)."""
    return bce_with_logits(forward(params, batch, cfg), batch["labels"])
