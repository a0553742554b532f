"""GCN (Kipf & Welling, arXiv:1609.02907) by edge-list message passing
(counterpart of ``repro/models/gcn.py``). For the symmetric normalization
Ã = D^-1/2 (A + I) D^-1/2,

    h' = Ã h W  ==  segment_sum((deg_s deg_d)^-1/2 * h[src], dst) W

Two modes: full-graph (one edge list) and the sampled mini-batch over the
layered blocks of ``sampler.py``, aggregated from the outermost hop inward.

Determinism: :func:`segment_sum` adds each segment's rows in edge order
over a stable sort (``torch.segment_reduce``), not with ``index_add_``,
whose float atomics on the card sum in arrival order; rows are gathered
by ``flat.take_rows``, whose backward sums each row in one fixed order.
A step gives the same bits every time it runs.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn

from ..core.kmeans import Seed
from ..core.precision import exact_matmuls
from ..device import resolve_device
from .flat import Dense, draw, generator, segment_sum, take_rows


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    """The reference's ``GCNConfig`` (``gcn.py:26``); ``dtype`` is a torch
    dtype."""

    name: str = "gcn"
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    aggregator: str = "mean"   # 'mean' (sym-normalized) per the cora config
    dtype: torch.dtype = torch.float32


def _dims(cfg: GCNConfig) -> list:
    return [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + \
        [cfg.n_classes]


class GCN(nn.Module):
    """``layer<i>.w`` (d_i, d_i+1) and ``layer<i>.b``, on
    ``resolve_device(device)``, values unset (see :func:`init_params`)."""

    def __init__(self, cfg: GCNConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dims = _dims(cfg)
        for i in range(cfg.n_layers):
            setattr(self, f"layer{i}",
                    Dense(dims[i], dims[i + 1], cfg.dtype, dev))


@torch.no_grad()
def init_params(seed: Seed, cfg: GCNConfig, device=None) -> GCN:
    """A :class:`GCN` drawn on its device from ``seed``: ``w`` ~
    N(0, 1/d_in), ``b`` = 0 (ref ``gcn.py:37``)."""
    model = GCN(cfg, device)
    gen = generator(seed, model.layer0.w.device)
    for i in range(cfg.n_layers):
        lp = getattr(model, f"layer{i}")
        draw(lp.w, gen, 1.0 / lp.w.shape[0] ** 0.5)
        lp.b.zero_()
    return model


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return take_rows(x, idx)


def _degrees(edges: torch.Tensor, n_nodes: int, edge_mask: torch.Tensor
             ) -> torch.Tensor:
    deg = segment_sum(edge_mask.float(), edges[1], n_nodes)
    return deg + 1.0  # + self loop


def propagate(x: torch.Tensor, edges: torch.Tensor, edge_mask: torch.Tensor,
              n_nodes: int) -> torch.Tensor:
    """One sym-normalized propagation Ã x (ref ``gcn.py:56``); edges
    (2, E) [src, dst]."""
    inv_sqrt = torch.rsqrt(_degrees(edges, n_nodes, edge_mask))
    src, dst = edges[0].long(), edges[1].long()
    coef = inv_sqrt[src] * inv_sqrt[dst] * edge_mask.float()
    msg = _gather(x, src) * coef[:, None]
    agg = segment_sum(msg, dst, n_nodes)
    return agg + x * (inv_sqrt * inv_sqrt)[:, None]  # self loop


@exact_matmuls()
def forward(params: GCN, feats: torch.Tensor, edges: torch.Tensor,
            edge_mask: torch.Tensor, cfg: GCNConfig) -> torch.Tensor:
    """feats (N, F) -> logits (N, n_classes) (ref ``gcn.py:69``)."""
    n = feats.shape[0]
    x = feats.to(cfg.dtype)
    for i in range(cfg.n_layers):
        x = propagate(x, edges, edge_mask, n)
        lp = getattr(params, f"layer{i}")
        x = x @ lp.w + lp.b
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, torch.clamp(labels, min=0).long()[:, None]
                         )[:, 0]


def loss_fn(params: GCN, batch: dict, cfg: GCNConfig) -> torch.Tensor:
    """batch: feats (N, F), edges (2, E), edge_mask (E,), labels (N,) int
    (-1 = unlabeled) -> mean NLL over the labeled nodes (ref
    ``gcn.py:83``)."""
    logits = forward(params, batch["feats"], batch["edges"],
                     batch["edge_mask"], cfg)
    labels = batch["labels"]
    valid = labels >= 0
    nll = torch.where(valid, _nll(logits, labels), 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


# ---------------------------------------------------------------------------
# sampled mini-batch forward (GraphSAGE-style layered blocks)
# ---------------------------------------------------------------------------

@exact_matmuls()
def forward_sampled(params: GCN, blocks: List[dict],
                    seed_feats: torch.Tensor, layer_feats: List[torch.Tensor],
                    cfg: GCNConfig) -> torch.Tensor:
    """blocks[i]: ``edges`` (2, E_i) (src indexes hop-(i+1) nodes, dst
    hop-i nodes) and ``edge_mask`` (E_i,); layer_feats[i] the features of
    the hop-(i+1) nodes; the seeds are hop 0 (ref ``gcn.py:102``)."""
    h = [x.to(cfg.dtype) for x in [seed_feats] + list(layer_feats)]
    for li in range(cfg.n_layers):
        new_h = []
        for hop in range(len(h) - 1):
            edges = blocks[hop]["edges"]
            emask = blocks[hop]["edge_mask"]
            n_dst = h[hop].shape[0]
            deg = segment_sum(emask.float(), edges[1], n_dst) + 1.0
            msg = _gather(h[hop + 1], edges[0]) * emask.to(cfg.dtype)[:, None]
            agg = segment_sum(msg, edges[1], n_dst)
            mixed = (agg + h[hop]) / deg[:, None]
            lp = getattr(params, f"layer{li}")
            out = mixed @ lp.w + lp.b
            if li < cfg.n_layers - 1:
                out = torch.relu(out)
            new_h.append(out)
        h = new_h
    return h[0]


def loss_fn_sampled(params: GCN, batch: dict, cfg: GCNConfig
                    ) -> torch.Tensor:
    """Mean NLL of the seeds (ref ``gcn.py:131``): ``edges<i>``,
    ``edge_mask<i>``, ``feats<i>`` (hop i) and ``labels``."""
    blocks = [{"edges": batch[f"edges{i}"],
               "edge_mask": batch[f"edge_mask{i}"]}
              for i in range(cfg.n_layers)]
    layer_feats = [batch[f"feats{i + 1}"] for i in range(cfg.n_layers)]
    logits = forward_sampled(params, blocks, batch["feats0"], layer_feats,
                             cfg)
    return _nll(logits, batch["labels"]).mean()
