"""DLRM (Naumov et al., arXiv:1906.00091), the MLPerf benchmark config
(counterpart of ``repro/models/recsys/dlrm.py``).

13 dense features -> bottom MLP; 26 sparse fields -> per-field EmbeddingBag
(multi-hot, summed); pairwise dot interaction over the 27 feature vectors in
``numpy.triu_indices(27, k=1)`` order; top MLP -> CTR logit. The Criteo-1TB
vocabularies are in ``repro_torch.configs.dlrm_mlperf``.

With ``use_pq_tables`` each table is ``m`` uint8 codes a row (a buffer) and
float codebooks: the reference's beyond-paper application of EMVB's PQ.
Such a model's tree has integer leaves, so the trainer refuses it with
``TypeError``, as the reference's ``jax.value_and_grad`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ...core.kmeans import Seed
from ...core.precision import exact_matmuls
from ...device import resolve_device
from ..flat import MLP, draw, generator, param
from .embedding_bag import (bce_with_logits, embedding_bag,
                            embedding_bag_pq, mlp)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The reference's ``DLRMConfig`` (``dlrm.py:26``); ``dtype`` is a
    torch dtype."""

    name: str = "dlrm"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    vocab_sizes: Tuple[int, ...] = (1000,) * 26
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    nnz: int = 1                  # multi-hot width per field
    use_pq_tables: bool = False
    pq_m: int = 16
    pq_k: int = 256
    dtype: torch.dtype = torch.float32


class PQTable(nn.Module):
    """A PQ-compressed table: ``codes`` (V, m) uint8, a buffer, and
    ``codebooks`` (m, K, D / m)."""

    def __init__(self, v: int, cfg: DLRMConfig, device):
        super().__init__()
        self.register_buffer("codes", torch.empty(
            (v, cfg.pq_m), dtype=torch.uint8, device=device))
        self.codebooks = param((cfg.pq_m, cfg.pq_k,
                                cfg.embed_dim // cfg.pq_m), cfg.dtype, device)


class DLRM(nn.Module):
    """``tables.t<f>`` (one per sparse field: a (V_f, D) parameter or a
    :class:`PQTable`), ``bot`` and ``top`` MLPs, on
    ``resolve_device(device)``, values unset (see :func:`init_params`)."""

    def __init__(self, cfg: DLRMConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tables = nn.Module()
        for f, v in enumerate(cfg.vocab_sizes):
            t = (PQTable(v, cfg, dev) if cfg.use_pq_tables
                 else param((v, cfg.embed_dim), cfg.dtype, dev))
            setattr(self.tables, f"t{f}", t)
        self.bot = MLP([cfg.n_dense, *cfg.bot_mlp], cfg.dtype, dev)
        n_feat = cfg.n_sparse + 1
        n_pairs = n_feat * (n_feat - 1) // 2
        self.top = MLP([n_pairs + cfg.bot_mlp[-1], *cfg.top_mlp], cfg.dtype,
                       dev)


@torch.no_grad()
def init_params(seed: Seed, cfg: DLRMConfig, device=None) -> DLRM:
    """A :class:`DLRM` drawn on its device from ``seed`` (ref
    ``dlrm.py:42``): tables N(0, 0.05²) (PQ codes uniform in [0, K),
    codebooks N(0, 0.05²)), field by field, then the bottom and top MLPs."""
    model = DLRM(cfg, device)
    gen = generator(seed, model.bot[0].w.device)
    for f in range(cfg.n_sparse):
        t = getattr(model.tables, f"t{f}")
        if cfg.use_pq_tables:
            t.codes.copy_(torch.randint(0, cfg.pq_k, t.codes.shape,
                                        generator=gen, device=t.codes.device))
            draw(t.codebooks, gen, 0.05)
        else:
            draw(t, gen, 0.05)
    model.bot.fill(gen)
    model.top.fill(gen)
    return model


@exact_matmuls()
def forward(params: DLRM, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense (B, 13) float; sparse_idx (B, 26, nnz) int;
    sparse_valid (B, 26, nnz) bool -> logits (B,) (ref ``dlrm.py:64``)."""
    dense = mlp(params.bot, batch["dense"].to(cfg.dtype), final_act=True)
    embs = []
    for f in range(cfg.n_sparse):
        t = getattr(params.tables, f"t{f}")
        idx = batch["sparse_idx"][:, f]
        val = batch["sparse_valid"][:, f]
        if cfg.use_pq_tables:
            embs.append(embedding_bag_pq(t.codes, t.codebooks, idx, val))
        else:
            embs.append(embedding_bag(t, idx, val))
    z = torch.stack([dense, *embs], dim=1)                      # (B, 27, D)
    inter = torch.einsum("bid,bjd->bij", z, z)                  # (B, 27, 27)
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1,
                                device=z.device)
    pairs = inter[:, iu, ju]                                    # (B, n_pairs)
    top_in = torch.cat([dense, pairs.to(cfg.dtype)], dim=-1)
    return mlp(params.top, top_in)[:, 0]


def loss_fn(params: DLRM, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Binary cross-entropy on ``batch["labels"]`` (ref ``dlrm.py:84``)."""
    return bce_with_logits(forward(params, batch, cfg), batch["labels"])
