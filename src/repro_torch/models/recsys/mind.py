"""MIND (Li et al., arXiv:1904.08030): multi-interest retrieval with capsule
routing (counterpart of ``repro/models/recsys/mind.py``). A MIND user is a
multi-vector query of ``n_interests`` capsules, and candidate scoring is
late interaction with n_q = n_interests, so the user's interests go through
the EMVB engine over the item table (``examples/mind_emvb_retrieval_torch.py``).

Behaviour-to-Interest (B2I) dynamic routing from fixed ``sin`` logits,
label-aware attention for the training-style score, an in-batch softmax for
the loss; serving scores ``max_k interest_k . item``. Products run under
``exact_matmuls`` (TF32 off), as the reference computes in float32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...core.kmeans import Seed
from ...core.precision import exact_matmuls
from ...device import resolve_device
from ..flat import draw, generator, param, take_rows


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    """The reference's ``MINDConfig`` (``mind.py:23``); ``dtype`` is a
    torch dtype."""

    name: str = "mind"
    vocab_items: int = 200000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    pow_label_aware: float = 2.0
    dtype: torch.dtype = torch.float32


class MIND(nn.Module):
    """``item_emb`` (vocab_items, D) and ``s`` (D, D), the shared bilinear
    routing map, on ``resolve_device(device)``, values unset (see
    :func:`init_params`)."""

    def __init__(self, cfg: MINDConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.item_emb = param((cfg.vocab_items, cfg.embed_dim), cfg.dtype,
                              dev)
        self.s = param((cfg.embed_dim, cfg.embed_dim), cfg.dtype, dev)


def init_params(seed: Seed, cfg: MINDConfig, device=None) -> MIND:
    """A :class:`MIND` with ``item_emb`` ~ N(0, 0.05²) and ``s`` ~
    N(0, 1/D) (ref ``mind.py:34``), drawn on its device from ``seed``."""
    model = MIND(cfg, device)
    gen = generator(seed, model.item_emb.device)
    draw(model.item_emb, gen, 0.05)
    draw(model.s, gen, 1.0 / cfg.embed_dim ** 0.5)
    return model


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


@exact_matmuls()
def user_interests(params: MIND, hist_items: torch.Tensor,
                   hist_valid: torch.Tensor, cfg: MINDConfig
                   ) -> torch.Tensor:
    """hist (B, L) -> interest capsules (B, K, D), L2-normalized (ref
    ``mind.py:48``)."""
    e = take_rows(params.item_emb, hist_items)                 # (B, L, D)
    eh = e @ params.s
    b_sz, seq_len, _ = e.shape
    k = cfg.n_interests
    dev = e.device
    pos = torch.arange(seq_len, dtype=torch.float32, device=dev)
    blogit = torch.sin(pos[:, None] * (1.0 + torch.arange(
        k, dtype=torch.float32, device=dev))[None, :])
    blogit = blogit.expand(b_sz, seq_len, k)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(hist_valid[..., None], blogit, -1e9),
                          dim=1)                               # over L
        caps = _squash(torch.einsum("blk,bld->bkd", w.to(cfg.dtype), eh))
        blogit = blogit + torch.einsum("bkd,bld->blk", caps, eh).float()
    norm = torch.linalg.vector_norm(caps, dim=-1, keepdim=True)
    return caps / torch.clamp(norm, min=1e-9)


@exact_matmuls()
def score_candidates(interests: torch.Tensor, item_embs: torch.Tensor
                     ) -> torch.Tensor:
    """Late interaction with n_q = K: ``max_k interest_k . item`` (ref
    ``mind.py:75``). interests (B, K, D); item_embs (N, D) -> (B, N)."""
    return torch.einsum("bkd,nd->bkn", interests, item_embs).amax(dim=1)


@exact_matmuls()
def forward(params: MIND, batch: dict, cfg: MINDConfig) -> torch.Tensor:
    """The label-aware attention score of the target item (ref
    ``mind.py:81``) -> (B,)."""
    caps = user_interests(params, batch["hist_items"], batch["hist_valid"],
                          cfg)
    tgt = take_rows(params.item_emb, batch["target_item"])
    att = torch.einsum("bkd,bd->bk", caps, tgt)
    w = torch.softmax(cfg.pow_label_aware * att.float(), dim=-1)
    v_user = torch.einsum("bk,bkd->bd", w.to(cfg.dtype), caps)
    return torch.einsum("bd,bd->b", v_user, tgt)


@exact_matmuls()
def loss_fn(params: MIND, batch: dict, cfg: MINDConfig) -> torch.Tensor:
    """In-batch softmax over the target items (ref ``mind.py:90``): a
    (B, K, B) product, each user's best interest against every target.
    The max over interests is ``amax``, whose gradient splits among ties as
    jax's does."""
    caps = user_interests(params, batch["hist_items"], batch["hist_valid"],
                          cfg)
    tgt = take_rows(params.item_emb, batch["target_item"])
    att = torch.einsum("bkd,jd->bkj", caps, tgt)
    scores = att.amax(dim=1).float()                           # (B, B)
    logp = torch.log_softmax(scores, dim=-1)
    return -torch.diagonal(logp).mean()
