"""ColBERT-style multi-vector encoder (counterpart of
``repro/models/colbert.py``): the model side of the paper's system
(ColBERTv2 produces the embeddings EMVB indexes; paper §5).

A bidirectional transformer over token ids, projected to ``out_proj`` dims
and L2-normalized: one vector per token. Trained with an in-batch
contrastive MaxSim loss; with ``pq_codebooks`` the document embeddings go
through straight-through PQ (:func:`repro_torch.core.pq.pq_ste`), JMPQ's
"joint optimization of PQ with the fine-tuning" (Fang et al. 2022).

Precision: the encoder's products run with TF32 off and no
reduced-precision bf16 reductions (:func:`~repro_torch.core.precision.
exact_matmuls`), whatever the process' flags are.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.kmeans import Seed
from ..core.pq import PQCodebooks, pq_ste
from ..core.precision import exact_matmuls
from .layers import ModelConfig
from .transformer import Transformer, fill_params, forward_hidden


def make_config(*, n_layers=4, d_model=256, n_heads=4, d_head=64, d_ff=512,
                vocab=30522, out_dim=128, dtype=torch.float32
                ) -> ModelConfig:
    """The reference's encoder config (``colbert.py:21``): bidirectional,
    as many KV heads as heads, projected to ``out_dim``."""
    return ModelConfig(name="colbert", n_layers=n_layers, d_model=d_model,
                       n_heads=n_heads, n_kv_heads=n_heads, d_head=d_head,
                       d_ff=d_ff, vocab=vocab, causal=False,
                       out_proj=out_dim, dtype=dtype)


class ColBERT(Transformer):
    """The encoder's parameters, on ``resolve_device(device)``, drawn from
    ``seed`` (``transformer.fill_params``; ``None`` leaves them unset, for
    a caller that loads weights); ``cfg`` defaults to :func:`make_config`.
    Calling it encodes (:func:`encode`)."""

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 seed: Optional[Seed] = 0, device=None):
        super().__init__(cfg if cfg is not None else make_config(), device)
        if seed is not None:
            fill_params(self, seed)

    def forward(self, tokens: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
        """tokens/valid (B, S) -> (B, S, out_dim) (:func:`encode`)."""
        return encode(self, tokens, valid, self.cfg)


def init_params(seed: Seed, cfg: ModelConfig, device=None) -> ColBERT:
    """A :class:`ColBERT` with weights drawn from ``seed`` (ref
    ``colbert.py:29``)."""
    return ColBERT(cfg, seed, device)


@exact_matmuls()
def encode(params: Transformer, tokens: torch.Tensor, valid: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """tokens/valid (B, S) -> per-token embeddings (B, S, out_dim), zeroed
    at padding, L2-normalized elsewhere (ref ``colbert.py:33``). Attention
    is bidirectional among the valid tokens; a padding row attends
    uniformly (``gqa_attention``'s -1e30) and is zeroed here."""
    attn_mask = (valid[:, None, :] & valid[:, :, None])[:, None, None, :, :]
    h, _ = forward_hidden(params, tokens, cfg, attn_mask=attn_mask,
                          remat=False)
    e = h @ params.proj
    e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=1e-9)
    return torch.where(valid[..., None], e, 0.0)


def maxsim_scores(qe: torch.Tensor, qv: torch.Tensor, de: torch.Tensor,
                  dv: torch.Tensor) -> torch.Tensor:
    """In-batch late-interaction scores (ref ``colbert.py:46``): qe (B, Sq,
    d) queries, de (B, Sd, d) docs -> (B, B). The max over doc tokens is
    ``amax``, whose gradient splits among ties as jax's does."""
    sim = torch.einsum("iqd,jtd->ijqt", qe, de)
    sim = torch.where(dv[None, :, None, :], sim, -1e9)
    best = torch.amax(sim, dim=-1)                       # (B, B, Sq)
    best = torch.where(qv[:, None, :], best, 0.0)
    return best.sum(dim=-1)


def contrastive_loss(params: Transformer, batch: dict, cfg: ModelConfig,
                     pq_codebooks: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """In-batch softmax over MaxSim scores, the diagonal the positives (ref
    ``colbert.py:58``). ``batch``: ``q_tokens``/``q_valid`` (B, Sq),
    ``d_tokens``/``d_valid`` (B, Sd). With ``pq_codebooks`` (m, K, dsub)
    the document embeddings are quantized straight-through (JMPQ)."""
    with exact_matmuls():
        qe = encode(params, batch["q_tokens"], batch["q_valid"], cfg)
        de = encode(params, batch["d_tokens"], batch["d_valid"], cfg)
        if pq_codebooks is not None:
            b, s, d = de.shape
            de = pq_ste(de.reshape(-1, d), PQCodebooks(pq_codebooks)
                        ).reshape(b, s, d)
        scores = maxsim_scores(qe, batch["q_valid"], de, batch["d_valid"])
    labels = torch.arange(scores.shape[0], device=scores.device)
    logp = torch.log_softmax(scores.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None]).mean()
