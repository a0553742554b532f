"""EmbeddingBag as gather + masked sum (counterpart of
``repro/models/recsys/embedding_bag.py``), with the reference's layout:
per-field tables, multi-hot indices padded to ``nnz`` per (sample, field)
with a validity mask, reduction ``sum`` or ``mean``.

Rows are gathered by ``flat.take_rows``, whose backward sums each row's
gradients in one fixed order on the card and on the CPU, so a training
step gives the same bits every time it runs (a resumed run equals the
continuous one).

``embedding_bag_pq`` decodes rows stored as ``m`` uint8 PQ codes through
the codebooks at lookup time (the reference's beyond-paper option: EMVB's
PQ shrinking a table by ``dim * 4 / m``).
"""
from __future__ import annotations

import torch

from ..flat import MLP, take_rows


def _reduce(rows: torch.Tensor, valid: torch.Tensor, mode: str
            ) -> torch.Tensor:
    out = torch.where(valid[..., None], rows, 0.0).sum(dim=-2)
    if mode == "mean":
        out = out / torch.clamp(valid.sum(dim=-1, keepdim=True), min=1)
    return out


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """table (V, D); idx (..., nnz) int; valid (..., nnz) bool -> (..., D)
    (ref ``embedding_bag.py:18``). Indices outside [0, V) are clipped, as
    ``jnp.take``'s are."""
    rows = take_rows(table, torch.clamp(idx, 0, table.shape[0] - 1))
    return _reduce(rows, valid, mode)


def embedding_bag_pq(codes: torch.Tensor, codebooks: torch.Tensor,
                     idx: torch.Tensor, valid: torch.Tensor,
                     mode: str = "sum") -> torch.Tensor:
    """PQ-compressed lookup (ref ``embedding_bag.py:28``). codes (V, m)
    uint8; codebooks (m, K, dsub) -> (..., m * dsub)."""
    m, _, dsub = codebooks.shape
    row_codes = codes[torch.clamp(idx, 0, codes.shape[0] - 1).long()].long()
    rows = codebooks[torch.arange(m, device=codes.device), row_codes]
    rows = rows.reshape(*row_codes.shape[:-1], m * dsub)
    return _reduce(rows, valid, mode)


def mlp(layers: MLP, x: torch.Tensor, final_act: bool = False
        ) -> torch.Tensor:
    """x through ``layers`` (``x @ w + b``), ReLU between layers and after
    the last with ``final_act`` (ref ``embedding_bag.py:46``)."""
    for i, lp in enumerate(layers):
        x = x @ lp.w + lp.b
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_mlp(gen: torch.Generator, dims, dtype=torch.float32,
             device=None) -> MLP:
    """An :class:`~..flat.MLP` over ``dims``, ``w`` ~ N(0, 1/d_in) drawn
    from ``gen`` (a generator on ``device``) and ``b`` = 0 (ref
    ``embedding_bag.py:54``)."""
    return MLP(dims, dtype, device if device is not None else gen.device
               ).fill(gen)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """The reference's CTR loss: mean of ``max(l, 0) - l y + log1p(exp(-|l|))``
    in float32."""
    logits = logits.float()
    y = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
