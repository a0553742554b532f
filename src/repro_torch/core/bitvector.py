"""Stacked bit-vector pre-filter, paper §4.2 (counterpart of
``repro/core/bitvector.py``).

Bit i of a centroid's word says "centroid is close to query term i"; a
passage's filter score is ``F(P, q) = popcount(OR_{j in P} word[code_j])``
(paper Eq. 4). torch has no popcount and, on the CPU, no shift, compare or
max on ``uint32``, so words live in int32 tensors holding the same 32 bits
(a word with bit 31 set reads as negative) and :func:`popcount` is written
out.
"""
from __future__ import annotations

from typing import Optional

import torch

from .topk import topk


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each 32-bit word (int32 or int64 holding
    32 bits) -> int32."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def build_bitvectors(cs: torch.Tensor, th: float,
                     q_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack per-term threshold masks into stacked bit vectors (ref ``:38``).

    cs (..., n_q, n_c) with n_q <= 32; q_mask optional (..., n_q) bool —
    masked terms pack a 0 bit for every centroid.
    -> (..., n_c) int32 words; bit i of word c == (cs[..., i, c] > th).
    The comparison runs in the CS dtype, as in the reference.
    """
    n_q = cs.shape[-2]
    assert n_q <= 32, "stacked bitvector packs one query term per bit"
    mask = cs > th
    if q_mask is not None:
        mask = mask & q_mask[..., :, None]
    shifts = torch.arange(n_q, device=cs.device, dtype=torch.int64)
    words = (mask.to(torch.int64) << shifts[:, None]).sum(-2)
    return to_int32_bits(words)


def or_reduce(words: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Bitwise-OR reduction along ``dim``."""
    words = words.movedim(dim, 0)
    out = torch.zeros_like(words[0])
    for w in words:
        out |= w
    return out


def filter_score(bits: torch.Tensor, codes: torch.Tensor,
                 token_mask: torch.Tensor) -> torch.Tensor:
    """Eq. 4 for a batch of passages (ref ``:65``).

    bits (n_c,) int32 words of ONE query; codes (n_docs, cap) int32;
    token_mask (n_docs, cap) bool -> (n_docs,) int32 F(P, q).
    """
    words = bits[torch.clamp(codes, 0, bits.shape[0] - 1).long()]
    words = torch.where(token_mask, words, torch.zeros_like(words))
    return popcount(or_reduce(words, -1))


def masked_topk_centroids(cs: torch.Tensor, th: float, nprobe: int,
                          q_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Top-nprobe centroid ids per query term among the threshold's
    survivors (ref ``:86``): ranks in float32 with non-survivors offset by
    ``-1e6``, and masked terms return the one-past-end sentinel ``n_c``.
    cs (..., n_q, n_c) -> (..., n_q, nprobe) int32."""
    cs32 = cs.to(torch.float32)
    masked = torch.where(cs > th, cs32, cs32 - 1e6)
    _, idx = topk(masked, nprobe)
    idx = idx.to(torch.int32)
    if q_mask is not None:
        idx = torch.where(q_mask[..., :, None], idx,
                          torch.full_like(idx, cs.shape[-1]))
    return idx
