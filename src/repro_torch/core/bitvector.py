"""Stacked bit-vector pre-filter, paper §4.2 (counterpart of
``repro/core/bitvector.py``).

Bit i of a centroid's word says "centroid is close to query term i"; a
passage's filter score is ``F(P, q) = popcount(OR_{j in P} word[code_j])``
(paper Eq. 4). torch has no popcount and, on the CPU, no shift, compare or
max on ``uint32``, so words live in int32 tensors holding the same 32 bits
(a word with bit 31 set reads as negative) and :func:`popcount` is written
out.

The same word layout holds per-document metadata: :class:`PredicateSet`
packs up to 32 named predicates into one uint32 word per document, and a
:class:`FilterExpr` compiles through :func:`compile_filter` into a
:class:`FilterPlan` of ``(required, forbidden)`` clause pairs that
:func:`apply_filter_plan` and the prefilter kernel evaluate the same way
(docs/FILTERING.md).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch

from .precision import compare_dtype, greater, round_to
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
    The comparison runs in the reference's dtype (``precision.greater``):
    on bf16 CS, bf16 against a Python number, float32 against a numpy
    scalar.
    """
    n_q = cs.shape[-2]
    assert n_q <= 32, "stacked bitvector packs one query term per bit"
    mask = greater(cs, th)
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


def filter_score_batch(bits: torch.Tensor, codes: torch.Tensor,
                       token_mask: torch.Tensor) -> torch.Tensor:
    """Eq. 4 batched over queries (ref ``:80``): bits (B, n_c) int32 words,
    codes and token_mask (n_docs, cap) shared -> (B, n_docs) int32."""
    return torch.stack([filter_score(b, codes, token_mask) for b in bits])


def masked_topk_centroids(cs: torch.Tensor, th: float, nprobe: int,
                          q_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Top-nprobe centroid ids per query term among the threshold's
    survivors (ref ``:86``): ranks in float32 with non-survivors offset by
    ``-1e6``, and masked terms return the one-past-end sentinel ``n_c``.
    The threshold test runs in the reference's dtype (``precision.greater``:
    bf16 on bf16 CS against a Python number).
    cs (..., n_q, n_c) -> (..., n_q, nprobe) int32. A CUDA tensor goes to
    the kernel of ``kernels/topnprobe.py``, which gives the same ids; any
    other to :func:`masked_topk_plain`."""
    if cs.device.type == "cuda":
        from ..kernels import topnprobe   # kernels/ imports this module
        return topnprobe.masked_topk(cs, th, nprobe, q_mask)
    return masked_topk_plain(cs, th, nprobe, q_mask)


def masked_topk_plain(cs: torch.Tensor, th: float, nprobe: int,
                      q_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """:func:`masked_topk_centroids` in plain PyTorch on any device: the
    lax.top_k selection of ``core/topk.py`` over the masked float32
    scores."""
    cs32 = cs.to(torch.float32)
    keep = cs32 > round_to(th, compare_dtype(cs.dtype, th))
    masked = torch.where(keep, cs32, cs32 - 1e6)
    _, idx = topk(masked, nprobe)
    idx = idx.to(torch.int32)
    if q_mask is not None:
        idx = torch.where(q_mask[..., :, None], idx,
                          torch.full_like(idx, cs.shape[-1]))
    return idx


# ---------------------------------------------------------------------------
# Predicate planes (ref ``:125-330``): the same word layout, one uint32 word
# per document, bit i = "predicate names[i] holds". Compiled filters are
# static DNF clauses of (required, forbidden) masks over that word.
# ---------------------------------------------------------------------------

MAX_PREDICATES = 32  # one uint32 word per document


def _signed(mask: int) -> int:
    """A uint32 mask as the int32 with the same bits."""
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) words as int32 holding the same bits: torch has no
    ``&`` or ``==`` for uint32 on the CPU."""
    if words.dtype == torch.uint32:
        return words.view(torch.int32)
    return words.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PredicateSet:
    """Named boolean per-document predicates packed one bit per name (ref
    ``:133``): ``words[d]`` (uint32) has bit ``i`` set iff ``names[i]``
    holds for document ``d``."""

    names: tuple[str, ...]
    words: torch.Tensor  # (n_docs,) uint32

    @classmethod
    def pack(cls, predicates: Mapping[str, np.ndarray]) -> "PredicateSet":
        """Pack ``{name: (n_docs,) bool array}`` into one word per doc; the
        mapping's order fixes the bit positions."""
        names = tuple(predicates)
        if not names:
            raise ValueError(
                "PredicateSet.pack got an empty mapping: pass at least one "
                "named predicate, or use predicates=None for no plane")
        if len(names) > MAX_PREDICATES:
            raise ValueError(
                f"{len(names)} predicates > {MAX_PREDICATES}: the plane "
                "packs one bit per predicate into a uint32 word")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate predicate names in {names}")
        words = None
        for i, name in enumerate(names):
            col = np.asarray(predicates[name])
            if col.ndim != 1:
                raise ValueError(
                    f"predicate {name!r} has shape {col.shape}: expected a "
                    "1-D (n_docs,) boolean array")
            if words is None:
                words = np.zeros(col.shape[0], np.uint32)
            elif col.shape[0] != words.shape[0]:
                raise ValueError(
                    f"predicate {name!r} has {col.shape[0]} docs but "
                    f"{names[0]!r} has {words.shape[0]}: all predicates "
                    "must cover the same corpus")
            words |= col.astype(bool).astype(np.uint32) << np.uint32(i)
        return cls(names, torch.from_numpy(words))

    def mask(self, name: str) -> torch.Tensor:
        """Unpack one named predicate back to a (n_docs,) bool tensor."""
        try:
            i = self.names.index(name)
        except ValueError:
            raise ValueError(
                f"unknown predicate {name!r}: this set has {self.names}"
            ) from None
        return ((_as_int32_words(self.words) >> i) & 1) != 0


class FilterExpr:
    """Base of the AND/OR/NOT expression tree over predicate names (ref
    ``:185``): compose with ``&``, ``|`` and ``~``, then compile against an
    index's ``meta.pred_names`` with :func:`compile_filter`. Frozen and
    hashable."""

    def __and__(self, other: "FilterExpr") -> "And":
        return And(self, other)

    def __or__(self, other: "FilterExpr") -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class Pred(FilterExpr):
    """Leaf: the named predicate must hold."""

    name: str


@dataclasses.dataclass(frozen=True)
class And(FilterExpr):
    """Both sub-expressions must hold."""

    lhs: FilterExpr
    rhs: FilterExpr


@dataclasses.dataclass(frozen=True)
class Or(FilterExpr):
    """At least one sub-expression must hold."""

    lhs: FilterExpr
    rhs: FilterExpr


@dataclasses.dataclass(frozen=True)
class Not(FilterExpr):
    """The sub-expression must NOT hold."""

    operand: FilterExpr


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    """A compiled filter (ref ``:242``): ``clauses`` is a tuple of
    ``(required, forbidden)`` uint32 mask pairs; a document with word ``w``
    passes iff ANY clause has ``(w & required) == required and (w &
    forbidden) == 0``. An empty tuple passes nothing, the clause ``(0, 0)``
    everything. ``names`` is the pred_names order it was compiled
    against."""

    names: tuple[str, ...]
    clauses: tuple[tuple[int, int], ...]


def _dnf(expr: FilterExpr, bit_of: dict, negate: bool
         ) -> list[tuple[int, int]]:
    """Push negations to the leaves and expand to (required, forbidden)
    clause pairs; a clause that requires and forbids one bit is dropped."""
    if isinstance(expr, Pred):
        if expr.name not in bit_of:
            raise ValueError(
                f"filter references unknown predicate {expr.name!r}: this "
                f"index has {tuple(bit_of) or '(no predicate plane)'}")
        bit = 1 << bit_of[expr.name]
        return [(0, bit)] if negate else [(bit, 0)]
    if isinstance(expr, Not):
        return _dnf(expr.operand, bit_of, not negate)
    if not isinstance(expr, (And, Or)):
        raise TypeError(
            f"expected a FilterExpr (Pred/And/Or/Not), got "
            f"{type(expr).__name__}")
    lhs = _dnf(expr.lhs, bit_of, negate)
    rhs = _dnf(expr.rhs, bit_of, negate)
    conjunction = isinstance(expr, And) != negate  # De Morgan under negate
    if not conjunction:
        return lhs + rhs
    out = []
    for p1, n1 in lhs:
        for p2, n2 in rhs:
            pos, neg = p1 | p2, n1 | n2
            if pos & neg:
                continue
            out.append((pos, neg))
    return out


def compile_filter(expr: FilterExpr,
                   names: tuple[str, ...]) -> FilterPlan:
    """Compile a :class:`FilterExpr` against the index's predicate order
    ``names`` (``meta.pred_names``) into a :class:`FilterPlan` (ref
    ``:295``): DNF clauses in the reference's order, duplicates dropped."""
    names = tuple(names)
    if len(names) > MAX_PREDICATES:
        raise ValueError(f"{len(names)} predicate names > {MAX_PREDICATES}")
    bit_of = {n: i for i, n in enumerate(names)}
    if len(bit_of) != len(names):
        raise ValueError(f"duplicate predicate names in {names}")
    clauses, seen = [], set()
    for c in _dnf(expr, bit_of, False):
        if c not in seen:
            seen.add(c)
            clauses.append(c)
    return FilterPlan(names=names, clauses=tuple(clauses))


def apply_filter_plan(plan: Union[FilterPlan, tuple],
                      words: torch.Tensor) -> torch.Tensor:
    """Evaluate a compiled plan (or its raw ``clauses``) on predicate words
    (...,) uint32 or int32 -> (...,) bool, True where the document passes
    (ref ``:315``). The words are compared as int32 holding the same bits."""
    clauses = plan.clauses if isinstance(plan, FilterPlan) else tuple(plan)
    w = _as_int32_words(words)
    ok = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    for pos, neg in clauses:
        c = torch.ones(w.shape, dtype=torch.bool, device=w.device)
        if pos:
            c = c & ((w & _signed(pos)) == _signed(pos))
        if neg:
            c = c & ((w & _signed(neg)) == 0)
        ok = ok | c
    return ok
