"""Fused phases 1b-2 (bit vectors, Eq. 4, top-n_filter) for a micro-batch.

Replaces ``repro/kernels/prefilter.py::prefilter_batched`` (Pallas body
``_prefilter_batched_kernel``, :106) and, at B = 1, ``prefilter``
(``_prefilter_kernel``, :62). The CUDA kernel is ``csrc/prefilter.cu``; its
source note says what bounds it on the H100 and how the design answers.
:func:`prefilter_batched_ref` is its plain PyTorch version.

Selection is ``lax.top_k(where(bitmap, F, -1), n_filter)`` exactly: scores
and doc ids pack into the unique int32 key ``(f + 1) << 25 | (2^25 - 1 -
id)``, so "higher f, then lower id" is integer order and any exact
selection over the keys is the reference's, tie order included. The kernel
ranks the selected keys by counting (F takes 34 values), so it takes any
``1 <= n_filter <= n_docs``, up to the keys' 2^25 docs.

Two operand forms, as in the reference: the corpus' codes shared by the
batch (score_all mode), with an optional predicate filter (``pred_words``
and the clauses of a compiled ``plan``, whose verdict is ANDed into the
bitmap inside the kernel), and per-query candidate codes (compact mode:
codes (B, cand_cap, cap), ids are buffer positions).

:func:`prefilter_batched` dispatches on the tensors' device: on the CPU it
runs the plain version; on CUDA it launches the kernel (and counts the launch
in ``launches``) or raises — it never falls back.

CS is float32 or bf16. The pack compares in the CS dtype against ``th``
rounded through float32 to it, as the reference's ``th_ref[0].astype(
cs.dtype)`` (``prefilter.py:76``, ``:118``); every pass after the pack sees
only words.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.bitvector import (apply_filter_plan, build_bitvectors,
                               or_reduce, popcount)
from ..core.precision import CS_TYPES, kernel_th, round_to
from ..core.topk import topk
from . import _build, _meta

ID_BITS = 25
MAX_ID = (1 << ID_BITS) - 1
MAX_BATCH = 32          # queries per launch: one lane group per query
REF_BLOCK_D = 1 << 17   # docs per step of the plain version

launches = 0            # kernel launches since the last reset


def valid_first(token_mask: torch.Tensor, *operands):
    """Token validity as lengths, and the per-token operands laid out so
    that each row's valid tokens come first. ``token_mask`` is (..., cap)
    bool or (...) int lengths; each operand has the mask's (..., cap) shape
    ahead of any trailing axes (codes (..., cap), res_codes (..., cap, m)).
    -> (int32 lengths, *operands).

    Lengths and prefix masks (real tokens first, what
    ``PackedIndex.token_mask()`` builds) return the operands as they are. A
    mask with holes moves each row's valid tokens, in their order, to the
    front, and its invalid ones after them: every per-doc reduction over
    tokens (Eq. 4's OR, S̄'s per-term max, Eq. 5/6's per-term max and Eq.
    6's kept max and count) is free of order, so the kernels' results are
    the reference's on the mask as given. Signed zeros are not covered: a
    max of -0.0 and 0.0 depends on the order in both packages."""
    if token_mask.dtype != torch.bool:
        return (token_mask.to(torch.int32), *operands)
    lens = token_mask.sum(-1, dtype=torch.int32)
    if token_mask.is_meta:       # no values to look at
        return (lens, *operands)
    cap = token_mask.shape[-1]
    slot = torch.arange(cap, device=token_mask.device)
    if torch.equal(slot < lens[..., None], token_mask):
        return (lens, *operands)
    # a valid token's slot is its rank among the row's valid tokens, an
    # invalid one's comes after all of them, in its rank among the invalid
    valid = token_mask.to(torch.int32)
    dest = torch.where(token_mask, valid.cumsum(-1) - 1,
                       lens[..., None] + (1 - valid).cumsum(-1) - 1).long()
    moved = []
    for x in operands:
        if tuple(x.shape[:token_mask.dim()]) != tuple(token_mask.shape):
            raise ValueError(f"token_mask {tuple(token_mask.shape)} does not "
                             f"lead operand {tuple(x.shape)}")
        d = dest.reshape(*dest.shape, *(1,) * (x.dim() - dest.dim()))
        moved.append(torch.empty_like(x).scatter_(
            dest.dim() - 1, d.expand_as(x), x))
    return (lens, *moved)


def filter_scores_ref(bits: torch.Tensor, codes: torch.Tensor,
                      doc_lens: torch.Tensor,
                      bitmap: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 4 for every (query, doc), -1 where the bitmap is False: bits
    (B, n_c) int32 words, shared codes (n_docs, cap) and doc_lens
    (n_docs,), or per-query codes (B, n_docs, cap) and doc_lens
    (B, n_docs); bitmap (B, n_docs) or None (every doc scored: the unfused
    ``bitfilter``'s plain version) -> F (B, n_docs) int32. Walks the
    documents in blocks of ``REF_BLOCK_D``, so no (B, n_docs, cap) tensor
    of words is made."""
    n_docs, cap = codes.shape[-2:]
    nb, n_c = bits.shape
    f = torch.empty((nb, n_docs), dtype=torch.int32, device=bits.device)
    tok = torch.arange(cap, device=bits.device)
    rows = torch.arange(nb, device=bits.device)[:, None, None]
    for s in range(0, n_docs, REF_BLOCK_D):
        e = min(s + REF_BLOCK_D, n_docs)
        idx = torch.clamp(codes[..., s:e, :], 0, n_c - 1).long()
        words = bits[rows, idx] if codes.dim() == 3 else bits[:, idx]
        valid = tok < doc_lens[..., s:e, None]
        if valid.dim() == 2:
            valid = valid[None]
        words = torch.where(valid, words, torch.zeros_like(words))
        f[:, s:e] = popcount(or_reduce(words, -1))
    if bitmap is None:
        return f
    return torch.where(bitmap, f, torch.full_like(f, -1))


def prefilter_batched_ref(cs: torch.Tensor, th: float, codes: torch.Tensor,
                          doc_lens: torch.Tensor, bitmap: torch.Tensor,
                          n_filter: int, q_masks=None, *, pred_words=None,
                          plan=None):
    """Plain PyTorch version of the kernel, built on ``core``: the bit
    words, the plan's verdict ANDed into the bitmap, Eq. 4 block by block
    (:func:`filter_scores_ref`), then one exact top-n_filter over the packed
    keys.
    -> (scores (B, n_filter) int32, doc_ids (B, n_filter) int32,
        bits (B, n_c) int32 words)"""
    bits = build_bitvectors(cs, kernel_th(th), q_masks)     # (B, n_c)
    if plan is not None:
        bitmap = bitmap & apply_filter_plan(plan, pred_words)
    f = filter_scores_ref(bits, codes, doc_lens, bitmap)
    ids = torch.arange(codes.shape[-2], device=cs.device, dtype=torch.int32)
    keys = ((f + 1) << ID_BITS) + (MAX_ID - ids)
    top, _ = topk(keys, n_filter)
    return ((top >> ID_BITS) - 1).to(torch.int32), \
        (MAX_ID - (top & MAX_ID)).to(torch.int32), bits


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "prefilter_scratch_bytes": (ctypes.c_size_t, [_CI, _CI, _CI, _CI]),
    "prefilter_batched": (_CI, [_VP, _CI, ctypes.c_float, _VP, _VP, _VP, _VP,
                                _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _VP,
                                _CI, _VP, _VP, _VP, _VP, _VP]),
}


def _fn(name: str):
    return _build.function("prefilter", name, *_SIGNATURES[name])


@functools.lru_cache(maxsize=64)
def clause_words(plan: tuple, device: torch.device) -> torch.Tensor:
    """A plan's clauses as the (n_clauses, 2) int32 tensor of (required,
    forbidden) words the kernel reads, on ``device``; made once per plan and
    device, so a call copies nothing to the card."""
    flat = [x - (1 << 32) if x >= 1 << 31 else x
            for clause in plan for x in clause]
    return torch.tensor(flat, dtype=torch.int32,
                        device=device).reshape(-1, 2)


def _launch(cs, th, codes, doc_lens, bitmap, n_filter, qm, pred, clauses):
    """One launch of ``csrc/prefilter.cu`` for B <= MAX_BATCH queries; qm
    None means every term is live, pred None that no plan is applied."""
    global launches
    nb, n_q, n_c = cs.shape
    n_docs, cap = codes.shape[-2:]
    per_query = int(codes.dim() == 3)
    dev = cs.device
    bits = torch.empty((nb, n_c), dtype=torch.int32, device=dev)
    out = torch.empty((2, nb, n_filter), dtype=torch.int32, device=dev)
    scratch = torch.empty(_fn("prefilter_scratch_bytes")(
        nb, n_c, n_docs, per_query), dtype=torch.uint8, device=dev)
    p = _build.ptr
    err = _fn("prefilter_batched")(
        p(cs), _build.cs_flag(cs), round_to(th, cs.dtype), p(qm),
        p(codes), p(doc_lens), p(bitmap), nb, n_q, n_c, n_docs, cap,
        n_filter, per_query, p(pred), p(clauses),
        0 if clauses is None else clauses.shape[0], p(bits), p(out[0]),
        p(out[1]), p(scratch), _build.stream())
    _build.check(err, "prefilter_batched")
    launches += 1
    return out[0], out[1], bits


def _meta_outputs(cs, lead, cap: int, n_filter: int, q_masks, plan):
    """The kernel's outputs on meta and its bound's bytes, dense (every doc
    some query's candidate, every token valid; ``kernels/_meta.py``)."""
    nb, n_q, n_c = cs.shape
    docs = lead[-1] * (nb if len(lead) == 2 else 1)
    tokens = docs * cap
    words = docs * 4 if plan is not None else 0
    _meta.account("prefilter",
                  _meta.nbytes(cs) + nb * lead[-1] + nb * n_q + words
                  + docs * 4 + tokens * 4 + nb * n_filter * 8 + nb * n_c * 4,
                  nb * n_q * n_c + nb * tokens)
    return (_meta.empty((nb, n_filter), torch.int32),
            _meta.empty((nb, n_filter), torch.int32),
            _meta.empty((nb, n_c), torch.int32))


def prefilter_batched(cs: torch.Tensor, th: float, codes: torch.Tensor,
                      token_mask: torch.Tensor, bitmap: torch.Tensor,
                      n_filter: int, q_masks=None, *, pred_words=None,
                      plan=None):
    """Batch-native fused phases 1b-2.

    cs (B, n_q <= 32, n_c) float32 or bf16; codes (n_docs, cap) int32 shared by the
    batch or (B, n_docs, cap) per query; token_mask the codes' shape in
    bool (any mask: :func:`valid_first`) or their leading shape in int32
    lengths; bitmap (B, n_docs) bool; q_masks optional (B, n_q) bool; plan optional
    ``FilterPlan.clauses`` (None reads no predicate word) over pred_words
    (n_docs,) uint32 or int32.
    -> (scores (B, n_filter) int32, doc_ids (B, n_filter) int32,
        bits (B, n_c) int32 holding the reference's uint32 words)
    """
    nb, n_q, n_c = cs.shape
    n_docs, cap = codes.shape[-2:]
    lead = (n_docs,) if codes.dim() == 2 else (nb, n_docs)
    if n_q > 32:
        raise ValueError("stacked bitvector packs one query term per bit")
    if codes.dim() not in (2, 3) or tuple(codes.shape[:-1]) != lead:
        raise ValueError(f"codes is {tuple(codes.shape)}: expected (n_docs, "
                         f"cap) or ({nb}, n_docs, cap)")
    if not 1 <= n_filter <= n_docs:
        raise ValueError(f"n_filter={n_filter} must be in [1, {n_docs}]")
    if n_docs > MAX_ID:
        raise ValueError("int32 packed keys support up to 2^25 docs/shard")
    if tuple(bitmap.shape) != (nb, n_docs):
        raise ValueError(f"bitmap is {tuple(bitmap.shape)}, expected "
                         f"{(nb, n_docs)}")
    doc_lens, codes = valid_first(token_mask, codes)
    if tuple(doc_lens.shape) != lead:
        raise ValueError(f"token validity covers {tuple(doc_lens.shape)}, "
                         f"expected {lead}")
    if plan is not None:
        if pred_words is None or tuple(pred_words.shape) != (n_docs,):
            raise ValueError(f"a plan needs pred_words of shape ({n_docs},)")
        pred_words = pred_words.view(torch.int32)
    if cs.is_meta:
        return _meta_outputs(cs, lead, cap, n_filter, q_masks, plan)
    if cs.device.type == "cpu":
        return prefilter_batched_ref(cs, th, codes, doc_lens, bitmap,
                                     n_filter, q_masks,
                                     pred_words=pred_words, plan=plan)
    if cs.device.type != "cuda":
        raise ValueError(f"prefilter: unsupported device {cs.device}")
    operands = [("cs", cs, CS_TYPES, (nb, n_q, n_c)),
                ("codes", codes, torch.int32, (*lead, cap)),
                ("token lengths", doc_lens, torch.int32, lead),
                ("bitmap", bitmap, torch.bool, (nb, n_docs))]
    if q_masks is not None:
        operands.append(("q_masks", q_masks, torch.bool, (nb, n_q)))
    clauses = None
    if plan is not None:
        clauses = clause_words(tuple(plan), cs.device)
        operands.append(("pred_words", pred_words, torch.int32, (n_docs,)))
    _build.check_operands("prefilter", cs.device, operands)
    per_q = codes.dim() == 3
    parts = []
    for s in range(0, nb, MAX_BATCH):
        parts.append(_launch(
            cs[s:s + MAX_BATCH], th,
            codes[s:s + MAX_BATCH] if per_q else codes,
            doc_lens[s:s + MAX_BATCH] if per_q else doc_lens,
            bitmap[s:s + MAX_BATCH], n_filter,
            None if q_masks is None else q_masks[s:s + MAX_BATCH],
            pred_words if plan is not None else None, clauses))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(x) for x in zip(*parts))
