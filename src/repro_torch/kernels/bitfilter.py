"""Unfused Eq. 4: the bit-vector filter score of every document for a
micro-batch of queries sharing one corpus.

Replaces ``repro/kernels/bitfilter.py::bitfilter`` (Pallas body
``_bitfilter_kernel``, :33), batched: row b equals the reference kernel on
query b's words. The CUDA kernel is ``csrc/bitfilter.cu``; its source note
says what bounds it on the H100 and how the design answers: a pass that
transposes the word table and marks its lit rows (those with a bit set) in
an occupancy bitmap, a zero fill of F, then a persistent score pass that
reads every doc's codes, gathers only the rows of its lit tokens and
writes a query's F for a group of 32 docs only where one is nonzero. The
bitmap (n_c bits) sits in each score block's shared memory while it fits
beside the warps' buffers (on the H100: n_c <= 319,488 at B = 32,
1,368,064 at B = 1); above that the same test reads it from global memory.
Either way F is the same. :func:`bitfilter_batched_ref` is its plain
PyTorch version: the blocked Eq. 4 the prefilter's plain version runs
(``prefilter.filter_scores_ref``), without the bitmap.

Unlike the prefilter, nothing is masked: every doc is scored, and the
engine applies the candidate bitmap after (``where(bitmap, F, -1)``), as the
reference's unfused phase 2 does.

Compact mode hands it per-query candidate codes (B, cand_cap, cap) with
lengths (B, cand_cap): row b of F is the reference kernel on query b's words
and query b's buffer, computed by the pass ``bitfilter_query_kernel`` (a
warp per (query, slot)).

:func:`bitfilter_batched` dispatches on the tensors' device: on the CPU it
runs the plain version; on CUDA it launches the kernel (and counts the launch
in ``launches``) or raises — it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _meta
from .prefilter import filter_scores_ref, valid_first

MAX_BATCH = 32    # queries per launch: one lane group per query

launches = 0      # kernel launches since the last reset


def bitfilter_batched_ref(bits: torch.Tensor, codes: torch.Tensor,
                          doc_lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, both forms: F (B, n_docs)
    int32."""
    return filter_scores_ref(bits, codes, doc_lens)


def _launch_query(bits, codes, lens):
    """One launch of the compact-mode pass of ``csrc/bitfilter.cu``."""
    global launches
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("bitfilter", "bitfilter_query", ctypes.c_int,
                         [vp, vp, vp, ci, ci, ci, ci, vp, vp])
    nb, n_docs, cap = codes.shape
    f = torch.empty((nb, n_docs), dtype=torch.int32, device=bits.device)
    p = _build.ptr
    err = fn(p(bits), p(codes), p(lens), nb, bits.shape[1], n_docs, cap,
             p(f), _build.stream())
    _build.check(err, "bitfilter_query")
    launches += 1
    return f


def _launch(bits, codes, doc_lens):
    """One launch of ``csrc/bitfilter.cu`` for B <= MAX_BATCH queries."""
    global launches
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("bitfilter", "bitfilter_batched", ctypes.c_int,
                         [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp])
    scratch_bytes = _build.function("bitfilter", "bitfilter_scratch_bytes",
                                    ctypes.c_size_t, [ci, ci])
    nb, n_c = bits.shape
    n_docs, cap = codes.shape
    dev = bits.device
    scratch = torch.empty(scratch_bytes(nb, n_c), dtype=torch.uint8,
                          device=dev)
    f = torch.empty((nb, n_docs), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = fn(p(bits), p(codes), p(doc_lens), nb, n_c, n_docs, cap, p(scratch),
             p(f), _build.stream())
    _build.check(err, "bitfilter_batched")
    launches += 1
    return f


def _meta_outputs(bits, lead, cap: int):
    """F on meta and the bound's bytes, dense (every token valid;
    ``kernels/_meta.py``)."""
    nb, n_c = bits.shape
    docs = lead[-1] * (nb if len(lead) == 2 else 1)
    tokens = docs * cap
    rows = n_c * nb if len(lead) == 1 else _meta.rows_touched(nb, n_c,
                                                              tokens)
    _meta.account("bitfilter", docs * 4 + tokens * 4 + rows * 4
                  + nb * lead[-1] * 4, nb * lead[-1] * cap)
    return _meta.empty((nb, lead[-1]), torch.int32)


def bitfilter_batched(bits: torch.Tensor, codes: torch.Tensor,
                      token_mask: torch.Tensor) -> torch.Tensor:
    """Batch-native Eq. 4 over shared corpus codes or per-query buffers.

    bits (B, n_c) int32 words (masked terms already 0 bits); codes
    (n_docs, cap) int32 shared by the batch or (B, n_docs, cap) per query;
    token_mask the codes' shape in bool (any mask:
    ``prefilter.valid_first``) or their leading shape in int32 lengths.
    -> F (B, n_docs) int32.
    """
    nb, n_c = bits.shape
    n_docs, cap = codes.shape[-2:]
    lead = (n_docs,) if codes.dim() == 2 else (nb, n_docs)
    if codes.dim() not in (2, 3) or tuple(codes.shape[:-1]) != lead:
        raise ValueError(f"codes is {tuple(codes.shape)}: expected (n_docs, "
                         f"cap) or ({nb}, n_docs, cap)")
    doc_lens, codes = valid_first(token_mask, codes)
    if tuple(doc_lens.shape) != lead:
        raise ValueError(f"token validity covers {tuple(doc_lens.shape)}, "
                         f"expected {lead}")
    if bits.is_meta:
        return _meta_outputs(bits, lead, cap)
    if bits.device.type == "cpu":
        return bitfilter_batched_ref(bits, codes, doc_lens)
    if bits.device.type != "cuda":
        raise ValueError(f"bitfilter: unsupported device {bits.device}")
    _build.check_operands("bitfilter", bits.device, (
        ("bits", bits, torch.int32, (nb, n_c)),
        ("codes", codes, torch.int32, (*lead, cap)),
        ("token lengths", doc_lens, torch.int32, lead)))
    if codes.dim() == 3:
        return _launch_query(bits, codes, doc_lens)
    parts = [_launch(bits[s:s + MAX_BATCH], codes, doc_lens)
             for s in range(0, nb, MAX_BATCH)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)
