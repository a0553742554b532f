"""Candidate generation's masked top-nprobe: each (query, term) row's
nprobe best centroids among the threshold's survivors.

Replaces no kernel of the reference, which selects with ``lax.top_k``
(``repro/core/bitvector.py:86``). The CUDA kernel is ``csrc/topnprobe.cu``;
its source note says what bounds it on the H100 and how the design answers.
:func:`masked_topk_ref` is its plain PyTorch version
(``core.bitvector.masked_topk_plain``), whose ids it equals bit for bit:
the same float32 ranking with non-survivors offset by ``-1e6``, XLA's total
order, lowest centroid first on ties.

:func:`masked_topk` dispatches on the tensors' device: on the CPU it runs
the plain version; on CUDA it launches the kernel (and counts the launch in
``launches``) or raises — it never falls back. ``core.bitvector.
masked_topk_centroids`` calls it for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.bitvector import masked_topk_plain
from ..core.precision import CS_TYPES, compare_dtype, round_to
from . import _build

launches = 0      # kernel launches since the last reset

# the plain version: the kernel's ids, bit for bit
masked_topk_ref = masked_topk_plain


def _launch(cs, th, nprobe, q_mask):
    """One launch of ``csrc/topnprobe.cu`` over the rows of ``cs``."""
    global launches
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("topnprobe", "topnprobe", ci,
                         [vp, ci, ctypes.c_float, vp, ci, ci, ci, vp, vp,
                          vp])
    scratch_bytes = _build.function("topnprobe", "topnprobe_scratch_bytes",
                                    ctypes.c_size_t, [ci, ci])
    n_c = cs.shape[-1]
    rows = cs.numel() // n_c
    ids = torch.empty((*cs.shape[:-1], nprobe), dtype=torch.int32,
                      device=cs.device)
    nbytes = scratch_bytes(rows, nprobe)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=cs.device)
               if nbytes else None)
    p = _build.ptr
    err = fn(p(cs), _build.cs_flag(cs),
             round_to(th, compare_dtype(cs.dtype, th)), p(q_mask), rows, n_c,
             nprobe, p(ids), p(scratch), _build.stream())
    _build.check(err, "topnprobe")
    launches += 1
    return ids


def masked_topk(cs: torch.Tensor, th, nprobe: int,
                q_mask=None) -> torch.Tensor:
    """Top-nprobe centroid ids of each row among the threshold's survivors.

    cs (..., n_q, n_c) float32 or bf16, contiguous; th compared in the
    reference's dtype (``precision.compare_dtype``); 0 <= nprobe <= n_c;
    q_mask optional (..., n_q) bool (a masked term's row is ``n_c`` in
    every slot). -> (..., n_q, nprobe) int32.
    """
    n_c = cs.shape[-1]
    if not 0 <= nprobe <= n_c:
        raise ValueError(f"topnprobe: nprobe={nprobe} outside [0, {n_c}], "
                         "the centroids a row holds")
    operands = [("cs", cs, CS_TYPES, tuple(cs.shape))]
    if q_mask is not None:
        operands.append(("q_mask", q_mask, torch.bool, tuple(cs.shape[:-1])))
    _build.check_operands("topnprobe", cs.device, operands)
    if cs.device.type == "cpu":
        return masked_topk_ref(cs, th, nprobe, q_mask)
    if cs.device.type != "cuda":
        raise ValueError(f"topnprobe: unsupported device {cs.device}")
    if nprobe == 0 or cs.numel() == 0:
        return torch.empty((*cs.shape[:-1], nprobe), dtype=torch.int32,
                           device=cs.device)
    return _launch(cs, th, nprobe, q_mask)
