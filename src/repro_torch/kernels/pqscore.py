"""Unfused phase 4: the PQ late-interaction scores (Eq. 5, or Eq. 6 with the
dynamic term filter) of each query's phase-3 winners.

Replaces ``repro/kernels/pqscore.py::pqscore`` (Pallas body
``_pqscore_kernel``, :116, calling ``eq56_block``, :33), batched: row b
equals the reference kernel on query b. The CUDA kernel is
``csrc/pqscore.cu``: the fused pqinter's Eq. 5/6 pass (the cluster pass
of ``csrc/doc_math.cuh``, each query's LUT held in the shared memory of a
thread-block cluster, in ``pqinter.flat_lut``'s layout) on the rows it is
given, m = 16 compiled in and any other m serial; :func:`plan` reports how
a launch runs it. :func:`pqscore_batched_ref` is its plain
PyTorch version (``core.interaction.late_interaction_pq``). The residual
codes stay uint8 in memory (the reference widens them to int32, :139).

:func:`pqscore_batched` dispatches on the tensors' device: on the CPU it
runs the plain version; on CUDA it launches the kernel (and counts the launch
in ``launches``) or raises — it never falls back.

CS^T is float32 or bf16; the LUT is float32. On bf16, as in the reference's
``eq56_block`` (``pqscore.py:52-62``), a token's full score is the widened
bf16 centroid score plus the float32 residual, and Eq. 6 compares the
centroid score with ``th_r`` rounded through float32 to bf16.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.interaction import late_interaction_pq
from ..core.precision import CS_TYPES, kernel_th, round_to
from . import _build, _meta
from .pqinter import eq56_plan, flat_lut, lut_rows, lut_terms
from .prefilter import valid_first

launches = 0      # kernel launches since the last reset


def pqscore_batched_ref(cs_t: torch.Tensor, lut: torch.Tensor,
                        codes: torch.Tensor, res_codes: torch.Tensor,
                        lens: torch.Tensor, th_r, q_masks=None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: scores (B, docs) float32; the
    kernel's ``th_r`` is a float32 value (``kernel_th``)."""
    valid = torch.arange(codes.shape[-1], device=codes.device) < lens[..., None]
    return late_interaction_pq(cs_t, lut, codes, res_codes, valid,
                               kernel_th(th_r), q_mask=q_masks)


def plan(cs_t, codes, res_codes, n_q: int, m: int, ksub: int,
         runs: int = 0) -> dict:
    """How a launch on these CUDA operands runs the Eq. 5/6 pass
    (``pqinter.eq56_plan``); ``runs`` > 0 overrides the schedule's runs a
    query."""
    return eq56_plan("pqscore", "pqscore_plan", cs_t, res_codes,
                     codes.shape[1], n_q, m, ksub, runs)


def _launch(cs_t, lut2, terms, codes, res_codes, lens, qm, th_r, m, ksub,
            runs=0):
    """One launch of ``csrc/pqscore.cu`` on lut2, the LUT in flat_lut's
    layout of ``terms``; qm None means every term is live."""
    global launches
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("pqscore", "pqscore_batched", ctypes.c_int,
                         [vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                          ci, ci, ctypes.c_float, ci, ci, vp, vp])
    nb, nd, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    score = torch.empty((nb, nd), dtype=torch.float32, device=cs_t.device)
    p = _build.ptr
    err = fn(p(cs_t), _build.cs_flag(cs_t), p(lut2), terms, p(codes),
             p(res_codes), p(lens), p(qm), nb, nd, cap, n_c, n_q, m, ksub,
             0.0 if th_r is None else round_to(th_r, cs_t.dtype),
             int(th_r is not None), runs, p(score), _build.stream())
    _build.check(err, "pqscore_batched")
    launches += 1
    return score


def pqscore_batched(cs_t: torch.Tensor, lut: torch.Tensor,
                    codes: torch.Tensor, res_codes: torch.Tensor,
                    token_mask: torch.Tensor, th_r,
                    q_masks=None) -> torch.Tensor:
    """Batch-native Eq. 5/6 scores.

    cs_t (B, n_c, n_q <= 32) float32 or bf16; lut (B, n_q, m, K) float32; codes
    (B, docs, cap) int32; res_codes (B, docs, cap, m) uint8; token_mask
    (B, docs, cap) bool mask (any: ``prefilter.valid_first``) or (B, docs)
    int32 lengths; th_r None (Eq. 5) or a float (Eq. 6); q_masks optional
    (B, n_q) bool.
    -> scores (B, docs) float32.
    """
    nb, nd, cap = codes.shape
    n_q, m, ksub = lut.shape[1:]
    if cs_t.shape[-1] != n_q or n_q > 32:
        raise ValueError(f"cs_t {tuple(cs_t.shape)} and lut "
                         f"{tuple(lut.shape)} disagree on n_q (<= 32)")
    lens, codes, res_codes = valid_first(token_mask, codes,
                                         res_codes)
    if tuple(lens.shape) != (nb, nd):
        raise ValueError(f"token validity covers {tuple(lens.shape)}, "
                         f"expected {(nb, nd)}")
    if cs_t.is_meta:
        tokens, n_c = nb * nd * cap, cs_t.shape[1]
        _meta.account("pqscore", nb * nd * 4 + tokens * (4 + m)
                      + _meta.rows_touched(nb, n_c, tokens) * n_q
                      * cs_t.element_size() + _meta.nbytes(lut) + nb * n_q
                      + nb * nd * 4, tokens * n_q * (m + 1))
        return _meta.empty((nb, nd), torch.float32)
    if cs_t.device.type == "cpu":
        return pqscore_batched_ref(cs_t, lut, codes, res_codes, lens, th_r,
                                   q_masks)
    if cs_t.device.type != "cuda":
        raise ValueError(f"pqscore: unsupported device {cs_t.device}")
    terms = lut_terms("pqscore", n_q, m, ksub)
    lut2 = flat_lut(lut, terms)
    n_c = cs_t.shape[1]
    operands = [("cs_t", cs_t, CS_TYPES, (nb, n_c, n_q)),
                ("lut", lut2, torch.float32, (nb, -(-n_q // terms),
                                              lut_rows(m * ksub, terms),
                                              terms)),
                ("codes", codes, torch.int32, (nb, nd, cap)),
                ("res_codes", res_codes, torch.uint8, (nb, nd, cap, m)),
                ("token lengths", lens, torch.int32, (nb, nd))]
    if q_masks is not None:
        operands.append(("q_masks", q_masks, torch.bool, (nb, n_q)))
    _build.check_operands("pqscore", cs_t.device, operands)
    return _launch(cs_t, lut2, terms, codes, res_codes, lens, q_masks, th_r,
                   m, ksub)
