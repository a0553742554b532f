"""Unfused phase 3: the centroid interaction S̄ (Eq. 2) of each query's
survivors.

Replaces ``repro/kernels/cinter.py::cinter`` (Pallas body
``_cinter_kernel``, :77, calling ``sbar_block``, :31), batched: row b equals
the reference kernel on query b. The CUDA kernel is ``csrc/cinter.cu``, which
launches the S̄ pass that the fused pqinter's pass 1 runs too
(``emvb::sbar_block``, ``csrc/doc_math.cuh``).
:func:`cinter_batched_ref` is its plain PyTorch version
(``core.interaction.centroid_interaction``).

:func:`cinter_batched` dispatches on the tensors' device: on the CPU it
runs the plain version; on CUDA it launches the kernel (and counts the launch
in ``launches``) or raises — it never falls back.

CS^T is float32 or bf16. On bf16, as in the reference, S̄ is the bf16 sum
(per-term bf16 maxima, ``term_sum`` in float32 rounded once to bf16),
written widened to float32 (``cinter.py:109``).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.interaction import centroid_interaction
from ..core.precision import CS_TYPES
from . import _build, _meta
from .prefilter import valid_first

launches = 0      # kernel launches since the last reset


def cinter_batched_ref(cs_t: torch.Tensor, codes: torch.Tensor,
                       lens: torch.Tensor, q_masks=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: S̄ (B, docs) float32."""
    valid = torch.arange(codes.shape[-1], device=codes.device) < lens[..., None]
    return centroid_interaction(cs_t, codes, valid, q_masks).float()


def _launch(cs_t, codes, lens, qm):
    """One launch of ``csrc/cinter.cu``; qm None means every term is
    live."""
    global launches
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("cinter", "cinter_batched", ctypes.c_int,
                         [vp, ci, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp])
    nb, nd, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    sbar = torch.empty((nb, nd), dtype=torch.float32, device=cs_t.device)
    p = _build.ptr
    err = fn(p(cs_t), _build.cs_flag(cs_t), p(codes), p(lens),
             p(qm), nb, nd, cap, n_c, n_q, p(sbar), _build.stream())
    _build.check(err, "cinter_batched")
    launches += 1
    return sbar


def cinter_batched(cs_t: torch.Tensor, codes: torch.Tensor,
                   token_mask: torch.Tensor, q_masks=None) -> torch.Tensor:
    """Batch-native centroid interaction.

    cs_t (B, n_c, n_q <= 32) float32 or bf16; codes (B, docs, cap) int32;
    token_mask (B, docs, cap) bool mask (any: ``prefilter.valid_first``)
    or (B, docs) int32 lengths; q_masks optional (B, n_q) bool.
    -> S̄ (B, docs) float32.
    """
    nb, nd, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    if n_q > 32:
        raise ValueError(f"cs_t {tuple(cs_t.shape)}: n_q must be <= 32 (one "
                         "lane per query term)")
    lens, codes = valid_first(token_mask, codes)
    if tuple(lens.shape) != (nb, nd):
        raise ValueError(f"token validity covers {tuple(lens.shape)}, "
                         f"expected {(nb, nd)}")
    if cs_t.is_meta:
        tokens = nb * nd * cap
        _meta.account("cinter", nb * nd * 4 + tokens * 4
                      + _meta.rows_touched(nb, n_c, tokens) * n_q
                      * cs_t.element_size() + nb * n_q + nb * nd * 4,
                      tokens * n_q)
        return _meta.empty((nb, nd), torch.float32)
    if cs_t.device.type == "cpu":
        return cinter_batched_ref(cs_t, codes, lens, q_masks)
    if cs_t.device.type != "cuda":
        raise ValueError(f"cinter: unsupported device {cs_t.device}")
    operands = [("cs_t", cs_t, CS_TYPES, (nb, n_c, n_q)),
                ("codes", codes, torch.int32, (nb, nd, cap)),
                ("token lengths", lens, torch.int32, (nb, nd))]
    if q_masks is not None:
        operands.append(("q_masks", q_masks, torch.bool, (nb, n_q)))
    _build.check_operands("cinter", cs_t.device, operands)
    return _launch(cs_t, codes, lens, q_masks)
