"""Unfused phase 1b: the stacked bit vectors of a micro-batch.

Replaces ``repro/kernels/bitpack.py::bitpack`` (Pallas body
``_bitpack_kernel``, :22), batched: row b equals the reference kernel on
query b. The CUDA kernel is ``csrc/bitpack.cu``; its source note says what
bounds it on the H100 and how the design answers.
:func:`bitpack_batched_ref` is its plain PyTorch version
(``core.bitvector.build_bitvectors``).

Words come back as int32 tensors holding the reference's uint32 bits, as the
prefilter's ``bits`` output does (bit 31, term 31, reads as negative).

CS is float32 or bf16. The comparison is in float32 either way, as in the
reference kernel, whose threshold is a float32 array (``bitpack.py:26``):
a bf16 entry equal to bf16(th) packs bit 1 here where the fused prefilter
and ``build_bitvectors`` (bf16 comparisons) pack bit 0.

:func:`bitpack_batched` dispatches on the tensors' device: on the CPU it
runs the plain version; on CUDA it launches the kernel (and counts the launch
in ``launches``) or raises — it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.bitvector import build_bitvectors
from ..core.precision import CS_TYPES, kernel_th, round_to
from . import _build, _meta

launches = 0      # kernel launches since the last reset


def bitpack_batched_ref(cs: torch.Tensor, th: float,
                        q_masks=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, n_c) int32 words, the
    threshold a float32 scalar as the kernel's."""
    return build_bitvectors(cs, kernel_th(th, widen=True), q_masks)


def _launch(cs, th, qm):
    """One launch of ``csrc/bitpack.cu``; qm None means every term is
    live."""
    global launches
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("bitpack", "bitpack_batched", ctypes.c_int,
                         [vp, ci, ctypes.c_float, vp, ci, ci, ci, vp, vp])
    nb, n_q, n_c = cs.shape
    bits = torch.empty((nb, n_c), dtype=torch.int32, device=cs.device)
    p = _build.ptr
    err = fn(p(cs), _build.cs_flag(cs),
             round_to(th, torch.float32), p(qm), nb, n_q, n_c, p(bits),
             _build.stream())
    _build.check(err, "bitpack_batched")
    launches += 1
    return bits


def bitpack_batched(cs: torch.Tensor, th: float,
                    q_masks=None) -> torch.Tensor:
    """Batch-native bit pack.

    cs (B, n_q <= 32, n_c) float32 or bf16; th scalar (compared in
    float32); q_masks optional (B, n_q)
    bool (masked terms pack a 0 bit for every centroid).
    -> (B, n_c) int32 holding the reference's uint32 words.
    """
    nb, n_q, n_c = cs.shape
    if n_q > 32:
        raise ValueError("stacked bitvector packs one query term per bit")
    if cs.is_meta:
        _meta.account("bitpack", _meta.nbytes(cs) + nb * n_q + nb * n_c * 4,
                      nb * n_q * n_c)
        return _meta.empty((nb, n_c), torch.int32)
    if cs.device.type == "cpu":
        return bitpack_batched_ref(cs, th, q_masks)
    if cs.device.type != "cuda":
        raise ValueError(f"bitpack: unsupported device {cs.device}")
    operands = [("cs", cs, CS_TYPES, (nb, n_q, n_c))]
    if q_masks is not None:
        operands.append(("q_masks", q_masks, torch.bool, (nb, n_q)))
    _build.check_operands("bitpack", cs.device, operands)
    return _launch(cs, th, q_masks)
