"""Centroid-score (CS) dtypes and the reference's threshold comparisons.

The reference compares a CS entry with a threshold under jax's type
promotion. A Python number is weakly typed and takes the CS dtype, so on
bf16 CS the threshold is rounded to bf16 (through float32, as jax converts
it) and the comparison is in bf16. A numpy scalar or a float32 array keeps
float32, and the bf16 entries are widened to it. torch promotes otherwise (a
bf16 tensor against a numpy scalar or a 0-dim float32 tensor compares in
bf16), so every threshold site of the port states its comparison dtype
through :func:`greater`, and the kernels get the threshold rounded once on
the host to the value they compare against (:func:`round_to`).

The port's products state their matmul precision with
:func:`exact_matmuls`, which sets torch's process-wide flags only while they
run and puts the caller's values back afterwards.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

CS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CS_TYPES = tuple(CS_DTYPES.values())   # what the kernels take as CS


def round_to(th, dtype: torch.dtype) -> float:
    """``th`` as the ``dtype`` value a comparison in that dtype uses:
    float32, or bf16 rounded from the float32 value."""
    return float(torch.tensor(float(np.float32(th))).to(dtype))


def compare_dtype(x_dtype: torch.dtype, th) -> torch.dtype:
    """The dtype the reference compares ``x > th`` in: float32 for float32
    ``x``; for bf16 ``x``, bf16 against a Python number (weakly typed),
    float32 against anything else (a numpy scalar, a float32 array)."""
    if x_dtype != torch.bfloat16:
        return torch.float32
    if isinstance(th, (int, float)) and not isinstance(th, np.generic):
        return torch.bfloat16
    return torch.float32


def greater(x: torch.Tensor, th) -> torch.Tensor:
    """``x > th`` in the reference's comparison dtype
    (:func:`compare_dtype`): both sides as exact float32 values of that
    dtype."""
    return x.float() > round_to(th, compare_dtype(x.dtype, th))


def kernel_th(th, widen: bool = False):
    """A threshold as the reference's kernels hold it
    (``jnp.asarray([th], jnp.float32)``), for the kernels' plain versions.
    By default a Python number, so a comparison on bf16 CS rounds it on to
    bf16 as the kernels that cast it do (prefilter, pqinter, pqscore); with
    ``widen``, a float32 scalar, so bf16 entries widen to float32 against
    it as in bitpack. None stays None (Eq. 5)."""
    if th is None:
        return None
    return np.float32(th) if widen else float(np.float32(th))


def _matmul_flags() -> tuple:
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
            b.cuda.matmul.allow_bf16_reduced_precision_reduction)


def _set_matmul_flags(flags: tuple) -> None:
    b = torch.backends
    (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
     b.cuda.matmul.allow_bf16_reduced_precision_reduction) = flags


@contextlib.contextmanager
def exact_matmuls():
    """Run the products inside with TF32 off (cuBLAS and cuDNN) and without
    reduced-precision bf16 reductions (a split-K GEMM rounding each partial
    sum to bf16), then restore the three flags the caller had; nested
    entries restore in turn. A float32 product in TF32 keeps about three
    decimal digits. Also a decorator. The flags are torch's and
    process-wide: another thread's products see them changed while an
    entry is open (the service loop is single-threaded)."""
    saved = _matmul_flags()
    _set_matmul_flags((False, False, False))
    try:
        yield
    finally:
        _set_matmul_flags(saved)
