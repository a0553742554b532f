"""PLAID's b-bit residual codec (counterpart of ``repro/core/residual.py``):
each residual dimension is bucketized against the codec's quantile cutoffs
and the b-bit codes are packed 8/b per byte. The codec is trained on
quantiles of a residual sample, computed as jax computes them (sort, then
linear interpolation in float32), for inputs of any size.

Bit fields are packed in int32: torch has no ``<<`` for uint32 on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ResidualCodec(NamedTuple):
    """PLAID's b-bit quantile bucket codec for residual values (ref
    ``residual.py:17``)."""

    cutoffs: torch.Tensor         # (2^b - 1,) bucket boundaries
    bucket_weights: torch.Tensor  # (2^b,) reconstruction values
    b: int                        # bits per dimension


def quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation quantiles of all of x at the float32 levels q,
    as ``jnp.quantile`` writes them: sort, position ``q * (n - 1)`` in
    float32, then ``low * (1 - w) + high * w``, each product and the sum
    rounded to float32. (XLA's optimizing CPU backend fuses the second
    product and the sum into one FMA, which moves a value by at most one
    ulp; unoptimized, as the reference's test lane runs it, the bits are
    these.) NaN anywhere gives NaN. Unlike ``torch.quantile`` it takes any
    number of elements."""
    flat = torch.sort(x.reshape(-1).to(torch.float32)).values
    n = flat.numel()
    pos = q.to(flat) * (torch.tensor(float(n), dtype=torch.float32,
                                      device=flat.device) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo = flat[low.clamp(0, n - 1).long()]
    hi = flat[high.clamp(0, n - 1).long()]
    out = lo * lw + hi * hw
    return torch.where(torch.isnan(flat).any(), torch.nan, out)


def train_residual_codec(residuals: torch.Tensor, b: int) -> ResidualCodec:
    """Quantile buckets over a sample of residual values, all dimensions
    pooled as in ColBERTv2 (ref ``residual.py:25``): 2^b - 1 cutoffs at the
    inner levels of ``linspace(0, 1, 2^b + 1)`` and a reconstruction
    weight at the middle of each bucket."""
    nb = 1 << b
    dev = residuals.device
    cutoffs = quantile(residuals, torch.linspace(0.0, 1.0, nb + 1,
                                                 device=dev)[1:-1])
    mids = torch.linspace(0.0, 1.0, 2 * nb + 1, device=dev)[1::2]
    return ResidualCodec(cutoffs, quantile(residuals, mids), b)


def encode_residual(r: torch.Tensor, codec: ResidualCodec) -> torch.Tensor:
    """(..., d) -> (..., d * b / 8) uint8, bit-packed (ref ``residual.py:37``):
    the bucket is the left insertion point of each value among the
    cutoffs, as ``jnp.searchsorted`` gives it."""
    codes = torch.searchsorted(codec.cutoffs.contiguous(), r.contiguous())
    return pack_codes(codes, codec.b)


def decode_residual(packed: torch.Tensor, codec: ResidualCodec,
                    d: int) -> torch.Tensor:
    """(..., d*b/8) uint8 -> (..., d) float32 reconstruction (ref
    ``residual.py:43``)."""
    codes = unpack_codes(packed, codec.b, d)
    return codec.bucket_weights[codes.long()]


def _shifts(b: int, device) -> torch.Tensor:
    return torch.arange(8 // b, dtype=torch.int32, device=device) * b


def pack_codes(codes: torch.Tensor, b: int) -> torch.Tensor:
    """Pack b-bit codes (values < 2^b) along the last axis, 8/b per byte
    (ref ``residual.py:49``)."""
    per = 8 // b
    *lead, d = codes.shape
    if d % per:
        raise ValueError(f"d={d} is no multiple of {per} codes a byte")
    grp = codes.reshape(*lead, d // per, per).to(torch.int32)
    packed = (grp << _shifts(b, codes.device)).sum(-1)   # disjoint fields
    return packed.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., d*b/8) uint8 -> (..., d) codes
    (ref ``residual.py:60``)."""
    grp = (packed.to(torch.int32)[..., None] >> _shifts(b, packed.device)) \
        & ((1 << b) - 1)
    out = grp.reshape(*packed.shape[:-1], -1)
    return out[..., :d].to(torch.uint8)
