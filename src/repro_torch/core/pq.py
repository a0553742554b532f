"""Product quantization (counterpart of ``repro/core/pq.py``): the codebook
view, training (per-subspace k-means, and OPQ's alternating rotation), the
encoder against frozen codebooks, the decoder, the inner-product LUT and
scoring against it, and ``pq_ste``, the straight-through quantizer the
encoder's JMPQ training runs."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .kmeans import Seed, _pairwise_sq_dists, kmeans, split
from .precision import exact_matmuls


class PQCodebooks(NamedTuple):
    """Per-subspace PQ codebooks: one K-entry table per slice."""

    codebooks: torch.Tensor  # (m, K, dsub) fp32

    @property
    def m(self) -> int:
        """Number of subspaces."""
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        """Codewords per subspace (2^nbits)."""
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        """Dimensions per subspace (d / m)."""
        return self.codebooks.shape[2]


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub) (ref ``pq.py:50``)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"d={d} not divisible by m={m}")
    return x.reshape(n, m, d // m).transpose(0, 1)


def train_pq(seed: Seed, x, m: int, *, nbits: int = 8, iters: int = 8,
             device=None) -> PQCodebooks:
    """Per-subspace codebooks trained on residuals x (n, d) (ref
    ``pq.py:57``), on ``resolve_device(device)``: :func:`~.kmeans.kmeans`
    with 2^nbits centroids on each of the m slices, each slice with its own
    generator split from ``seed``."""
    dev = resolve_device(device)
    subs = _split(torch.as_tensor(x, dtype=torch.float32, device=dev), m)
    gens = split(seed, m)
    return PQCodebooks(torch.stack([
        kmeans(gens[s], subs[s], 1 << nbits, iters=iters, device=dev)[0]
        for s in range(m)]))


def encode_pq(x: torch.Tensor, cb: PQCodebooks) -> torch.Tensor:
    """(n, d) -> (n, m) uint8 codes, the nearest codeword per subspace (ref
    ``pq.py:74``): the distances of :func:`~.kmeans._pairwise_sq_dists`,
    argmin'd with the first index kept on ties."""
    subs = _split(x, cb.m)
    codes = torch.stack([
        torch.argmin(_pairwise_sq_dists(subs[s], cb.codebooks[s]), dim=-1)
        for s in range(cb.m)], dim=1)
    return codes.to(torch.uint8)


def decode_pq(codes: torch.Tensor, cb: PQCodebooks) -> torch.Tensor:
    """(n, m) uint8 -> (n, d) reconstruction (ref ``pq.py:87``)."""
    sub = torch.arange(cb.m, device=codes.device)
    recon = cb.codebooks[sub[None, :], codes.long()]      # (n, m, dsub)
    return recon.reshape(codes.shape[0], -1)


def build_lut(q: torch.Tensor, cb: PQCodebooks) -> torch.Tensor:
    """Inner-product LUT (ref ``pq.py:98``). q (..., d) -> (..., m, K) with
    ``lut[..., s, c] = q[..., s*dsub:(s+1)*dsub] . codebooks[s, c]``."""
    *lead, _ = q.shape
    qs = q.reshape(*lead, cb.m, cb.dsub)
    return torch.einsum("...sd,skd->...sk", qs, cb.codebooks)


def lut_score(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Score tokens against a LUT without decompression (ref ``pq.py:106``):
    lut (..., m, K), codes (n, m) uint8 -> (..., n) with
    ``sum_s lut[..., s, codes[n, s]]``, summed over s = 0..m-1."""
    idx = codes.long()
    out = lut[..., 0, idx[:, 0]]
    for s in range(1, lut.shape[-2]):
        out = out + lut[..., s, idx[:, s]]
    return out


def pq_ste(x: torch.Tensor, cb: PQCodebooks) -> torch.Tensor:
    """Straight-through PQ quantization (ref ``pq.py:119``): the forward is
    ``decode_pq(encode_pq(x))``, the backward the identity. The codes are
    :func:`encode_pq`'s, so they equal the reference's except at near-ties
    (``kmeans.NEAR_TIE_EPS``)."""
    xq = decode_pq(encode_pq(x.detach(), cb), cb)
    return x + (xq - x).detach()


class OPQ(NamedTuple):
    """Optimized PQ (ref ``pq.py:130``): an orthonormal rotation plus the
    codebooks trained on the rotated residuals (Ge et al., 2013)."""

    rotation: torch.Tensor  # (d, d) orthonormal
    cb: PQCodebooks


@exact_matmuls()
def train_opq(seed: Seed, x, m: int, *, nbits: int = 8,
              kmeans_iters: int = 6, opq_iters: int = 4,
              device=None) -> OPQ:
    """Alternate PQ training on the rotated data with the procrustes update
    of the rotation (ref ``pq.py:138``), on ``resolve_device(device)``:
    ``R = U V^T`` from the SVD of ``x^T x_hat``. Sign flips of paired
    singular vectors leave R unchanged."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rot = torch.eye(x.shape[1], dtype=x.dtype, device=dev)
    cb = None
    for g in split(seed, opq_iters):
        xr = x @ rot
        cb = train_pq(g, xr, m, nbits=nbits, iters=kmeans_iters, device=dev)
        xhat = decode_pq(encode_pq(xr, cb), cb)
        u, _, vt = torch.linalg.svd(x.T @ xhat, full_matrices=False)
        rot = u @ vt
    return OPQ(rot, cb)


def pq_reconstruction_mse(x: torch.Tensor, cb: PQCodebooks) -> torch.Tensor:
    """Mean squared encode -> decode reconstruction error of x (n, d) (ref
    ``pq.py:158``)."""
    xhat = decode_pq(encode_pq(x, cb), cb)
    return torch.mean(torch.sum((x - xhat) ** 2, dim=-1))
