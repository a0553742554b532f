"""Product quantization (counterpart of ``repro/core/pq.py``): the codebook
view, the encoder against frozen codebooks, the decoder and the
inner-product LUT. Training belongs with the index build."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kmeans import _pairwise_sq_dists


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
