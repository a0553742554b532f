"""Product-quantization pieces of the query path (counterpart of
``repro/core/pq.py``): the codebook view, the inner-product LUT and the
decoder. Training and encoding belong to a later slice."""
from __future__ import annotations

from typing import NamedTuple

import torch


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
