"""Nearest-centroid assignment against frozen centroids (counterpart of the
assignment half of ``repro/core/kmeans.py``; training stays with the index
build).

The distance is the reference's ``sum(c*c) - 2 x@c.T`` (``kmeans.py:17``),
argmin'd with the first index kept on ties, as ``jnp.argmin`` keeps it. The
float32 matmul bits differ between torch and XLA, and between the CPU and
the card (ROADMAP hazard 3), so a row whose two best centroids lie within
rounding of each other can be assigned otherwise. That is the one place the
port's encode may differ from the reference: the contract is equal codes
except at such near-ties, where the exact distances of the two choices
differ by at most :data:`NEAR_TIE_EPS` (:func:`choice_gap` measures it).
"""
from __future__ import annotations

import torch

# Bytes of the (rows, n_c) float32 distance block one assign step holds: the
# reference's 16,384-row chunk is 17 GB against 2^18 centroids.
ASSIGN_BLOCK_BYTES = 1 << 30

# Two float32 evaluations of ``sum(c*c) - 2 x.c`` can order two choices
# differently only if their exact distances differ by at most twice the
# error bound of one evaluation, n u (|c|^2 + 2 sum|x_i c_i|) to first order
# (u = 2^-24). For unit rows and centroids at d = 128 that is
# 2 * 128 u * 3 = 768 u (about 4.6e-5); for PQ sub-vectors of norm <= 2 at
# dsub <= 32 it is at most 2 * 32 u * 12, the same 768 u.
NEAR_TIE_EPS = 768 * 2.0 ** -24


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) squared L2 distances up to a per-row
    constant (ref ``kmeans.py:17``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.sum(c * c, dim=-1)[None, :] - 2.0 * (x @ c.T)


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment (ref ``kmeans.py:24``) -> (n,) int32, on
    the rows' device, in blocks of rows whose distance block fits
    :data:`ASSIGN_BLOCK_BYTES`."""
    n, n_c = x.shape[0], centroids.shape[0]
    rows = max(1, ASSIGN_BLOCK_BYTES // (4 * n_c))
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    for s in range(0, n, rows):
        out[s:s + rows] = torch.argmin(
            _pairwise_sq_dists(x[s:s + rows], centroids), dim=-1)
    return out


def choice_gap(x: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """|dist(x, c[a]) - dist(x, c[b])| per row in float64: how far apart
    two assignments ``a`` and ``b`` (n,) of the rows x (n, d) are in exact
    arithmetic. Two valid encodes of a row may differ only where this is at
    most :data:`NEAR_TIE_EPS`."""
    x = x.double()
    ca, cb = c[a.long()].double(), c[b.long()].double()
    da = (ca * ca).sum(-1) - 2.0 * (x * ca).sum(-1)
    db = (cb * cb).sum(-1) - 2.0 * (x * cb).sum(-1)
    return (da - db).abs()
