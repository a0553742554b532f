"""Lloyd's k-means (counterpart of ``repro/core/kmeans.py``): the
nearest-centroid assignment against frozen centroids, and the training that
builds the centroid vocabulary and the PQ codebooks.

The distance is the reference's ``sum(c*c) - 2 x@c.T`` (``kmeans.py:17``),
argmin'd with the first index kept on ties, as ``jnp.argmin`` keeps it. The
float32 matmul bits differ between torch and XLA, and between the CPU and
the card (ROADMAP hazard 3), so a row whose two best centroids lie within
rounding of each other can be assigned otherwise. That is the one place the
port's encode may differ from the reference: the contract is equal codes
except at such near-ties, where the exact distances of the two choices
differ by at most :data:`NEAR_TIE_EPS` (:func:`choice_gap` measures it).

Training draws its randomness from a ``torch.Generator`` (or an int seed
that makes one) where the reference takes a ``jax.random`` key: the initial
centroids are ``randperm(n)[:k]`` and empty clusters are reseeded from
``randint`` rows, as the reference's ``_update`` does. The draws are made
on the CPU, so a seed gives the same centroids on the CPU and on the card.
The per-cluster sums run in row order inside each cluster
(``segment_reduce`` over rows stably sorted by cluster): the reference's
summation order, and no float atomics, so two runs give the same bits.
"""
from __future__ import annotations

from typing import Union

import torch

from ..device import resolve_device
from .precision import exact_matmuls

Seed = Union[int, torch.Generator]

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
    constant (ref ``kmeans.py:17``), TF32 off (:func:`exact_matmuls`)."""
    with exact_matmuls():
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


def generator(seed: Seed) -> torch.Generator:
    """A CPU ``torch.Generator``: ``seed`` itself when it is one, else a
    fresh one seeded with the int."""
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def split(seed: Seed, n: int) -> list[torch.Generator]:
    """``n`` independent generators drawn from ``seed`` (the counterpart of
    ``jax.random.split``)."""
    g = generator(seed)
    return [generator(int(s)) for s in
            torch.randint(0, 1 << 62, (n,), generator=g)]


def _update(x: torch.Tensor, assignment: torch.Tensor, k: int,
            old: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """One Lloyd update (ref ``kmeans.py:38``): each cluster's mean, summed
    in row order; an empty cluster takes a row drawn with ``randint`` from
    ``g`` (a draw of k rows is made every call, as the reference draws
    every step). ``old`` is unused, as in the reference."""
    a = assignment.long()
    order = torch.sort(a, stable=True).indices
    counts = torch.bincount(a, minlength=k)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts,
                                unsafe=True)
    new = sums / torch.clamp(counts.to(x.dtype), min=1.0)[:, None]
    reseed = x[torch.randint(0, x.shape[0], (k,), generator=g).to(x.device)]
    return torch.where((counts > 0)[:, None], new, reseed)


def _lloyd(x: torch.Tensor, c0: torch.Tensor, iters: int,
           g: torch.Generator) -> torch.Tensor:
    """``iters`` Lloyd steps from the centroids ``c0``: assign, then
    :func:`_update` (ref ``kmeans.py:60``, the body of its scan)."""
    c = c0
    for _ in range(iters):
        c = _update(x, assign(x, c), c.shape[0], c, g)
    return c


def kmeans(seed: Seed, x, k: int, *, iters: int = 8, device=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm (ref ``kmeans.py:51``) on ``resolve_device(device)``
    (the GPU unless the caller asks for the CPU): k distinct rows of x
    (``randperm``) as the initial centroids, ``iters`` steps. Raises
    ``ValueError`` when x has fewer than k rows, where the reference fails.
    -> (centroids (k, d), assignment (n,) int32)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.shape[0] < k:
        raise ValueError(
            f"k-means over {x.shape[0]} rows cannot seed k={k} centroids: "
            "the initial centroids are k distinct rows, so train on at "
            "least k rows (real tokens) or lower k")
    g = generator(seed)
    init, loop = split(g, 2)
    c0 = x[torch.randperm(x.shape[0], generator=init)[:k].to(dev)]
    c = _lloyd(x, c0, iters, loop)
    return c, assign(x, c)


def kmeans_spherical(seed: Seed, x, k: int, *, iters: int = 8, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means (ref ``kmeans.py:69``): :func:`kmeans`, then the
    centroids re-normalized and the rows assigned to them."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    c, _ = kmeans(seed, x, k, iters=iters, device=dev)
    c = c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-12)
    return c, assign(x, c)
