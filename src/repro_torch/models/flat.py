"""Parameters held leaf for leaf in the reference's tree, and the MLP layers
the recommender and graph models share.

The recommender (``models/recsys``) and GCN modules name their parameters
after the reference's keys, with a ``ModuleList`` where the reference keeps
a list: ``bot.0.w`` is the leaf at ``("bot", 0, "w")``. Their layout is the
identity, so :func:`to_reference_layout` and :func:`load_reference_layout`
only turn names into paths (the transformer's pair, which stacks its layers,
is in ``models/transformer.py``). Integer leaves (DLRM's PQ codes) are
buffers: part of the tree, not of what the optimizer updates.

Weights are drawn on the module's own device from a seed (:func:`draw`),
so a table of gigabytes never crosses the host; one seed gives the same
weights on one device every time, not the same on the CPU and the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.kmeans import Seed


def reference_path(name: str) -> tuple:
    """A tensor's name (``bot.0.w``) -> its reference leaf's path
    (``("bot", 0, "w")``): list positions become ints."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def named_leaves(model: nn.Module) -> dict:
    """``{path: tensor}`` of every leaf of the reference's tree: the
    parameters and the buffers, in the reference's order."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    return {reference_path(n): named[n] for n in sorted(
        named, key=reference_path)}


def to_reference_layout(model: nn.Module, tensors=None) -> dict:
    """``{path: tensor}`` of the parameters in the reference's leaf order;
    ``tensors`` (one per parameter, in ``named_parameters`` order; the
    detached parameters by default) are what is laid out."""
    names = [n for n, _ in model.named_parameters()]
    if tensors is None:
        tensors = [p.detach() for p in model.parameters()]
    by_path = {reference_path(n): t for n, t in zip(names, tensors)}
    return {p: by_path[p] for p in sorted(by_path)}


@torch.no_grad()
def load_reference_layout(model: nn.Module, flat: dict) -> None:
    """Copy ``{path: array or tensor}`` into the parameters, each cast to
    its dtype, and into the buffers ``flat`` holds."""
    from .transformer import as_tensor
    named = [(n, t, True) for n, t in model.named_parameters()]
    named += [(n, t, False) for n, t in model.named_buffers()]
    for name, t, required in named:
        path = reference_path(name)
        if path not in flat and not required:
            continue
        src = flat[path]
        src = as_tensor(src) if not isinstance(src, torch.Tensor) else src
        t.copy_(src.to(t.dtype))


def integer_leaves(model: nn.Module) -> list:
    """Paths of the tree's leaves that are not floating point."""
    return [p for p, t in named_leaves(model).items()
            if not t.dtype.is_floating_point]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, rows gathered so that the backward sums each row's
    gradients in one fixed order on either device: indexing on the card
    (its backward sorts the indices; ``F.embedding``'s gave other bits on
    a second run on an H100 once more than 3,072 indices repeated rows,
    torch 2.11) and ``F.embedding`` on the CPU (indexing's backward adds
    with atomics across threads there)."""
    idx = idx.long()
    return table[idx] if table.is_cuda else F.embedding(idx, table)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed by segment, in row
    order within a segment; empty segments are 0. ``segment_ids`` lie in
    [0, num_segments). The rows go through a stable sort and
    ``torch.segment_reduce``, not ``index_add_``, whose float atomics on the
    card sum in arrival order, so a sum gives the same bits every run; the
    sort's gather is a permutation, whose backward adds no two rows. The
    lengths come from the sorted ids (``searchsorted``), not ``bincount``,
    which waits on the card for the ids' maximum."""
    ids, order = torch.sort(segment_ids.long(), stable=True)
    bounds = torch.searchsorted(ids, torch.arange(num_segments + 1,
                                                  device=ids.device))
    return torch.segment_reduce(data[order], "sum",
                                lengths=bounds[1:] - bounds[:-1], unsafe=True)


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def generator(seed: Seed, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (an int, or a CPU
    ``torch.Generator`` whose next draw seeds it)."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 1 << 62, (), generator=seed))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


@torch.no_grad()
def draw(t: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill ``t`` with N(0, scale²) draws from ``gen`` (on ``t``'s device),
    drawn in float32 and cast to ``t``'s dtype, as the reference does."""
    x = torch.randn(t.shape, generator=gen, device=t.device)
    t.copy_((x * scale).to(t.dtype))


class Dense(nn.Module):
    """One MLP layer: ``w`` (d_in, d_out) and ``b`` (d_out,)."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = param((d_in, d_out), dtype, device)
        self.b = param((d_out,), dtype, device)


class MLP(nn.ModuleList):
    """The reference's MLP, a list of :class:`Dense` layers over ``dims``."""

    def __init__(self, dims, dtype, device):
        super().__init__(Dense(dims[i], dims[i + 1], dtype, device)
                         for i in range(len(dims) - 1))

    @torch.no_grad()
    def fill(self, gen: torch.Generator) -> "MLP":
        """``w`` ~ N(0, 1/d_in), ``b`` = 0 (ref ``embedding_bag.py:54``)."""
        for layer in self:
            draw(layer.w, gen, 1.0 / layer.w.shape[0] ** 0.5)
            layer.b.zero_()
        return self
