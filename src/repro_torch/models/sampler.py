"""Uniform neighbour sampler for mini-batch GNN training, GraphSAGE-style
(counterpart of ``repro/models/sampler.py``).

Over a padded neighbour table (CSR rows padded to ``max_degree`` with a
sentinel), each seed draws ``fanout`` neighbours uniformly with replacement;
a seed of degree 0 keeps its draws but masks them (the reference's static
shapes). Produces per-hop node ids and block edge lists for
``gcn.forward_sampled``. Draws come from a ``torch.Generator`` on the
table's device; jax.random's cannot be replayed, so they are not the
reference's.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device


def pad_adjacency(row_ptr, col_idx, n_nodes: int, max_degree: int,
                  sentinel: int, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR -> padded (n_nodes, max_degree) int32 neighbour table and
    (n_nodes,) int32 degrees (capped at ``max_degree``), on
    ``resolve_device(device)`` (ref ``sampler.py:18``)."""
    dev = resolve_device(device)
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    nbr = np.full((n_nodes, max_degree), sentinel, dtype=np.int32)
    deg = np.minimum(np.diff(row_ptr[:n_nodes + 1]), max_degree).astype(
        np.int32)
    slot = np.arange(max_degree)
    take = slot[None, :] < deg[:, None]
    nbr[take] = col_idx[(row_ptr[:n_nodes, None] + slot[None, :])[take]]
    return torch.from_numpy(nbr).to(dev), torch.from_numpy(deg).to(dev)


def sample_hop(gen: torch.Generator, seeds: torch.Tensor,
               nbr_table: torch.Tensor, degrees: torch.Tensor, fanout: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """seeds (B,) -> (neighbours (B*fanout,), edges (2, B*fanout) [local
    hop-(i+1) index, local seed index], mask (B*fanout,)) (ref
    ``sampler.py:31``). ``gen`` lives on the table's device. A seed outside
    the table (a sentinel drawn at the hop before) has degree 0: its draws
    are masked and pass the sentinel on, where the reference's ``jnp.take``
    fills."""
    b = seeds.shape[0]
    dev = nbr_table.device
    seeds = seeds.long()
    inside = (seeds >= 0) & (seeds < nbr_table.shape[0])
    safe = torch.where(inside, seeds, 0)
    deg = torch.where(inside, degrees[safe], 0)
    draw = torch.randint(0, 1 << 30, (b, fanout), generator=gen, device=dev)
    col = draw % torch.clamp(deg, min=1).long()[:, None]
    picked = torch.gather(nbr_table[safe], 1, col)
    picked = torch.where(inside[:, None], picked,
                         seeds[:, None].to(picked.dtype))
    valid = (deg > 0)[:, None].expand(b, fanout)
    src = picked.reshape(-1)
    dst = torch.repeat_interleave(torch.arange(b, dtype=torch.int32,
                                               device=dev), fanout)
    edges = torch.stack([torch.arange(b * fanout, dtype=torch.int32,
                                      device=dev), dst])
    return src, edges, valid.reshape(-1)


def sample_blocks(seed: Union[int, torch.Generator], seeds: torch.Tensor,
                  nbr_table: torch.Tensor, degrees: torch.Tensor,
                  fanouts: List[int]) -> Tuple[list, list]:
    """Layered sampling (ref ``sampler.py:48``) -> (node ids per hop, the
    seeds first; blocks, blocks[i] = {``edges``, ``edge_mask``} from hop
    i + 1 to hop i). ``seed``: an int, or a generator on the table's
    device, drawn from hop by hop."""
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=nbr_table.device)
        gen.manual_seed(int(seed))
    hop_nodes, blocks = [seeds], []
    cur = seeds
    for f in fanouts:
        src, edges, mask = sample_hop(gen, cur, nbr_table, degrees, f)
        hop_nodes.append(src)
        blocks.append({"edges": edges, "edge_mask": mask})
        cur = src
    return hop_nodes, blocks
