"""Sharding rules for recsys state (counterpart of
``repro/sharding/recsys_rules.py``): embedding tables row-shard over
("data", "model") (the pod axis replicates: data-parallel across pods);
everything else (MLPs, GRUs, capsule maps) is tiny and replicates.
Optimizer states take their param's spec by shape (adagrad accumulators
shard with their tables)."""
from __future__ import annotations

from typing import Tuple

from ..launch.mesh import Mesh
from .rules import _by_shape

ROW_SHARD_MIN = 100_000  # rows; smaller tables replicate
TABLE_KEYS = ("tables", "item_emb", "cat_emb", "codes")


def _row_axes(mesh: Mesh):
    axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    return axes if axes else None


def recsys_state_shardings(mesh: Mesh, params: dict, opt: dict
                           ) -> Tuple[dict, dict]:
    """Specs of (params, opt_state), each ``{path: spec}``, for the flat
    ``{path: tensor}`` leaves of a recommender's tree and of its
    optimizer's state."""
    rows = _row_axes(mesh)
    by_shape = {}
    out = {}
    for path in params:
        leaf = params[path]
        big_table = leaf.ndim >= 2 and leaf.shape[0] >= ROW_SHARD_MIN
        keys = [str(p) for p in path]
        if big_table and any(k in keys for k in TABLE_KEYS):
            sp = (rows, *([None] * (leaf.ndim - 1)))
        else:
            sp = (None,) * leaf.ndim
        by_shape[tuple(leaf.shape)] = sp
        out[path] = sp
    return out, _by_shape(opt, by_shape)
