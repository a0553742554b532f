"""Parameter/activation partitioning rules (counterpart of
``repro/sharding/rules.py``).

A spec is a tuple with one entry per leading dimension, each ``None``, an
axis name or a tuple of axis names, as a ``jax.sharding.PartitionSpec``
holds them; dimensions past its end are whole. Params and optimizer states
are flat ``{path: tensor}`` dicts in the reference's layout
(``models.to_reference_layout``), and the rules match on the path joined by
``/``, the reference's key string. Policy, as the reference's:

  * TP over "model": attention projections on the folded head axis, FFN on
    the hidden axis, experts on the expert axis (EP), vocab on the embedding
    rows / lm_head cols.
  * FSDP over ``fsdp`` (None to disable, "data" single-pod, ("pod",
    "data") multi-pod): each TP-sharded param additionally shards its
    *other* large axis; optimizer states take their param's spec by shape
    (leaves whose shape matches the param; factored and scalar states are
    whole).
  * Uneven dimensions are allowed: GSPMD pads them, so a shard's local
    length is the ceiling (:func:`shard_shape`).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from ..launch.mesh import Mesh

Spec = tuple


def key_str(path: tuple) -> str:
    """A leaf's path joined by ``/``: ``layers/attn/wq``."""
    return "/".join(str(p) for p in path)


def lm_param_spec(key: str, ndim: int, fsdp, stacked: bool = True) -> Spec:
    """Spec for one LM param. ``stacked``: leading n_layers axis present on
    layer params. ``fsdp``: None or axis name/tuple for the data axes."""
    L = (None,) if stacked else ()

    if "layers" in key:
        if key.endswith(("attn/wq", "attn/wk", "attn/wv")):
            return (*L, fsdp, "model")
        if key.endswith("attn/wo"):
            return (*L, "model", fsdp)
        if key.endswith(("attn/bq", "attn/bk", "attn/bv")):
            return (*L, "model")
        if key.endswith(("mlp/w_gate", "mlp/w_up", "shared_mlp/w_gate",
                         "shared_mlp/w_up")):
            return (*L, fsdp, "model")
        if key.endswith(("mlp/w_down", "shared_mlp/w_down")):
            return (*L, "model", fsdp)
        if key.endswith("moe/router"):
            return (*L, None, None)
        if key.endswith(("moe/wi_gate", "moe/wi_up")):
            return (*L, "model", fsdp, None)    # EP on expert axis
        if key.endswith("moe/wo"):
            return (*L, "model", None, fsdp)
        if "ln" in key or "norm" in key:
            return (*L, None)
    if key.startswith("embed"):
        return ("model", fsdp)
    if key.startswith("lm_head"):
        return (fsdp, "model")
    if key.startswith("proj"):
        return (None, None)
    if "final_norm" in key:
        return (None,)
    return (None,) * ndim


def _validate(spec: Spec, shape) -> Spec:
    """Drop sharded axes on dims too small to split at all (dim < axis size
    is fine for GSPMD padding, but dim == 1/0 axes are pointless)."""
    return tuple(None if ax is not None and i < len(shape) and shape[i] <= 1
                 else ax for i, ax in enumerate(spec))


def lm_state_shardings(mesh: Mesh, params: dict, opt: dict, fsdp
                       ) -> Tuple[dict, dict]:
    """Specs of (params, opt_state), each ``{path: spec}``: ``params`` the
    flat ``{path: tensor}`` of the reference's layout, ``opt`` the flat
    leaves of the optimizer's state (:func:`state_leaves`)."""
    del mesh
    by_shape = {}
    param_specs = {}
    for path in sorted(params):
        leaf = params[path]
        sp = _validate(lm_param_spec(key_str(path), leaf.ndim, fsdp),
                       leaf.shape)
        by_shape[tuple(leaf.shape)] = sp   # shape -> spec for opt states
        param_specs[path] = sp
    return param_specs, _by_shape(opt, by_shape)


def _by_shape(opt: dict, by_shape: dict) -> dict:
    return {path: by_shape.get(tuple(leaf.shape), (None,) * leaf.ndim)
            for path, leaf in opt.items()}


def state_leaves(state: Any, prefix: tuple = ()) -> dict:
    """An optimizer state's leaves as ``{path: tensor}``, the path of the
    reference's state tree (the flat ``{path: ...}`` dicts of the port
    nested in), in jax's order."""
    out = {}
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    for k, v in state.items():
        out.update(state_leaves(v, prefix + (k if isinstance(k, tuple)
                                             else (k,))))
    return {p: out[p] for p in sorted(out, key=_order)}


def _order(path: tuple) -> tuple:
    return tuple((0, p) if isinstance(p, int) else (1, p) for p in path)


def replicated(tree: dict) -> dict:
    """Whole-tensor specs for every leaf of ``{path: tensor}``."""
    return {path: (None,) * leaf.ndim for path, leaf in tree.items()}


def table_sharding(mesh: Mesh, rows_axes=("data", "model")) -> Spec:
    """Row-wise embedding-table sharding (recsys)."""
    del mesh
    return (rows_axes, None)


def batch_spec(mesh: Mesh, data_axes) -> Spec:
    del mesh
    return (data_axes,)


def axes_of(entry) -> tuple:
    """A spec entry's axis names: () for None."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: Spec, mesh: Mesh) -> tuple:
    """A shard's local shape: each dimension divided by the product of its
    entry's axis sizes, rounded up (GSPMD pads uneven dimensions)."""
    sizes = mesh.shape
    out = []
    for i, n in enumerate(shape):
        ways = math.prod(sizes[a] for a in axes_of(spec[i])) \
            if i < len(spec) else 1
        out.append(-(-n // ways))
    return tuple(out)
