"""The model side of the port (counterpart of ``repro/models``): the
transformer layers, the experts (``moe.py``), the transformer with its
prefill and decode over a KV cache, and the ColBERT encoder; the
recommenders (``recsys``: MIND, DLRM, DCN-v2, DIEN) and the GCN with its
neighbour sampler.

:func:`params_from_reference` and :func:`params_to_reference` carry weights
across, and :func:`to_reference_layout` / :func:`load_reference_layout` lay
a module's parameters out as the reference's tree, each model by its own
rule: the transformer's layers, experts included, are stacked on a leading
``n_layers`` axis in the reference and held one by one in a ``ModuleList``
here (``transformer.py``; each leaf keeps its dtype, the float32 router in
a bf16 config too); the recommenders and the GCN hold each leaf under its
reference name (``flat.py``).
"""
from __future__ import annotations

from typing import Any

from torch import nn

from .. import tree
from . import flat
from .layers import ModelConfig
from .transformer import Transformer, as_tensor, to_numpy

__all__ = ["ModelConfig", "params_from_reference", "params_to_reference",
           "to_reference_layout", "load_reference_layout"]


def _layout(model: nn.Module):
    """The module holding ``model``'s layout pair."""
    from . import transformer
    return transformer if isinstance(model, Transformer) else flat


def to_reference_layout(model: nn.Module, tensors=None) -> dict:
    """``{path: tensor}`` of ``model``'s parameters (or of ``tensors``, one
    per parameter in ``named_parameters`` order) in the reference's layout
    and leaf order."""
    return _layout(model).to_reference_layout(model, tensors)


def load_reference_layout(model: nn.Module, flat_tree: dict) -> None:
    """Copy ``{path: array or tensor}`` in the reference's layout into
    ``model``."""
    _layout(model).load_reference_layout(model, flat_tree)


def _model_class(cfg: Any):
    """The module class built from ``cfg``."""
    from .gcn import GCN, GCNConfig
    from .recsys.dcn import DCN, DCNConfig
    from .recsys.dien import DIEN, DIENConfig
    from .recsys.dlrm import DLRM, DLRMConfig
    from .recsys.mind import MIND, MINDConfig
    for c, m in ((MINDConfig, MIND), (DLRMConfig, DLRM), (DCNConfig, DCN),
                 (DIENConfig, DIEN), (GCNConfig, GCN)):
        if isinstance(cfg, c):
            return m
    raise TypeError(f"no ported model for a {type(cfg).__name__}")


def params_from_reference(params: dict, cfg: Any, device=None) -> nn.Module:
    """The reference's parameter tree (nested dicts and lists of arrays, as
    a reference ``init_params`` or a checkpoint gives them) as a module on
    ``resolve_device(device)``: for a ``ModelConfig`` a ``colbert.ColBERT``
    when ``cfg.out_proj``, else a ``transformer.Transformer``; for a
    recommender's or the GCN's config, that model."""
    if isinstance(cfg, ModelConfig):
        from .colbert import ColBERT
        model = (ColBERT(cfg, seed=None, device=device) if cfg.out_proj
                 else Transformer(cfg, device))
    else:
        model = _model_class(cfg)(cfg, device)
    leaves = {path: as_tensor(a) for path, a in tree.leaves(params)}
    load_reference_layout(model, leaves)
    return model


def reference_leaves(model: nn.Module) -> dict:
    """``{path: tensor}`` of every leaf of the module's reference tree: the
    parameters in its layout, and DLRM's PQ codes."""
    return (to_reference_layout(model) if isinstance(model, Transformer)
            else flat.named_leaves(model))


def params_to_reference(model: nn.Module) -> Any:
    """The module's parameters as the reference's tree: nested dicts (and
    lists) of numpy arrays, a transformer's layers stacked, DLRM's PQ codes
    included. bf16 parameters come out as float32 arrays (numpy has no
    bf16), which hold their values exactly."""
    return tree.nest({path: to_numpy(t)
                      for path, t in reference_leaves(model).items()})
