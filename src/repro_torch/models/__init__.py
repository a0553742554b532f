"""The encoder side of the port (counterpart of ``repro/models``): the
dense transformer layers, the transformer and the ColBERT encoder.

:func:`params_from_reference` and :func:`params_to_reference` carry weights
across: the reference keeps a nested dict of arrays with the layers stacked
on a leading ``n_layers`` axis; the port a module whose ``ModuleList``
holds them one by one.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tree
from .layers import ModelConfig
from .transformer import (Transformer, as_tensor, load_reference_layout,
                          to_reference_layout)

__all__ = ["ModelConfig", "params_from_reference", "params_to_reference"]


def params_from_reference(params: dict, cfg: ModelConfig, device=None
                          ) -> Transformer:
    """The reference's parameter tree (nested dicts of arrays, as
    ``repro.models.colbert.init_params`` or a checkpoint gives them) as a
    module on ``resolve_device(device)``: a ``colbert.ColBERT`` when
    ``cfg.out_proj``, else a ``transformer.Transformer``."""
    from .colbert import ColBERT
    model = (ColBERT(cfg, seed=None, device=device) if cfg.out_proj
             else Transformer(cfg, device))
    flat = {path: as_tensor(a) for path, a in tree.leaves(params)}
    load_reference_layout(model, flat)
    return model


def params_to_reference(model: Transformer) -> dict:
    """The module's parameters as the reference's tree: nested dicts of
    numpy arrays, the layers stacked. bf16 parameters come out as float32
    arrays (numpy has no bf16), which hold their values exactly."""
    flat = {}
    for path, t in to_reference_layout(model).items():
        t = t.float() if t.dtype == torch.bfloat16 else t
        flat[path] = np.array(t.cpu().numpy())
    return tree.nest(flat)
