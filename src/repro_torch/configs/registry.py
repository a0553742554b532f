"""Architecture registry (counterpart of ``repro/configs/registry.py``): the
ten assigned architectures and EMVB's own retrieval config as ``--arch``
entries.

An ArchSpec bundles the full config, the reduced smoke config (CPU tests),
the arch's shape set, each shape's step kind, the optimizer and the dry-run
knobs, as the reference's. The configs are data on the port's config
classes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                 # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    grad_accum: int = 1       # microbatch factor for the train dry-run


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str               # lm | gnn | recsys | retrieval
    make_config: Callable[..., Any]
    make_smoke_config: Callable[[], Any]
    shapes: Dict[str, ShapeCell]
    optimizer: str = "adamw"
    model_flops_params: Optional[dict] = None   # for the 6*N*D roofline term
    # FSDP only where param + optimizer state exceed the per-chip budget
    # under pure tensor parallelism (the reference's dry-run knob)
    fsdp: bool = True
    notes: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    _ensure_loaded()
    return _REGISTRY[name]


def names() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


_loaded = False


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    from . import (dcn_v2, dien, dlrm_mlperf, emvb_msmarco, gcn_cora,  # noqa
                   granite_moe_1b, internlm2_20b, kimi_k2_1t, mind,
                   qwen2p5_32b, qwen2p5_3b)
    _loaded = True


# ---------------------------------------------------------------------------
# shared shape sets
# ---------------------------------------------------------------------------

def lm_shapes(*, ga_train: int = 1) -> Dict[str, ShapeCell]:
    """The LM family's shapes: seq_len x global batch."""
    return {
        "train_4k": ShapeCell("train", {"seq": 4096, "batch": 256},
                              grad_accum=ga_train),
        "prefill_32k": ShapeCell("prefill", {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeCell("decode", {"seq": 32768, "batch": 128}),
        "long_500k": ShapeCell("decode", {"seq": 524288, "batch": 1}),
    }


def recsys_shapes(n_items_retrieval: int = 1_000_000) -> Dict[str, ShapeCell]:
    """The recommenders' shapes: a training batch, two serving batches and
    the retrieval over ``n_items_retrieval`` candidates."""
    return {
        "train_batch": ShapeCell("train", {"batch": 65536}),
        "serve_p99": ShapeCell("serve", {"batch": 512}),
        "serve_bulk": ShapeCell("serve", {"batch": 262144}),
        "retrieval_cand": ShapeCell("retrieval",
                                    {"batch": 1,
                                     "n_candidates": n_items_retrieval}),
    }
