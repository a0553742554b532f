"""gcn-cora [gnn] 2L d_hidden=16 aggregator=mean norm=sym
[arXiv:1609.02907] (counterpart of ``repro/configs/gcn_cora.py``).

The same 2-layer GCN at four graph regimes: cora full-batch, reddit-scale
sampled mini-batch (the neighbour sampler, fanout 15-10), ogbn-products
full-batch, and block-diagonal batches of small molecule graphs.
"""
import torch

from ..models.gcn import GCNConfig
from .registry import ArchSpec, ShapeCell, register


def make_config(shape: str = "full_graph_sm", dtype=torch.float32
                ) -> GCNConfig:
    feat = {"full_graph_sm": 1433, "minibatch_lg": 602,
            "ogb_products": 100, "molecule": 32}[shape]
    ncls = {"full_graph_sm": 7, "minibatch_lg": 41,
            "ogb_products": 47, "molecule": 16}[shape]
    return GCNConfig(name="gcn-cora", n_layers=2, d_feat=feat, d_hidden=16,
                     n_classes=ncls, aggregator="mean", dtype=dtype)


def make_smoke_config() -> GCNConfig:
    return GCNConfig(name="gcn-smoke", n_layers=2, d_feat=32, d_hidden=8,
                     n_classes=4)


SHAPES = {
    "full_graph_sm": ShapeCell("train", {
        "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    "minibatch_lg": ShapeCell("train_sampled", {
        "n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
        "fanout0": 15, "fanout1": 10, "d_feat": 602}),
    "ogb_products": ShapeCell("train", {
        "n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    "molecule": ShapeCell("train", {
        # block-diagonal batch of 128 graphs x (30 nodes, 64 edges)
        "n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 32}),
}

SPEC = register(ArchSpec(
    name="gcn-cora", family="gnn", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=SHAPES, optimizer="adamw",
    model_flops_params={"n_params": 23e3, "moe": False},
    notes="EMVB inapplicable (no query-vs-corpus MaxSim stage); "
          "implemented without the technique per DESIGN.md §5"))
