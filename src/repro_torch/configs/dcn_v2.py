"""dcn-v2 [recsys] n_dense=13 n_sparse=26 embed_dim=16 n_cross=3
mlp=1024-1024-512 interaction=cross [arXiv:2008.13535] (counterpart of
``repro/configs/dcn_v2.py``)."""
import torch

from ..models.recsys.dcn import DCNConfig
from .dlrm_mlperf import CRITEO_1TB_VOCABS
from .registry import ArchSpec, recsys_shapes, register


def make_config(dtype=torch.float32) -> DCNConfig:
    return DCNConfig(
        name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
        vocab_sizes=CRITEO_1TB_VOCABS, n_cross_layers=3,
        mlp_dims=(1024, 1024, 512), nnz=1, dtype=dtype)


def make_smoke_config() -> DCNConfig:
    return DCNConfig(name="dcn-smoke", vocab_sizes=(64,) * 26, embed_dim=8,
                     n_cross_layers=2, mlp_dims=(32, 16), nnz=2)


SPEC = register(ArchSpec(
    name="dcn-v2", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=recsys_shapes(),
    optimizer="adagrad",
    model_flops_params={"n_params": 3.0e9, "moe": False},
    notes="EMVB inapplicable to the cross-network score; PQ-table option "
          "shares the DLRM path"))
