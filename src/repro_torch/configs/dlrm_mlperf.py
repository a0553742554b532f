"""dlrm-mlperf [recsys]: the MLPerf DLRM benchmark config (Criteo 1TB)
[arXiv:1906.00091]. n_dense=13 n_sparse=26 embed_dim=128
bot=13-512-256-128 top=1024-1024-512-256-1 interaction=dot (counterpart of
``repro/configs/dlrm_mlperf.py``).

The vocabulary sizes are the public MLPerf / Criteo-Terabyte per-field
cardinalities: ~188M rows, 96 GB of float32 tables."""
import torch

from ..models.recsys.dlrm import DLRMConfig
from .registry import ArchSpec, recsys_shapes, register

CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36)


def make_config(dtype=torch.float32, use_pq_tables: bool = False
                ) -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-mlperf", n_dense=13, n_sparse=26, embed_dim=128,
        vocab_sizes=CRITEO_1TB_VOCABS, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1), nnz=1,
        use_pq_tables=use_pq_tables, dtype=dtype)


def make_smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-smoke", vocab_sizes=(64,) * 26, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(64, 1), nnz=2)


SPEC = register(ArchSpec(
    name="dlrm-mlperf", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=recsys_shapes(),
    optimizer="adagrad",
    model_flops_params={"n_params": 24.1e9, "moe": False},
    notes="EMVB C3 applies as optional PQ-compressed tables; C1/C2/C4 "
          "inapplicable (score is MLP(dot-interactions), not MaxSim)"))
