"""dien [recsys] embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru [arXiv:1809.03672] (counterpart of
``repro/configs/dien.py``). The item vocabulary is 1M so that the
``retrieval_cand`` shape (1M candidates) is in vocabulary."""
import torch

from ..models.recsys.dien import DIENConfig
from .registry import ArchSpec, recsys_shapes, register


def make_config(dtype=torch.float32) -> DIENConfig:
    return DIENConfig(
        name="dien", vocab_items=1_000_000, vocab_cats=10_000, embed_dim=18,
        seq_len=100, gru_dim=108, mlp_dims=(200, 80), dtype=dtype)


def make_smoke_config() -> DIENConfig:
    return DIENConfig(name="dien-smoke", vocab_items=200, vocab_cats=20,
                      embed_dim=8, seq_len=12, gru_dim=16, mlp_dims=(32, 16))


SPEC = register(ArchSpec(
    name="dien", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=recsys_shapes(),
    optimizer="adagrad",
    model_flops_params={"n_params": 37e6, "moe": False},
    notes="AUGRU ranking head is not MaxSim -> EMVB filter inapplicable; "
          "retrieval_cand scores 1M candidates through the full model"))
