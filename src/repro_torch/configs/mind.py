"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030] (counterpart of
``repro/configs/mind.py``).

The paper's technique applies here directly: a MIND user is a multi-vector
query (4 interest capsules) and candidate scoring is MaxSim with n_q = 4, so
``retrieval_cand`` (1M candidates) runs through the EMVB engine."""
import torch

from ..models.recsys.mind import MINDConfig
from .registry import ArchSpec, recsys_shapes, register


def make_config(dtype=torch.float32) -> MINDConfig:
    return MINDConfig(
        name="mind", vocab_items=1_000_000, embed_dim=64, n_interests=4,
        capsule_iters=3, seq_len=50, dtype=dtype)


def make_smoke_config() -> MINDConfig:
    return MINDConfig(name="mind-smoke", vocab_items=500, embed_dim=16,
                      n_interests=4, capsule_iters=2, seq_len=12)


SPEC = register(ArchSpec(
    name="mind", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=recsys_shapes(),
    optimizer="adamw",
    model_flops_params={"n_params": 64e6, "moe": False},
    notes="EMVB directly applicable (multi-interest == multi-vector); "
          "retrieval_cand uses the EMVB engine with n_q=4"))
