"""internlm2-20b [dense] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544, GQA [arXiv:2403.17297] (counterpart of
``repro/configs/internlm2_20b.py``)."""
import torch

from ..models.layers import ModelConfig
from .registry import ArchSpec, lm_shapes, register


def make_config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=16384, vocab=92544, qkv_bias=False,
        dtype=dtype, attn_q_chunk=1024, attn_kv_chunk=2048,
        remat_policy="full")


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", n_layers=2, d_model=192, n_heads=6,
        n_kv_heads=2, d_head=32, d_ff=384, vocab=512, dtype=torch.float32)


SPEC = register(ArchSpec(
    name="internlm2-20b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=lm_shapes(ga_train=4),
    optimizer="adamw",
    model_flops_params={"n_params": 19.9e9, "moe": False}))
