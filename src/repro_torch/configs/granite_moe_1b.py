"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
(counterpart of ``repro/configs/granite_moe_1b.py``)."""
import torch

from ..models.layers import ModelConfig
from .registry import ArchSpec, lm_shapes, register


def make_config(dtype=torch.bfloat16) -> ModelConfig:
    # vocab 49155 padded to 49168 (+13 rows) for even 16-way TP sharding
    return ModelConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_head=64, d_ff=512, vocab=49168, qkv_bias=False,
        n_experts=32, top_k=8, dtype=dtype,
        attn_q_chunk=1024, attn_kv_chunk=2048)


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=32, vocab=512, n_experts=8, top_k=2,
        dtype=torch.float32)


SPEC = register(ArchSpec(
    name="granite-moe-1b-a400m", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=lm_shapes(ga_train=1),
    optimizer="adamw", fsdp=False,
    model_flops_params={"n_params": 1.3e9, "n_active": 0.4e9, "moe": True}))
