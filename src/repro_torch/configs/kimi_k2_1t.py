"""kimi-k2-1t-a32b [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert)
vocab=163840, MoE 384 experts top-8 + 1 shared expert, trained with Muon
[arXiv:2501 Kimi K2 tech report; unverified tier] (counterpart of
``repro/configs/kimi_k2_1t.py``)."""
import torch

from ..models.layers import ModelConfig
from .registry import ArchSpec, lm_shapes, register


def make_config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, d_head=128, d_ff=2048, vocab=163840, qkv_bias=False,
        n_experts=384, top_k=8, n_shared_experts=1, capacity_factor=1.0,
        dtype=dtype, attn_q_chunk=1024, attn_kv_chunk=2048)


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_head=16, d_ff=64, vocab=512, n_experts=16, top_k=4,
        n_shared_experts=1, dtype=torch.float32)


SPEC = register(ArchSpec(
    name="kimi-k2-1t-a32b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=lm_shapes(ga_train=8),
    optimizer="muon",
    model_flops_params={"n_params": 1.04e12, "n_active": 32.5e9, "moe": True}))
