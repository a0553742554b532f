"""qwen2.5-32b [dense] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, GQA, QKV bias [hf:Qwen/Qwen2.5-32B] (counterpart of
``repro/configs/qwen2p5_32b.py``)."""
import torch

from ..models.layers import ModelConfig
from .registry import ArchSpec, lm_shapes, register


def make_config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=8, d_head=128, d_ff=27648, vocab=152064, qkv_bias=True,
        dtype=dtype, attn_q_chunk=2048, attn_kv_chunk=4096,
        remat_policy="full")


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke", n_layers=2, d_model=160, n_heads=5,
        n_kv_heads=1, d_head=32, d_ff=320, vocab=512, qkv_bias=True,
        dtype=torch.float32)


SPEC = register(ArchSpec(
    name="qwen2.5-32b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=lm_shapes(ga_train=4),
    optimizer="adamw",
    model_flops_params={"n_params": 32.8e9, "moe": False}))
