"""qwen2.5-3b [dense] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, GQA, QKV bias [hf:Qwen/Qwen2.5-3B] (counterpart of
``repro/configs/qwen2p5_3b.py``)."""
import torch

from ..models.layers import ModelConfig
from .registry import ArchSpec, lm_shapes, register


def make_config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, d_head=128, d_ff=11008, vocab=151936, qkv_bias=True,
        dtype=dtype, attn_q_chunk=1024, attn_kv_chunk=2048)


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab=512, qkv_bias=True,
        dtype=torch.float32)


SPEC = register(ArchSpec(
    name="qwen2.5-3b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=lm_shapes(ga_train=2),
    optimizer="adamw", fsdp=False,
    model_flops_params={"n_params": 3.09e9, "moe": False},
    notes="full-attention decode at 500k is linear-cost; run, not skipped"))
