"""Gradient compression (counterpart of ``repro/train/compression.py``):
int8 per leaf with a float32 scale, the round trip a compressed all-reduce
would put the gradients through, with optional stochastic rounding."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_int8(g: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, float32 scale): ``g / scale`` rounded half to even,
    or, with ``generator`` (a CPU ``torch.Generator``, where the reference
    takes a jax key), floored after adding uniform noise drawn on the CPU
    (stochastic rounding); clipped to [-127, 127]."""
    scale = torch.clamp(torch.amax(torch.abs(g)).float(), min=1e-12) / 127.0
    x = g.float() / scale
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator).to(x.device)
        x = torch.floor(x + noise)
    else:
        x = torch.round(x)
    return torch.clamp(x, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """int8 values times their scale, in ``dtype``."""
    return (q.float() * scale).to(dtype)


def compress_tree(grads: dict, generator: Optional[torch.Generator] = None
                  ) -> dict:
    """Round-trip every leaf of a flat gradient dict through int8, in
    order; a ``generator`` draws each leaf's noise in turn."""
    return {k: dequantize_int8(*quantize_int8(g, generator), g.dtype)
            for k, g in grads.items()}
