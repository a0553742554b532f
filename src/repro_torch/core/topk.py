"""Top-k selection with ``jax.lax.top_k`` semantics.

``torch.topk`` does not break ties toward the lower index (on
``[1, 3, 3, 2, 3]`` with k=3 it returned ``[2, 4, 1]``; ``lax.top_k`` returns
``[1, 2, 4]``), and it treats ``-0.0`` and ``0.0`` as equal where XLA orders
floats totally (``-0.0 < 0.0``). Every selection in the port goes through
:func:`topk`: it packs each value's total-order key and its position into
one int64 key, ``(key << 32) | (2^32 - 1 - index)``. The keys are unique, so
any exact selection over them — here ``torch.topk`` — returns the same
entries in the same order as a stable descending sort: descending values,
lowest index first on ties.
"""
from __future__ import annotations

import torch

_LOW = 0xFFFFFFFF


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Map float32 values to int32 keys ordered as XLA's total order for
    floats (``-0.0 < 0.0``); int32 tensors pass through unchanged."""
    if not x.dtype.is_floating_point:
        return x
    if x.dtype != torch.float32:
        x = x.float()
    i = x.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last axis,
    descending, lowest index first on ties — ``lax.top_k`` bit for bit.
    ``x`` is float32 or int32; indices are int64 (torch's gather type)."""
    n = x.shape[-1]
    assert n <= _LOW, "positions must fit the key's low 32 bits"
    key = total_order_key(x).to(torch.int64) << 32
    key = key + (_LOW - torch.arange(n, device=x.device, dtype=torch.int64))
    top, _ = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    idx = _LOW - (top & _LOW)
    return torch.gather(x, -1, idx), idx
