"""The kernels on the ``meta`` device: shapes out, bytes counted.

A wrapper handed ``meta`` tensors (the dry run, ``launch/op_stats.py``)
launches nothing and falls back to nothing: it returns empty tensors of its
kernel's output shapes and reports the bytes its kernel must move and the
operations it does, by the formula of the kernel's bound (``PERF.md`` §6,
``chip_smoke.py``'s ``*_bound``). Where that formula reads the data (the
docs some query keeps as candidates, the tokens that are valid, the CS^T
rows they touch), a meta tensor has none, so it takes the dense upper bound:
every doc a candidate, every token valid, every touched row distinct up to
the table's size.
"""
from __future__ import annotations

import contextlib

import torch

_sinks: list = []


@contextlib.contextmanager
def sink(fn):
    """Within the block, ``fn(kernel, nbytes, ops)`` hears each meta call."""
    _sinks.append(fn)
    try:
        yield
    finally:
        _sinks.remove(fn)


def account(kernel: str, nbytes: int, ops: int) -> None:
    for fn in list(_sinks):
        fn(kernel, int(nbytes), int(ops))


def empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def rows_touched(nb: int, n_c: int, tokens: int) -> int:
    """Distinct (query, centroid) CS^T rows ``tokens`` valid tokens over
    ``nb`` queries can touch, at most."""
    return min(nb * n_c, tokens)
