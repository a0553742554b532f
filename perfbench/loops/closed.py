"""The closed loop: one client submits a batch of ``batch`` queries, waits
for its scores and ids in host memory, and submits the next, until the
window's seconds are up or the pool of distinct batches is spent.

Results land in a pinned buffer from the device, then in the client's
store, whose pages are touched before the window. End-to-end readings:

* ``qps``: queries whose results reached the host, over the window's
  seconds;
* ``latency_p95_ms``: the nearest-rank 95th percentile over every query of
  the window, from its batch's submission to its results in the store.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch


class Window(NamedTuple):
    """What a loop's window leaves for the runner."""

    calls: int          # window batches sent, in the pool's order
    window_s: float
    served: list        # per call: (scores (B, k), ids (B, k)) on the host
    readings: dict      # end-to-end metric name -> value
    detail: dict        # written beside the run's outputs


def _p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Loop:
    """One client's closed loop over a system (``systems/<name>.py``) and
    a run's traffic (``harness/traffic.py``)."""

    def __init__(self, system, tf, mix: dict, k: int, device: torch.device):
        if mix.get("clients") != 1:
            raise ValueError("the closed loop drives one client")
        self.system, self.tf, self.device = system, tf, device
        n, b = tf.batches.shape[0], mix["batch"]
        self.store = (torch.zeros((n, b, k), dtype=torch.float32),
                      torch.zeros((n, b, k), dtype=torch.int32))
        self.pin = device.type == "cuda"
        self.recv = (torch.empty((b, k), dtype=torch.float32,
                                 pin_memory=self.pin),
                     torch.empty((b, k), dtype=torch.int32,
                                 pin_memory=self.pin))
        for i, q in enumerate(tf.warmup):
            self._receive(q, None if tf.warm_filters is None
                          else tf.warm_filters[i])

    def _receive(self, queries, predicate) -> None:
        for buf, x in zip(self.recv, self.system(queries, predicate)):
            buf.copy_(x, non_blocking=self.pin)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, t0: float, seconds: float, min_calls: int,
               after_call) -> Window:
        """Batches from ``t0`` for ``seconds``, at least ``min_calls`` of
        them; ``after_call(i)`` after each."""
        tf, n = self.tf, self.tf.batches.shape[0]
        lat, i = [], 0
        while i < n and (i < min_calls or
                         time.perf_counter() - t0 < seconds):
            pred = None if tf.filters is None else tf.filters[i]
            ts = time.perf_counter()
            self._receive(tf.batches[i], pred)
            self.store[0][i].copy_(self.recv[0])
            self.store[1][i].copy_(self.recv[1])
            lat.append(time.perf_counter() - ts)
            after_call(i)
            i += 1
        window_s = time.perf_counter() - t0
        b = tf.batches.shape[1]
        served = [(self.store[0][c], self.store[1][c]) for c in range(i)]
        return Window(i, window_s, served,
                      {"qps": i * b / window_s,
                       "latency_p95_ms": 1e3 * _p95(lat)},
                      {"call_s": lat})
