"""The loops that send a mix's batches (``perfbench/loops/``), driven over
a stand-in system on the CPU: every batch of the pool in order, its
results stored as served, and the end-to-end readings taken over the
whole window."""
import os
import time

import pytest
import torch

from conftest import PERFBENCH
from harness import spec, traffic


class _Echo:
    """A system that serves each query's first coordinate as its score and
    the batch's first query's as its ids, after a fixed pause."""

    def __init__(self, pause_s):
        self.pause_s, self.calls = pause_s, 0

    def __call__(self, queries, predicate=None):
        time.sleep(self.pause_s)
        self.calls += 1
        k = 4
        sc = queries[:, :1, 0].expand(-1, k).contiguous()
        ids = torch.full((queries.shape[0], k), int(queries[0, 0, 0]),
                         dtype=torch.int32)
        return sc, ids


def _traffic(n, b=3, w=2):
    q = torch.arange(n * b, dtype=torch.float32)[:, None, None].expand(
        n * b, 2, 5).reshape(n, b, 2, 5)
    return traffic.Traffic(q.contiguous(), torch.zeros((w, b, 2, 5)), None,
                           None, None)


def _closed():
    return spec.load_module(os.path.join(PERFBENCH, "loops", "closed.py"),
                            "closed")


def test_closed_loop_warms_up_then_serves_the_pool_in_order():
    sys_ = _Echo(0.0)
    loop = _closed().Loop(sys_, _traffic(5), {"clients": 1, "batch": 3}, 4,
                          torch.device("cpu"))
    assert sys_.calls == 2
    seen = []
    w = loop.window(time.perf_counter(), 60.0, 1, seen.append)
    assert w.calls == 5 and seen == list(range(5))
    for c, (sc, ids) in enumerate(w.served):
        assert sc[:, 0].tolist() == [3 * c, 3 * c + 1, 3 * c + 2]
        assert ids.unique().tolist() == [3 * c]


def test_closed_loop_readings_cover_the_whole_window():
    loop = _closed().Loop(_Echo(0.01), _traffic(400),
                          {"clients": 1, "batch": 3}, 4, torch.device("cpu"))
    t0 = time.perf_counter()
    w = loop.window(t0, 0.3, 4, lambda i: None)
    assert 4 <= w.calls < 400
    assert w.window_s >= 0.3
    assert w.readings["qps"] == pytest.approx(3 * w.calls / w.window_s)
    assert w.readings["latency_p95_ms"] >= 10.0
    assert len(w.detail["call_s"]) == w.calls


def test_closed_loop_takes_one_client_only():
    with pytest.raises(ValueError):
        _closed().Loop(_Echo(0.0), _traffic(2), {"clients": 2, "batch": 3},
                       4, torch.device("cpu"))
