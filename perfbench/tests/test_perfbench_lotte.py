"""The readers of ``late_gather_ms``, ``pqinter_stream_ms`` and
``gather_bytes_per_query`` (``lotte-k1000-b32``'s own metrics) on rings the
program's tracer recorded: spans opened through ``repro_torch.obs.trace``
with CUDA events faked on the CPU, whose stream times the test sets, and
the spans of a ``retrieve`` at the cell's widths on the CPU, where
``bytes`` is read and the stream times are left out. A program without the
two spans (the parent of this change) gives nothing."""
import json
import os

import pytest
import torch

from conftest import PERFBENCH, small_cell
from harness import planted, spec, traffic
from harness.readers import Readings

STREAM = {"late_gather_ms": "engine.late.gather",
          "pqinter_stream_ms": "engine.late.pqinter"}
NAMES = sorted(STREAM) + ["gather_bytes_per_query"]
CELL = "lotte-k1000-b32"


def _metric(name):
    base = os.path.join(PERFBENCH, "metrics", name)
    return (spec.load_module(base + ".py", f"test_lotte_metric_{name}").read,
            json.load(open(base + ".json")))


class _Event:
    """A CUDA event's timing surface on the CPU: ``record`` stamps a clock
    that each record moves on by ``step`` ms."""

    now, step = 0.0, 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        _Event.now += _Event.step
        self.at = _Event.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(_Event, "now", 0.0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    return torch.device("cuda")


# per call: (batch, gather ms, pqinter ms, bytes)
CALLS = [(32, 0.5, 5.0, 691_456_000), (32, 0.6, 5.2, 691_456_000),
         (16, 0.3, 2.9, 345_728_000)]


def _ring(dev, inner=True):
    """The spans of ``CALLS`` as the engine nests them, drained from the
    tracer: ``engine.late.gather`` and ``engine.late.pqinter`` inside
    ``engine.late`` inside ``engine.retrieve.dispatch``; without the two
    inner spans when ``inner`` is False."""
    from repro_torch.obs import trace
    with trace.tracing() as tr:
        for batch, gather_ms, pqinter_ms, nbytes in CALLS:
            with trace.span("engine.retrieve.dispatch", batch=batch,
                            filtered=False):
                _Event.step = 1.0
                with trace.span("engine.late", device=dev):
                    if inner:
                        _Event.step = gather_ms
                        with trace.span("engine.late.gather",
                                        device=dev) as sp:
                            sp.set(bytes=nbytes)
                        _Event.step = pqinter_ms
                        with trace.span("engine.late.pqinter", device=dev):
                            pass
                        _Event.step = 1.0
        return tr.drain()


@pytest.mark.parametrize("name,want", [
    ("late_gather_ms", 1.4 / 3), ("pqinter_stream_ms", 13.1 / 3),
    ("gather_bytes_per_query", 1_728_640_000 / 80)])
def test_reader_gives_what_the_ring_recorded(fake_cuda, name, want):
    read, params = _metric(name)
    ring = _ring(fake_cuda)
    assert read(Readings(None, ring, [], set()), params) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_nothing_without_the_spans(fake_cuda, name):
    read, params = _metric(name)
    ring = _ring(fake_cuda, inner=False)
    assert {s["name"] for s in ring} == {"engine.late",
                                         "engine.retrieve.dispatch"}
    assert read(Readings(None, ring, [], set()), params) is None


def test_cpu_retrieve_at_the_cells_widths():
    """On the CPU the spans are host spans: ``bytes`` is read, n_filter x
    (cap x (4 + m) + 4) a query at the cell's widths, and the stream
    readers give nothing."""
    from repro_torch.obs import trace
    cell = small_cell(CELL)
    cfg, mix = cell.config, cell.traffic
    data = planted.make_data(3, device=torch.device("cpu"), **{
        k: cfg[k] for k in ("n_docs", "cap", "min_len", "d", "n_centroids",
                            "m", "nbits")})
    tf = traffic.make(mix, data, 3, 1 / mix["pool_batches_per_s"],
                      cfg["engine"]["n_q"])
    system = cell.system.System(data, tf.plane, cfg, torch.device("cpu"))
    with trace.tracing() as tr:
        system(tf.batches[0])
        ring = tr.drain()
    r = Readings(None, ring, [], set())
    per_query = cfg["engine"]["n_filter"] * (cfg["cap"] * (4 + cfg["m"]) + 4)
    read, params = _metric("gather_bytes_per_query")
    assert read(r, params) == per_query
    for name in STREAM:
        read, params = _metric(name)
        assert read(r, params) is None
