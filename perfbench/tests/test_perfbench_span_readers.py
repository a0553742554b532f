"""The readers of the program's phase spans (``harness/span_readers.py``
and the five metrics that use it): each gives the mean of what it reads
from made-up spans, and nothing where the span or its ``stream_ms`` is
missing, as in a run of a program without these spans or on the CPU."""
import json
import os
import time

import pytest
import torch

from conftest import PERFBENCH, small_cell
from harness import runner, spec
from harness.readers import Readings

STREAM = {"candgen_stream_ms": "engine.candgen",
          "prefilter_stream_ms": "engine.prefilter",
          "late_stream_ms": "engine.late"}
NEW = sorted(STREAM) + ["bitmap_wait_ms", "postings_per_query"]


def _metric(name):
    base = os.path.join(PERFBENCH, "metrics", name)
    return (spec.load_module(base + ".py", f"test_metric_{name}").read,
            json.load(open(base + ".json")))


def _call(trace_id, batch, stream, wait_s, postings):
    """One call's spans as the engine leaves them after a drain, ids in the
    order the spans open: the dispatch span (the root, its id the trace's),
    the phases under it, the bitmap's wait under candgen."""
    def rec(name, offset, parent, duration_s, attrs, ms=None):
        r = {"name": name, "trace_id": trace_id, "span_id": trace_id + offset,
             "parent_id": parent, "start": 0.0, "duration_s": duration_s,
             "attrs": attrs}
        if ms is not None:
            r["stream_ms"] = ms
        return r
    return [rec("engine.candgen.bitmap_wait", 2, trace_id + 1, wait_s,
                {"postings": postings}),
            rec("engine.candgen", 1, trace_id, 0.02, {}, stream[0]),
            rec("engine.prefilter", 3, trace_id, 0.001, {}, stream[1]),
            rec("engine.late", 4, trace_id, 0.001, {}, stream[2]),
            rec("engine.retrieve.dispatch", 0, None, 0.021,
                {"batch": batch, "filtered": False})]


def _readings(spans):
    return Readings(None, spans, [], set())


SPANS = (_call(100, 32, (19.0, 2.0, 1.5), 0.015, 64_000)
         + _call(200, 32, (20.0, 2.5, 1.0), 0.017, 96_000)
         + _call(300, 16, (21.0, 3.0, 2.0), 0.019, 16_000))


@pytest.mark.parametrize("name,want", [
    ("candgen_stream_ms", 20.0), ("prefilter_stream_ms", 2.5),
    ("late_stream_ms", 1.5), ("bitmap_wait_ms", 17.0),
    ("postings_per_query", 176_000 / 80)])
def test_reader_gives_the_mean(name, want):
    read, params = _metric(name)
    assert read(_readings(SPANS), params) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_without_its_span(name):
    """A program without the phase spans leaves the dispatch span alone."""
    read, params = _metric(name)
    only_dispatch = [s for s in SPANS
                     if s["name"] == "engine.retrieve.dispatch"]
    assert read(_readings(only_dispatch), params) is None
    assert read(_readings([]), params) is None


@pytest.mark.parametrize("name", sorted(STREAM))
def test_stream_reader_gives_nothing_without_stream_ms(name):
    read, params = _metric(name)
    host_only = [{k: v for k, v in s.items() if k != "stream_ms"}
                 for s in SPANS]
    assert read(_readings(host_only), params) is None
    # a span without stream_ms beside ones with it is left out of the mean
    mixed = host_only[:5] + SPANS[5:]
    assert read(_readings(mixed), params) == pytest.approx(
        {"candgen_stream_ms": 20.5, "prefilter_stream_ms": 2.75,
         "late_stream_ms": 1.5}[name])


def test_postings_reader_needs_the_calls_batch():
    read, params = _metric("postings_per_query")
    no_batch = [dict(s, attrs={}) if s["name"] == "engine.retrieve.dispatch"
                else s for s in SPANS]
    assert read(_readings(no_batch), params) is None
    no_postings = [dict(s, attrs={}) if s["name"] ==
                   "engine.candgen.bitmap_wait" else s for s in SPANS]
    assert read(_readings(no_postings), params) is None


def test_postings_reader_finds_each_calls_own_dispatch():
    """In a service, the dispatch spans sit under the service's spans, one
    trace holds a dispatch for each generation, and ids are not trace ids:
    each wait's postings go with the batch of the dispatch above it."""
    gens = []
    for i, (batch, postings) in enumerate([(4, 4_000), (2, 3_000)]):
        call = _call(10 + 10 * i, batch, (1.0, 1.0, 1.0), 0.001, postings)
        for s in call:
            s["trace_id"] = 1
        call[-1]["parent_id"] = 2     # the dispatch under the miss lane
        gens += call
    service = [{"name": "service.miss_execute", "trace_id": 1, "span_id": 2,
                "parent_id": 1, "start": 0.0, "duration_s": 0.01,
                "attrs": {}},
               {"name": "service.flush", "trace_id": 1, "span_id": 1,
                "parent_id": None, "start": 0.0, "duration_s": 0.02,
                "attrs": {"batch": 99}}]
    read, params = _metric("postings_per_query")
    assert read(_readings(gens + service), params) == pytest.approx(
        7_000 / 6, rel=1e-12)
    # a wait with no dispatch above it counts no queries
    orphan = [dict(s, parent_id=None) if s["name"] ==
              "engine.candgen.bitmap_wait" else s for s in gens]
    assert read(_readings(orphan + service), params) is None


def test_traced_cpu_run_reports_the_host_readings(tmp_path):
    """On the CPU the phase spans are host spans: the bitmap's wait and
    its postings are read, the stream times are left out."""
    r = runner.run_cell(small_cell("msmarco-b32"), 5, 0.2, True,
                        device=torch.device("cpu"),
                        t_start=time.perf_counter(), out_dir=str(tmp_path))
    assert r["correct"] is True
    m = r["metrics"]
    assert m["bitmap_wait_ms"]["value"] > 0
    assert m["bitmap_wait_ms"]["unit"] == "ms"
    assert m["postings_per_query"]["value"] > 0
    assert m["postings_per_query"]["unit"] == "entries"
    assert not set(STREAM) & set(m)
    assert "dispatch_ms" in m
