"""The port's observability (``repro_torch.obs``): the tracer and the
metrics registry against tests/test_obs.py's contracts, and the serving
stack's telemetry against the reference's — the same span vocabulary in
the same order with the same attributes, the same metrics snapshot keys
and counters, and an exposition with the reference's metric families that
passes ``scripts/check_metrics_exposition.py``'s validator. ``explain`` is
not ported: asking ``repro_torch.obs`` for it raises AttributeError.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import build_index as ref_build_index
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.bitvector import Pred as RPred
from repro.data.synthetic import make_corpus
from repro.serving import RetrievalService as RefService
from repro_torch import obs
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore
from repro_torch.core.bitvector import Pred
from repro_torch.obs import trace
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving import (LatencyStats, MaintenancePolicy,
                                 MaintenanceRunner, RetrievalService)

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_spec = importlib.util.spec_from_file_location(
    "check_metrics_exposition",
    os.path.join(ROOT, "scripts", "check_metrics_exposition.py"))
_lint = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_lint)
validate_exposition = _lint.validate_exposition

KW = dict(nprobe=8, th=0.2, th_r=0.4, n_filter=128, n_docs=48, k=10,
          use_kernels=True)


@pytest.fixture(scope="module")
def obs_corpus():
    return make_corpus(5, n_docs=400, cap=24, min_len=8, n_queries=16,
                       n_topics=32)


@pytest.fixture(scope="module")
def timelines(obs_corpus, tmp_path_factory):
    """(reference timeline, the port's load of its save_timeline)."""
    c = obs_corpus
    rng = np.random.default_rng(7)
    preds = {"lang_en": rng.random(400) < 0.7, "recent": rng.random(400) < 0.4}
    idx0, m0 = ref_build_index(
        jax.random.PRNGKey(0), c.doc_embs[:200], c.doc_lens[:200],
        n_centroids=128, m=8, nbits=4, kmeans_iters=3,
        predicates={k: v[:200] for k, v in preds.items()})
    ref = rstore.ShardedTimeline.of((idx0, m0)).append(
        *rstore.new_generation(idx0, m0, c.doc_embs[200:], c.doc_lens[200:],
                               {k: v[200:] for k, v in preds.items()}))
    path = rstore.save_timeline(str(tmp_path_factory.mktemp("obs") / "tl"),
                                ref)
    return ref, tstore.load_timeline(path, device="cpu")


# ---------------------------------------------------------------------------
# Tracer: no-op contract, hierarchy, ring, export
# ---------------------------------------------------------------------------

def test_disabled_tracer_is_noop_singleton():
    assert trace.get_tracer() is trace.NOOP_TRACER
    assert trace.span("anything", attr=1) is trace.NOOP_SPAN
    assert trace.span("else") is trace.NOOP_SPAN
    with trace.span("x") as sp:
        assert sp is trace.NOOP_SPAN
        assert sp.set(foo=1) is trace.NOOP_SPAN
    assert trace.record("x", 0.1) is None


def test_noop_span_propagates_exceptions():
    with pytest.raises(RuntimeError, match="boom"):
        with trace.span("x"):
            raise RuntimeError("boom")


def test_tracing_scope_installs_and_restores():
    assert trace.get_tracer() is trace.NOOP_TRACER
    with obs.tracing() as t:
        assert trace.get_tracer() is t
        assert t.enabled
        with trace.span("inside"):
            pass
    assert trace.get_tracer() is trace.NOOP_TRACER
    assert [s["name"] for s in t.finished()] == ["inside"]


def test_span_hierarchy_ids():
    with obs.tracing() as t:
        with trace.span("root", a=1):
            with trace.span("child"):
                with trace.span("grandchild"):
                    pass
            trace.record("sibling", 0.005, b=2)
        with trace.span("root2"):
            pass
    by_name = {s["name"]: s for s in t.finished()}
    root, child, gc = (by_name[n] for n in ("root", "child", "grandchild"))
    assert root["parent_id"] is None
    assert root["trace_id"] == root["span_id"]
    assert child["parent_id"] == root["span_id"]
    assert gc["parent_id"] == child["span_id"]
    assert gc["trace_id"] == root["trace_id"]
    sib = by_name["sibling"]
    assert sib["parent_id"] == root["span_id"]
    assert sib["attrs"] == {"b": 2} and sib["duration_s"] == 0.005
    assert by_name["root2"]["trace_id"] != root["trace_id"]
    names = [s["name"] for s in t.finished()]
    assert names.index("grandchild") < names.index("child") \
        < names.index("root")
    assert root["attrs"] == {"a": 1}


def test_span_set_error_flag_and_injected_clock():
    now = [0.0]
    with obs.tracing(clock=lambda: now[0]) as t:
        with trace.span("work", planned=3) as sp:
            sp.set(done=2)
            now[0] += 0.5
            with trace.span("inner"):
                now[0] += 0.25
        try:
            with trace.span("fails"):
                raise ValueError("x")
        except ValueError:
            pass
    by_name = {s["name"]: s for s in t.finished()}
    assert by_name["work"]["attrs"] == {"planned": 3, "done": 2}
    assert by_name["fails"]["error"] is True
    assert "error" not in by_name["work"]
    assert by_name["inner"]["duration_s"] == pytest.approx(0.25)
    assert by_name["work"]["duration_s"] == pytest.approx(0.75)
    assert by_name["inner"]["start"] == pytest.approx(0.5)


def test_ring_drain_export_and_capacity(tmp_path):
    with obs.tracing(capacity=3) as t:
        for i in range(5):
            with trace.span(f"s{i}", arr=np.int32(i)):
                pass
    assert [s["name"] for s in t.finished()] == ["s2", "s3", "s4"]
    assert t.dropped == 2
    path = tmp_path / "spans.jsonl"
    assert t.export_jsonl(path) == 3
    assert [json.loads(ln)["name"] for ln in
            path.read_text().splitlines()] == ["s2", "s3", "s4"]
    assert len(t.drain()) == 3 and t.finished() == []
    with pytest.raises(ValueError, match="capacity"):
        trace.Tracer(capacity=0)


def test_explain_is_not_ported():
    """The name is kept from before ``explain`` was ported: it now holds
    that ``repro_torch.obs`` exports what the reference's does, with
    ``explain`` loaded on first access, and nothing else by that hook."""
    assert obs.explain.__name__ == "repro_torch.obs.explain"
    assert "explain" in obs.__all__
    assert set(obs.__all__) == set(robs.__all__)
    with pytest.raises(AttributeError, match="no_such"):
        obs.no_such


# ---------------------------------------------------------------------------
# Registry: instruments + Prometheus exposition format
# ---------------------------------------------------------------------------

def test_registry_counter_semantics():
    r = MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    c.inc()
    c.inc(2.5)
    assert c.value() == 3.5
    with pytest.raises(ValueError, match="_total"):
        r.counter("reqs", "bad name")
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    assert r.counter("reqs_total", "requests") is c
    with pytest.raises(ValueError):
        r.gauge("reqs_total", "now a gauge?")


def test_registry_gauge_labels_and_escaping():
    r = MetricsRegistry()
    g = r.gauge("temp", "temperature", label_names=("site",))
    g.set(1.5, site='a"b\\c\nd')
    text = r.exposition()
    assert validate_exposition(text) == []
    assert 'site="a\\"b\\\\c\\nd"' in text
    assert g.value(site='a"b\\c\nd') == 1.5
    with pytest.raises(ValueError):
        g.set(1.0)


def test_registry_histogram_and_summary():
    r = MetricsRegistry()
    h = r.histogram("sizes", "batch sizes", buckets=(1, 4, 16))
    for v in (1, 3, 5, 20):
        h.observe(v)
    ls = LatencyStats(window=64)
    for v in range(1, 11):
        ls.record(v / 1000)
    r.summary("lat_seconds", "latency", stats=ls)
    text = r.exposition()
    assert validate_exposition(text) == []
    for line in ('sizes_bucket{le="1"} 1', 'sizes_bucket{le="4"} 2',
                 'sizes_bucket{le="16"} 3', 'sizes_bucket{le="+Inf"} 4',
                 "sizes_count 4", 'lat_seconds{quantile="0.5"}',
                 "lat_seconds_count 10"):
        assert line in text
    assert r.snapshot()["lat_seconds"]["count"] == 10


# ---------------------------------------------------------------------------
# The serving stack's telemetry against the reference's
# ---------------------------------------------------------------------------

def _spans(tracer):
    """Each finished span as (name, parent's name, attrs)."""
    spans = tracer.finished()
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"]), s["attrs"])
            for s in spans]


def _workload(svc, c, filt):
    """Cold and warm query(), a filtered one, two submitted tickets, a
    staged swap and one maintenance pass."""
    q = np.asarray(c.queries[:4])
    svc.query(q)
    svc.query(q)
    svc.query(q, doc_filter=filt)
    svc.submit(c.queries[4][:20])
    svc.update_timeline(svc.timeline)       # staged behind the ticket
    svc.submit(c.queries[5])
    svc.flush()


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_service_telemetry_equals_reference(obs_corpus, timelines):
    c = obs_corpus
    ref_tl, port_tl = timelines
    # a clock that stands still: no deadline is missed in either service,
    # whatever the host's load
    ref = RefService(ref_tl, reng.EngineConfig(**KW), max_batch=4,
                     clock=lambda: 0.0)
    got = RetrievalService(port_tl, teng.EngineConfig(**KW), max_batch=4,
                           device="cpu", clock=lambda: 0.0)
    with robs.tracing() as rt:
        _workload(ref, c, RPred("recent"))
    with obs.tracing() as tt:
        _workload(got, c, Pred("recent"))
    # the port's vocabulary is the reference's plus the engine's phases
    # (trace.PORT_ONLY), which open inside engine.retrieve.dispatch and
    # hold no span of the reference's: without them, the two are equal
    want = _spans(rt)
    have = [s for s in _spans(tt) if s[0] not in trace.PORT_ONLY]
    assert [s[:2] for s in have] == [s[:2] for s in want]
    for (name, _, a), (_, _, b) in zip(have, want):
        if name == "batcher.queue_wait" or name.startswith("service.swap"):
            assert a.keys() == b.keys(), name
        else:
            assert a == b, name
    assert "engine.retrieve.dispatch" in {s[0] for s in have}
    spans = tt.finished()
    children = {}
    for s in spans:
        children.setdefault(s["parent_id"], []).append(s["name"])
    phases = {"engine.retrieve.dispatch": ["engine.candgen",
                                           "engine.prefilter", "engine.late"],
              "engine.candgen": ["engine.candgen.bitmap_wait"],
              "engine.late": ["engine.late.gather", "engine.late.pqinter"]}
    for s in spans:
        if s["name"] in phases:
            assert children[s["span_id"]] == phases[s["name"]], s["name"]
    n_dispatch = sum(s["name"] == "engine.retrieve.dispatch" for s in spans)
    assert sum(s["name"] in trace.PORT_ONLY for s in spans) == \
        len(trace.PORT_ONLY) * n_dispatch
    rs, ts = ref.stats(), got.stats()
    assert _keys(ts) == _keys(rs)
    for k in ("batches", "queries", "warm_queries", "cold_queries",
              "filtered_queries", "maintenance", "batcher", "generations",
              "cache", "timeline"):
        assert ts[k] == rs[k], k
    for k in ("latency", "warm_latency", "cold_latency"):
        assert ts[k]["count"] == rs[k]["count"]


def test_live_service_exposition_passes_lint(obs_corpus, timelines):
    """A live service's exposition, after traffic and a maintenance pass,
    passes the validator and carries the reference's metric families."""
    c = obs_corpus
    ref_tl, port_tl = timelines
    texts = []
    for svc, filt in (
            (RefService(ref_tl, reng.EngineConfig(**KW)), RPred("lang_en")),
            (RetrievalService(port_tl, teng.EngineConfig(**KW),
                              device="cpu"), Pred("lang_en"))):
        q = np.asarray(c.queries[:4])
        svc.query(q)
        svc.query(q)
        svc.query(q, doc_filter=filt)
        texts.append(svc.exposition())
    want, text = texts
    errors = validate_exposition(text)
    assert errors == [], "\n".join(errors)
    assert "emvb_queries_total 12" in text
    assert "emvb_cache_hits_total" in text
    assert "emvb_timeline_docs 400" in text
    assert 'emvb_generation_cache_hit_ratio{generation=' in text

    def families(t):
        return [ln for ln in t.splitlines() if ln.startswith("# ")]
    assert families(text) == families(want)

    svc = RetrievalService(port_tl, teng.EngineConfig(**KW), device="cpu")
    svc.query(np.asarray(c.queries[:4]))
    MaintenanceRunner(svc, MaintenancePolicy(merge_factor=4)).run_once()
    assert validate_exposition(svc.exposition()) == []
