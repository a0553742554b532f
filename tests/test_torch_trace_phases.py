"""The port's phase spans inside ``retrieve`` (``repro_torch.obs.trace``,
``repro_torch.core.engine``): ``engine.candgen`` (with the host's wait at
the candidate bitmap, ``engine.candgen.bitmap_wait``, inside it),
``engine.prefilter`` and ``engine.late`` under ``engine.retrieve.dispatch``
on every lane, and inside ``engine.late`` on the fused lane the survivor
gathers (``engine.late.gather``, with the ``bytes`` they write) and the
kernel (``engine.late.pqinter``); nothing when tracing is off; the same
results either way; the bitmap's ``postings`` count; the spans in a
``torch.profiler`` trace;
and ``stream_ms`` read from the CUDA events only when the ring is read
(the events faked here; ``tests/test_torch_cuda.py`` reads real ones)."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import bitvector
from repro_torch.core import engine as teng
from repro_torch.core import plaid
from repro_torch.data import synthetic
from repro_torch.obs import trace

WIDTHS = dict(n_docs=600, cap=16, min_len=4, d=32, n_centroids=64, m=4,
              nbits=4, list_cap=None)
ENGINE = dict(n_q=8, nprobe=4, th=0.4, th_r=0.5, n_filter=64, n_docs=32,
              k=10)
LANES = {
    "fused": dict(use_kernels=True),
    "unfused": dict(use_kernels=True, fused_prefilter=False,
                    fused_late_interaction=False),
    "compact": dict(use_kernels=True, candidate_mode="compact",
                    cand_cap=128),
    "compact_unfused": dict(use_kernels=True, candidate_mode="compact",
                            cand_cap=128, fused_prefilter=False,
                            fused_late_interaction=False),
    "reference_math": dict(use_kernels=False),
}
PHASES = ["engine.candgen", "engine.prefilter", "engine.late"]
# the order spans finish in: innermost first
ORDER = ["engine.candgen.bitmap_wait", "engine.candgen", "engine.prefilter",
         "engine.late", "engine.retrieve.dispatch"]
# inside engine.late on the fused late-interaction lane only
LATE = ["engine.late.gather", "engine.late.pqinter"]
FUSED_LATE = {"fused", "compact"}


def _order(lane):
    """The spans of one ``retrieve`` on ``lane``, in the order they
    finish."""
    if lane not in FUSED_LATE:
        return ORDER
    at = ORDER.index("engine.late")
    return ORDER[:at] + LATE + ORDER[at:]


@pytest.fixture(scope="module")
def planted():
    index, _ = synthetic.make_packed_index(0, device="cpu", **WIDTHS)
    q, _ = synthetic.make_queries(index, 1, 5, ENGINE["n_q"])
    # two terms of the second query and one of the fourth masked
    qm = torch.ones(q.shape[:2], dtype=torch.bool)
    qm[1, -2:] = False
    qm[3, 0] = False
    return index, q, qm


def _cfg(lane):
    return teng.EngineConfig(**ENGINE, **LANES[lane])


def _retrieve(planted, lane):
    index, q, qm = planted
    return teng.retrieve(index, q, _cfg(lane), qm, device="cpu")


def test_disabled_tracing_emits_nothing(planted, tmp_path):
    """Off (the default), every span form is the no-op singleton, and a
    ``retrieve`` under a recording profiler leaves no span of its own."""
    assert trace.get_tracer() is trace.NOOP_TRACER
    for sp in (trace.span("engine.candgen"),
               trace.span("engine.candgen", device=torch.device("cpu")),
               trace.span("engine.late", device=torch.device("cuda"),
                          batch=2),
               trace.span("engine.prefilter", torch.device("cuda"))):
        assert sp is trace.NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _retrieve(planted, "fused")
    path = tmp_path / "off.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert not names & set(ORDER + LATE)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_phase_spans_nest_under_dispatch(planted, lane):
    with obs.tracing() as tr:
        _retrieve(planted, lane)
    spans = tr.finished()
    assert [s["name"] for s in spans] == _order(lane)
    by_name = {s["name"]: s for s in spans}
    dispatch = by_name["engine.retrieve.dispatch"]
    for name in PHASES:
        assert by_name[name]["parent_id"] == dispatch["span_id"], name
        assert by_name[name]["trace_id"] == dispatch["trace_id"], name
    assert by_name["engine.candgen.bitmap_wait"]["parent_id"] == \
        by_name["engine.candgen"]["span_id"]
    # the unfused lanes open neither of the late phase's inner spans
    for name in LATE if lane in FUSED_LATE else ():
        assert by_name[name]["parent_id"] == \
            by_name["engine.late"]["span_id"], name
    # host spans on the CPU: no device, no stream time
    assert all("stream_ms" not in s for s in spans)
    starts = [by_name[n]["start"] for n in PHASES]
    assert starts == sorted(starts)
    if lane in FUSED_LATE:
        late = [by_name[n]["start"] for n in ["engine.late"] + LATE]
        assert late == sorted(late)


@pytest.mark.parametrize("lane", sorted(FUSED_LATE))
def test_gather_bytes_are_what_the_gathers_write(planted, lane, monkeypatch):
    """``bytes`` of ``engine.late.gather`` is the ``nbytes`` of the codes,
    residual codes and lengths handed to the phase 3-4 kernel, and
    ``batch x n_filter x (cap x (4 + m) + 4)`` by the shapes."""
    index, q, _ = planted
    seen = []
    pqinter = teng.ops.pqinter_batched

    def spy(cs_t, lut, codes, res_codes, lens, *args, **kwargs):
        seen.append(codes.nbytes + res_codes.nbytes + lens.nbytes)
        return pqinter(cs_t, lut, codes, res_codes, lens, *args, **kwargs)
    monkeypatch.setattr(teng.ops, "pqinter_batched", spy)
    with obs.tracing() as tr:
        _retrieve(planted, lane)
    (gather,) = [s for s in tr.finished()
                 if s["name"] == "engine.late.gather"]
    n_docs, cap, m = index.res_codes.shape
    assert gather["attrs"] == {"bytes": seen[0]}
    assert seen == [q.shape[0] * ENGINE["n_filter"] * (cap * (4 + m) + 4)]


@pytest.mark.parametrize("lane", sorted(LANES))
def test_results_equal_with_tracing_on_and_off(planted, lane):
    off = _retrieve(planted, lane)
    with obs.tracing():
        on = _retrieve(planted, lane)
    assert torch.equal(on.doc_ids, off.doc_ids)
    assert torch.equal(on.scores.view(torch.int32),
                       off.scores.view(torch.int32))


def _postings_by_hand(ivf, ivf_lens, probe_ids, n_docs):
    """Every (row, term, probe, list slot) entry the bitmap's scatter
    writes: each live probe's list up to its length, less ids at or above
    ``n_docs``; duplicates across terms count."""
    ivf, lens = ivf.numpy(), ivf_lens.numpy()
    n_c = ivf.shape[0]
    count = 0
    for p in probe_ids.reshape(-1).tolist():
        if p < n_c:
            count += int((ivf[p, :lens[p]] < n_docs).sum())
    return count


@pytest.mark.parametrize("lane", ["fused", "unfused", "compact"])
def test_postings_counts_probed_list_entries(planted, lane):
    index, q, qm = planted
    probes = bitvector.masked_topk_centroids(
        teng.centroid_scores(q, index.centroids), ENGINE["th"],
        ENGINE["nprobe"], qm)
    want = _postings_by_hand(index.ivf, index.ivf_lens, probes,
                             index.codes.shape[0])
    with obs.tracing() as tr:
        _retrieve(planted, lane)
    (wait,) = [s for s in tr.finished()
               if s["name"] == "engine.candgen.bitmap_wait"]
    assert wait["attrs"] == {"postings": want}
    assert 0 < want < q.shape[0] * q.shape[1] * ENGINE["nprobe"] * \
        index.ivf.shape[1]


def test_postings_leaves_out_sentinels_and_ids_past_the_corpus():
    """Masked terms (probe id n_c) add nothing; list entries at or above
    n_docs and slots past a list's length are not postings."""
    ivf = torch.tensor([[0, 1, 5, 9], [2, 3, 0, 0], [7, 1, 1, 1]],
                       dtype=torch.int32)
    lens = torch.tensor([4, 2, 1], dtype=torch.int32)
    probes = torch.tensor([[[0, 1], [3, 3], [2, 0]],
                           [[1, 1], [2, 2], [3, 3]]], dtype=torch.int32)
    with obs.tracing() as tr:
        bitmap = teng.candidate_bitmap(
            ivf, lens, probes, 6, trace.span("engine.candgen.bitmap_wait"))
    (wait,) = tr.finished()
    want = _postings_by_hand(ivf, lens, probes, 6)
    assert want == 3 + 2 + 0 + 3 + 2 + 2 + 0
    assert wait["attrs"] == {"postings": want}
    assert bitmap.tolist() == [[True, True, True, True, False, True],
                               [False, False, True, True, False, False]]


def test_bitmap_outside_the_engine_opens_no_span(planted):
    """``candidate_bitmap`` opens only the span it is handed: PLAID's phase
    1, which calls it outside any engine span, leaves no span."""
    index, q, _ = planted
    with obs.tracing() as tr:
        _, bitmap = plaid.phase_retrieval(index, q, plaid.PlaidConfig(
            n_q=ENGINE["n_q"], nprobe=ENGINE["nprobe"]), device="cpu")
        teng.candidate_bitmap(index.ivf, index.ivf_lens,
                              torch.zeros(1, 2, 1, dtype=torch.int32),
                              index.codes.shape[0])
    assert bitmap.any() and tr.finished() == []


def _annotations(path):
    """The chrome trace's user annotations named as the engine's spans:
    (name, start, end), by start."""
    events = json.load(open(path))["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in ORDER + LATE), key=lambda e: e[1])


@pytest.mark.parametrize("lane", ["fused", "unfused", "compact"])
def test_spans_land_in_the_profiler_trace(planted, lane, tmp_path):
    with obs.tracing() as tr:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _retrieve(planted, lane)
    path = tmp_path / "on.json"
    prof.export_chrome_trace(str(path))
    got = _annotations(path)
    assert sorted(n for n, _, _ in got) == sorted(
        s["name"] for s in tr.finished())
    iv = {n: (s, e) for n, s, e in got}

    def inside(child, parent):
        return iv[parent][0] <= iv[child][0] and iv[child][1] <= iv[parent][1]
    for name in PHASES:
        assert inside(name, "engine.retrieve.dispatch"), name
    assert inside("engine.candgen.bitmap_wait", "engine.candgen")
    assert iv["engine.candgen"][1] <= iv["engine.prefilter"][0]
    assert iv["engine.prefilter"][1] <= iv["engine.late"][0]
    if lane in FUSED_LATE:
        for name in LATE:
            assert inside(name, "engine.late"), name
        assert iv["engine.late.gather"][1] <= iv["engine.late.pqinter"][0]
    else:
        assert not set(LATE) & set(iv)


def test_no_profiler_range_when_no_profiler_records(planted, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with obs.tracing() as tr:
        _retrieve(planted, "fused")
    assert [s["name"] for s in tr.finished()] == _order("fused")


class _FakeEvent:
    """A CUDA event's timing surface on the CPU: ``record`` stamps a
    counter, ``synchronize`` counts host waits."""

    ticks, waits = 0, 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        assert stream == "stream"
        _FakeEvent.ticks += 1
        self.at = _FakeEvent.ticks

    def synchronize(self):
        _FakeEvent.waits += 1

    def elapsed_time(self, end):
        return 0.5 * (end.at - self.at)


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(_FakeEvent, "ticks", 0)
    monkeypatch.setattr(_FakeEvent, "waits", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    return torch.device("cuda")


def test_stream_ms_is_read_only_when_the_ring_is_read(fake_cuda, tmp_path):
    with obs.tracing() as tr:
        with trace.span("outer", device=fake_cuda):
            with trace.span("inner", device=fake_cuda, batch=3):
                pass
            with trace.span("host"):
                pass
        # the spans are closed and no host wait has happened
        assert _FakeEvent.waits == 0
        assert all("stream_ms" not in s for s in tr._spans)
        spans = {s["name"]: s for s in tr.finished()}
    assert _FakeEvent.waits == 2
    # events: outer 1 .. 4, inner 2 .. 3
    assert spans["outer"]["stream_ms"] == 1.5
    assert spans["inner"]["stream_ms"] == 0.5
    assert spans["inner"]["attrs"] == {"batch": 3}
    assert "stream_ms" not in spans["host"]
    # read once: a second read and the export wait no more
    assert tr.export_jsonl(tmp_path / "t.jsonl") == 3
    assert [json.loads(ln).get("stream_ms") for ln in
            open(tmp_path / "t.jsonl")] == [0.5, None, 1.5]
    assert [s.get("stream_ms") for s in tr.drain()] == [0.5, None, 1.5]
    assert _FakeEvent.waits == 2


def test_stream_timed_spans_past_the_ring_are_dropped(fake_cuda):
    with obs.tracing(capacity=2) as tr:
        for i in range(5):
            with trace.span(f"s{i}", device=fake_cuda):
                pass
        assert len(tr._timed) == 2
        got = tr.drain()
    assert [s["name"] for s in got] == ["s3", "s4"]
    assert [s["stream_ms"] for s in got] == [0.5, 0.5]
    assert tr.dropped == 3 and _FakeEvent.waits == 2


def test_stream_timed_span_records_its_end_when_the_body_raises(fake_cuda):
    with obs.tracing() as tr:
        with pytest.raises(ValueError):
            with trace.span("boom", device=fake_cuda):
                raise ValueError("x")
    (rec,) = tr.finished()
    assert rec["error"] is True and rec["stream_ms"] == 0.5


def test_port_only_names_are_the_engine_phases():
    assert set(trace.PORT_ONLY) == \
        set(ORDER + LATE) - {"engine.retrieve.dispatch"}
    # the benchmark's range labels are not span names: a span of one of
    # those names would be read as the range
    labels = {"engine.centroid_scores", "bitvector.masked_topk_centroids",
              "engine.candidate_bitmap", "engine._query_lut",
              "engine._transposed", "ops.prefilter_batched",
              "ops.pqinter_batched"}
    assert not labels & set(trace.PORT_ONLY)

