"""A run of the harness past its look for a chip, on the CPU at the small
size, with the timed path broken underneath: ``correct`` has to come out
false for each fault a retrieval cell can have. (A state left unchanged
and an exchange between chips left out belong to training and to cells
on several chips; these cells have neither.)"""
import time

import pytest
import torch

from conftest import CELLS, small_cell
from harness import runner


def _run(name):
    return runner.run_cell(small_cell(name), 3, 0.2, False,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter(), out_dir="")


def _half_batch(monkeypatch):
    """Half of each batch left out: the first half's answers served for
    the whole batch."""
    from repro_torch.core import engine
    real = engine.retrieve

    def half(index, queries, cfg, *a, **k):
        h = queries.shape[0] // 2
        res = real(index, queries[:h], cfg, *a, **k)
        return engine.RetrievalResult(res.scores.repeat(2, 1),
                                      res.doc_ids.repeat(2, 1))
    monkeypatch.setattr(engine, "retrieve", half)


def _altered_answer(monkeypatch):
    """An answer altered where it is made: the late-interaction kernel
    hands back its second position in place of its first."""
    from repro_torch.kernels import ops
    real = ops.pqinter_batched

    def altered(*a, **k):
        scores, pos, sel2, sbar = real(*a, **k)
        pos = pos.clone()
        pos[:, 0] = pos[:, 1]
        return scores, pos, sel2, sbar
    monkeypatch.setattr(ops, "pqinter_batched", altered)


def _filter_dropped(monkeypatch):
    """The filter left out: no plan in the prefilter, no verdicts in
    phases 3-4."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    real = ops.prefilter_batched

    def unfiltered(*a, plan=None, **k):
        return real(*a, **k)
    monkeypatch.setattr(ops, "prefilter_batched", unfiltered)
    monkeypatch.setattr(engine, "_doc_pass", lambda index, cfg: None)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_half_batch, _altered_answer],
                         ids=["half_batch", "altered_answer"])
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(name)["correct"] is False


def test_filter_left_out_makes_the_run_incorrect(monkeypatch):
    _filter_dropped(monkeypatch)
    r = _run("msmarco-b32-filter1pct")
    assert r["correct"] is False
    assert r["checks"]["filter_fail"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    r = runner.run_cell(small_cell(name), 4, 0.2, True,
                        device=torch.device("cpu"),
                        t_start=time.perf_counter(), out_dir=str(tmp_path))
    assert r["correct"] is True
    assert r["checks"]["score_err"]["value"] == 0.0
    assert r["checks"]["topk_gap"]["value"] == 0.0
    assert "dispatch_ms" in r["metrics"]
    assert (tmp_path / f"{name}.seed4.trace.json").exists()
