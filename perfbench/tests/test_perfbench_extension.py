"""A configuration of other widths (m 32 sub-vectors, docs of up to 160
tokens), a cell of it on ``closed-b32`` and a per-layer metric that lists
only that cell, added to a copy of ``BENCHMARK.json`` and ``perfbench/`` as
new files and entries alone: the spec's checks take them, the other cells
keep their metrics, a CPU run of the new cell is correct to the bit, and a
size that departs from the configuration's ``published`` one without
``reduced`` naming it is refused."""
import copy
import json
import os
import shutil
import time

import pytest
import torch

from conftest import (PERFBENCH, REPO, bench, check_bench, check_cell,
                      config_faults, small_cell)
from harness import runner, spec

CONFIG = "emvb-m32-long"
CELL = "m32-long-b32"
METRIC = "dispatch_ms_m32"
SIZES = {"n_docs": 2_819_103, "cap": 160, "min_len": 100, "d": 128,
         "n_centroids": 1 << 18, "m": 32, "nbits": 8, "list_cap": 4096}


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=4)


def _add_config(repo, name, sizes, reduced=(), published=SIZES):
    """A configuration file and its BENCHMARK.json entry, new in
    ``repo``; the engine settings are the k = 1000 configuration's."""
    with open(os.path.join(PERFBENCH, "configs",
                           "emvb-msmarco-k1000.json")) as f:
        cfg = json.load(f)
    cfg.update(sizes, name=name, reduced=list(reduced),
               published=dict(published),
               source="a configuration of m = 32 and long docs, "
                      "for the benchmark's own tests")
    cfg.pop("assumed")
    rel = f"perfbench/configs/{name}.json"
    _write(os.path.join(repo, rel), cfg)
    b = bench(repo)
    entry = {"name": name, "source": cfg["source"], "file": rel,
             "reduced": list(reduced), "why": "m = 32: the Eq. 5/6 pass's "
             "general form and a 1 MiB LUT a query"}
    b["configs"].append(entry)
    _write(os.path.join(repo, "BENCHMARK.json"), b)
    return entry


@pytest.fixture
def extended(tmp_path):
    """A copy of the repo's benchmark with the configuration, its cell,
    the cell's limits and a per-layer metric of its own added."""
    repo = str(tmp_path / "repo")
    shutil.copytree(PERFBENCH, os.path.join(repo, "perfbench"),
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), repo)
    _add_config(repo, CONFIG, SIZES)
    root = os.path.join(repo, "perfbench")
    _write(os.path.join(root, "limits", CELL + ".json"),
           {"score_err": 0.00064, "topk_gap": 0.019})
    _write(os.path.join(root, "metrics", METRIC + ".json"),
           {"span": "engine.retrieve.dispatch"})
    with open(os.path.join(root, "metrics", METRIC + ".py"), "w") as f:
        f.write('"""dispatch_ms_m32: the host ms of retrieve\'s dispatch '
                'span."""\nfrom harness.readers import span_ms as read  '
                '# noqa: F401\n')
    b = bench(repo)
    b["workloads"].append({"name": CELL, "config": CONFIG,
                           "traffic": "closed-b32", "chips": 1,
                           "why": "batches of 32 at k 1000 over docs of "
                                  "100-160 tokens in 32 sub-vectors"})
    b["per_layer"].append({"name": METRIC, "unit": "ms", "better": "lower",
                           "source": "program_span",
                           "layer": "engine entry, host "
                                    "(core/engine.py::retrieve)",
                           "moves": "latency_p95_ms", "workloads": [CELL]})
    _write(os.path.join(repo, "BENCHMARK.json"), b)
    return repo


def test_added_cell_resolves_with_only_its_own_metric(extended):
    b = bench(extended)
    check_bench(b)
    for w in b["workloads"]:
        check_cell(w["name"], extended)
    for entry in b["configs"]:
        assert config_faults(entry, extended) == [], entry["name"]
    cell = spec.cell(CELL, extended)
    assert [m.entry["name"] for m in cell.per_layer] == [METRIC]
    assert cell.config["m"] == 32 and cell.config["cap"] == 160
    before = {m["name"] for m in bench()["per_layer"]}
    for w in bench()["workloads"]:
        assert {m.entry["name"] for m in
                spec.cell(w["name"], extended).per_layer} == before


def test_added_cell_is_correct_on_the_cpu(extended, tmp_path):
    cell = small_cell(CELL, extended)
    assert cell.config["m"] == 32
    r = runner.run_cell(cell, 7, 0.2, True, device=torch.device("cpu"),
                        t_start=time.perf_counter(),
                        out_dir=str(tmp_path / "out"))
    assert r["correct"] is True
    assert r["checks"]["score_err"]["value"] == 0.0
    assert r["checks"]["topk_gap"]["value"] == 0.0
    assert set(r["metrics"]) == {METRIC}


def _with(**changes):
    sizes = dict(SIZES)
    sizes.update(changes)
    return sizes


@pytest.mark.parametrize("sizes,reduced,published,refused", [
    (_with(m=16), (), SIZES, True),                   # a shape, unlisted
    (_with(cap=128), (), SIZES, True),
    (_with(n_docs=1_000_000), (), SIZES, True),       # a scale, unlisted
    (_with(n_docs=1_000_000), ("n_docs",), SIZES, False),  # listed, below
    (_with(n_docs=4_000_000), ("n_docs",), SIZES, True),   # listed, above
    (SIZES, ("list_cap",), SIZES, True),              # listed, not cut
    (_with(m=16), ("m",), SIZES, True),               # a shape is never cut
    (_with(d=100), (), _with(d=100), True),           # d % m != 0
    (_with(min_len=200), (), _with(min_len=200), True),    # min_len > cap
    (_with(nbits=10), (), _with(nbits=10), True),
    (_with(n_docs=40_000_000), (), _with(n_docs=40_000_000), True),
], ids=["m", "cap", "n_docs", "n_docs-reduced", "n_docs-above",
        "list_cap-unchanged", "m-reduced", "d-not-of-m", "min_len-above-cap",
        "nbits-10", "n_docs-past-2**25"])
def test_config_form_takes_only_what_reduced_cuts(extended, sizes, reduced,
                                                  published, refused):
    entry = _add_config(extended, "emvb-m32-cut", sizes, reduced, published)
    assert bool(config_faults(entry, extended)) is refused


def test_file_and_entry_state_one_reduced_list(extended):
    entry = _add_config(extended, "emvb-m32-cut",
                        _with(n_docs=1_000_000), ("n_docs",))
    other = copy.deepcopy(entry)
    other["reduced"] = []
    assert config_faults(entry, extended) == []
    assert config_faults(other, extended)
