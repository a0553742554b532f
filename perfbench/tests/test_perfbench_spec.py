"""BENCHMARK.json's form (keys, names, units, bounds, a full check's time)
and every cell and metric of it found by name."""
import json
import os
import re

import pytest

from conftest import PERFBENCH, REPO

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(name):
    from harness import spec
    cell = spec.cell(name, REPO)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert {m["name"] for m in cell.end_to_end} == \
        {"qps", "latency_p95_ms", "peak_mem_gb", "setup_s"}
    assert {m.entry["name"] for m in cell.per_layer} == \
        {m["name"] for m in BENCH["per_layer"]}
    assert all(callable(m.read) for m in cell.per_layer)
    assert hasattr(cell.system, "System")
    assert hasattr(cell.reference, "Reference")
    assert hasattr(cell.loop, "Loop")
    assert set(cell.limits) >= {"score_err", "topk_gap"}


@pytest.mark.parametrize("mix", sorted(
    f[:-5] for f in os.listdir(os.path.join(PERFBENCH, "traffic"))
    if f.endswith(".json")))
def test_mix_names_a_loop_of_its_own_file(mix):
    from harness import spec, traffic
    params = traffic.load(traffic.path_of(PERFBENCH, mix))
    loop = spec.load_module(
        os.path.join(PERFBENCH, "loops", params["loop"] + ".py"), "loop")
    assert callable(loop.Loop)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_ranges_name_functions_of_the_program(metric):
    import importlib
    params = json.load(open(os.path.join(PERFBENCH, "metrics",
                                         metric + ".json")))
    for label, target in params.get("ranges", {}).items():
        mod, attr = target.split(":")
        assert callable(getattr(importlib.import_module(mod), attr)), label


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_sizes(entry):
    cfg = json.load(open(os.path.join(REPO, entry["file"])))
    assert cfg["name"] == entry["name"] and entry["reduced"] == []
    assert (cfg["n_docs"], cfg["cap"], cfg["d"], cfg["n_centroids"],
            cfg["m"], cfg["nbits"]) == (8_841_823, 80, 128, 1 << 18, 16, 8)
