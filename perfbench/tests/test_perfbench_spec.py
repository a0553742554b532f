"""BENCHMARK.json's form (keys, names, units, bounds, a full check's time),
every cell and metric of it found by name, and every configuration file of
its form (``conftest.config_faults``): the checks hold a cell and a
configuration by their form, so that a new one needs no edit here."""
import json
import os

import pytest

from conftest import (PERFBENCH, REPO, bench, check_bench, check_cell,
                      config_faults)

BENCH = bench()


def test_keys_and_limits():
    check_bench(BENCH)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(name):
    check_cell(name, REPO)


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
    assert config_faults(entry, REPO) == []
