"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric; everything else sits in files of their own under
``perfbench/``, found by those names:

* ``configs/<file>``: a configuration's sizes, engine and the modules of
  its system (``systems/<system>.py``) and plain reference
  (``references/<reference>.py``);
* ``traffic/<traffic>.json``: a mix's parameters (``harness/traffic.py``),
  and ``loops/<loop>.py``, the loop its ``loop`` key names, which sends
  its batches and reads the end-to-end metrics;
* ``metrics/<metric>.json`` and ``metrics/<metric>.py``: a per-layer
  metric's parameters and its reader;
* ``limits/<cell>.json``: the limit of each number the cell's check
  compares (``harness/check.py``).

A later cell or metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

from . import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


class Metric(NamedTuple):
    entry: dict      # its BENCHMARK.json entry
    params: dict     # metrics/<name>.json
    read: object     # metrics/<name>.py's read(readings, params)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # BENCHMARK.json entries
    per_layer: list      # Metric
    limits: dict
    system: object       # module with System
    reference: object    # module with Reference
    loop: object         # module with Loop


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark, loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def cell(name: str, repo: str = REPO) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with all its parts."""
    bench = _json(os.path.join(repo, "BENCHMARK.json"))
    root = os.path.join(repo, "perfbench")
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = _json(os.path.join(repo, cfg_entry["file"]))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if not _applies(m, name, reported):
            continue
        base = os.path.join(root, "metrics", m["name"])
        per_layer.append(Metric(m, _json(base + ".json"), load_module(
            base + ".py", f"perfbench_metric_{m['name']}").read))
    mix = traffic.load(traffic.path_of(root, wl["traffic"]))
    return Cell(
        name, wl["chips"], config, mix,
        e2e, per_layer, _json(os.path.join(root, "limits", name + ".json")),
        load_module(os.path.join(root, "systems", config["system"] + ".py"),
                    f"perfbench_system_{config['system']}"),
        load_module(os.path.join(root, "references",
                                 config["reference"] + ".py"),
                    f"perfbench_reference_{config['reference']}"),
        load_module(os.path.join(root, "loops", mix["loop"] + ".py"),
                    f"perfbench_loop_{mix['loop']}"))
