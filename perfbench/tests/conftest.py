"""Shared set-up of the benchmark's tests: ``perfbench/`` and ``src/`` on
the path, and a cell of the real widths over a corpus small enough for the
CPU."""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PERFBENCH)
for p in (os.path.join(REPO, "src"), PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the emvb-msmarco widths over 3,000 docs and 512 centroids; IVF lists cut
# at 64 docs, so the cut is exercised
SMALL = {"n_docs": 3000, "n_centroids": 512, "list_cap": 64}
BUDGETS = {
    "msmarco-b32": {"n_filter": 128, "n_docs": 32, "k": 8},
    "k1000-b32": {"n_filter": 256, "n_docs": 128, "k": 128},
}
MIX = {"pool_batches_per_s": 8, "warmup_calls": 1, "check_batches": 2,
       "trace": {"wait_calls": 1, "warmup_calls": 1, "calls": 2}}
# a filtered mix over msmarco-b32, which no cell sends yet: the harness's
# predicate plane, its filter check and the program's filtered lane
FILTERED = {"msmarco-b32-filter1pct": "msmarco-b32"}
FILTER = {"predicates": 32, "pass_share": 0.2}   # enough docs at this size
CELLS = ["msmarco-b32", "k1000-b32", "msmarco-b32-filter1pct"]


def small_cell(name: str, **engine):
    """The cell ``name`` of BENCHMARK.json, or of ``FILTERED``, at the
    small size; ``engine`` overrides its engine settings."""
    from harness import spec
    base = FILTERED.get(name, name)
    cell = spec.cell(base, REPO)
    cfg = copy.deepcopy(cell.config)
    cfg.update(SMALL)
    cfg["engine"].update(BUDGETS[base], **engine)
    mix = copy.deepcopy(cell.traffic)
    mix.update(MIX)
    limits = dict(cell.limits)
    if name in FILTERED:
        mix["filter"] = dict(FILTER)
        limits["filter_fail"] = 0
    return cell._replace(name=name, config=cfg, traffic=mix, limits=limits)


@pytest.fixture
def cell_of():
    return small_cell
