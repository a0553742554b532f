"""Shared set-up of the benchmark's tests: ``perfbench/`` and ``src/`` on
the path, every cell of ``BENCHMARK.json`` at its configuration's widths
over a corpus small enough for the CPU, and the form a configuration file
has to have."""
import copy
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PERFBENCH)
for p in (os.path.join(REPO, "src"), PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# a configuration's widths over 3,000 docs and 512 centroids; IVF lists cut
# at 64 docs, so the cut is exercised
SMALL = {"n_docs": 3000, "n_centroids": 512, "list_cap": 64}
# the engine's budgets over the small corpus: each of k, n_docs and
# n_filter cut by this factor (see small_budgets)
BUDGET_CUT = 8
MIX = {"pool_batches_per_s": 8, "warmup_calls": 1, "check_batches": 2,
       "trace": {"wait_calls": 1, "warmup_calls": 1, "calls": 2}}
# a filtered mix over msmarco-b32, which no cell sends yet: the harness's
# predicate plane, its filter check and the program's filtered lane
FILTERED = {"msmarco-b32-filter1pct": "msmarco-b32"}
FILTER = {"predicates": 32, "pass_share": 0.2}   # enough docs at this size

# the keys of a configuration file that the runner, the control, the
# system (systems/emvb_retrieve.py) and the reference read
SIZES = ("n_docs", "cap", "min_len", "d", "n_centroids", "m", "nbits",
         "list_cap")
ENGINE = ("n_q", "nprobe", "th", "th_r", "n_filter", "n_docs", "k",
          "cs_dtype")
# sizes that give a vector's or a doc's shape: never cut, only the scale is
SHAPES = ("d", "m", "nbits", "cap", "min_len")
MAX_DOCS = 1 << 25   # the prefilter's int32 keys hold a doc id in 25 bits
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = [w["name"] for w in bench()["workloads"]] + list(FILTERED)


def small_budgets(engine: dict) -> dict:
    """The budgets of ``engine`` over the small corpus, by one rule for
    every cell: k, n_docs and n_filter each cut by ``BUDGET_CUT``, kept
    ordered ``n_filter > n_docs >= k >= 1`` and below the small corpus's
    docs, so that a cell of a larger k keeps the larger small k."""
    k = max(1, engine["k"] // BUDGET_CUT)
    n_docs = max(k, engine["n_docs"] // BUDGET_CUT)
    n_filter = max(n_docs + 1, engine["n_filter"] // BUDGET_CUT)
    if n_filter >= SMALL["n_docs"]:
        raise ValueError(f"n_filter {n_filter} over the small corpus")
    return {"n_filter": n_filter, "n_docs": n_docs, "k": k}


def small_cell(name: str, repo: str = REPO, **engine):
    """The cell ``name`` of ``repo``'s BENCHMARK.json, or of ``FILTERED``,
    at the small size; ``engine`` overrides its engine settings."""
    from harness import spec
    base = FILTERED.get(name, name)
    cell = spec.cell(base, repo)
    cfg = copy.deepcopy(cell.config)
    cfg.update(SMALL)
    cfg["engine"].update(small_budgets(cfg["engine"]), **engine)
    mix = copy.deepcopy(cell.traffic)
    mix.update(MIX)
    limits = dict(cell.limits)
    if name in FILTERED:
        mix["filter"] = dict(FILTER)
        limits["filter_fail"] = 0
    return cell._replace(name=name, config=cfg, traffic=mix, limits=limits)


def config_faults(entry: dict, repo: str = REPO) -> list:
    """What keeps the configuration of the BENCHMARK.json entry ``entry``
    from running as the file states it: a key the harness reads left out,
    sizes the program cannot take, or a size that departs from the
    source's ``published`` one unless ``reduced`` names it, as a cut."""
    with open(os.path.join(repo, entry["file"])) as f:
        cfg = json.load(f)
    faults = [f"no key {k}" for k in
              ("name", "system", "reference", "engine", "published",
               "reduced") + SIZES if k not in cfg]
    faults += [f"no engine key {k}" for k in ENGINE
               if k not in cfg.get("engine", {})]
    if faults:
        return faults
    if cfg["name"] != entry["name"]:
        faults.append(f"name {cfg['name']} under entry {entry['name']}")
    if cfg["reduced"] != entry["reduced"]:
        faults.append(f"reduced {cfg['reduced']} in the file, "
                      f"{entry['reduced']} in BENCHMARK.json")
    if cfg["d"] % cfg["m"]:
        faults.append(f"d {cfg['d']} not a multiple of m {cfg['m']}")
    if not 1 <= cfg["nbits"] <= 8:
        faults.append(f"nbits {cfg['nbits']} outside 1-8")
    if cfg["min_len"] > cfg["cap"]:
        faults.append(f"min_len {cfg['min_len']} above cap {cfg['cap']}")
    if cfg["n_docs"] > MAX_DOCS:
        faults.append(f"n_docs {cfg['n_docs']} above 2**25")
    pub = cfg["published"]
    for k in SIZES:
        if k not in pub:
            faults.append(f"published states no {k}")
        elif k in cfg["reduced"]:
            if k in SHAPES:
                faults.append(f"reduced names the shape {k}")
            elif not cfg[k] < pub[k]:
                faults.append(f"{k} {cfg[k]} in reduced but not below its "
                              f"published {pub[k]}")
        elif cfg[k] != pub[k]:
            faults.append(f"{k} {cfg[k]} departs from its published "
                          f"{pub[k]} and reduced does not name it")
    faults += [f"reduced names {k}, which is no size" for k in cfg["reduced"]
               if k not in SIZES]
    return faults


def check_bench(b: dict) -> None:
    """BENCHMARK.json's form: keys, names, units, bounds, a full check's
    time, and every metric tied to an end-to-end metric and to cells."""
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert "workloads" in m, m["name"]
        assert set(m["workloads"]) <= cells
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def check_cell(name: str, repo: str = REPO) -> None:
    """The cell ``name`` of ``repo``'s BENCHMARK.json found with all its
    parts: the end-to-end metrics it reports, setup_s among them, and just
    the per-layer metrics whose ``workloads`` list names it."""
    from harness import spec
    b = bench(repo)
    cell = spec.cell(name, repo)
    assert cell.config["name"] in {c["name"] for c in b["configs"]}
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {m["name"] for m in b["end_to_end"]
                   if name in m.get("workloads", [name])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all("workloads" in m for m in b["per_layer"])
    own = {m["name"] for m in b["per_layer"] if name in m["workloads"]}
    assert own and {m.entry["name"] for m in cell.per_layer} == own
    assert all(callable(m.read) for m in cell.per_layer)
    assert hasattr(cell.system, "System")
    assert hasattr(cell.reference, "Reference")
    assert hasattr(cell.loop, "Loop")
    assert set(cell.limits) >= {"score_err", "topk_gap"}
