#!/usr/bin/env python3
"""The Eq. 5/6 pass of two trees of the port on one card, in turns.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_eq56_pass.py OTHER_TREE [--runs 2]

OTHER_TREE is an unpacked copy of another commit (``git archive <commit> |
tar -x -C <dir>``, in a directory that .gitignore lists), typically the
parent. Each run is a process of its own with one tree's ``src`` first on
``sys.path``, in the order other, this, this, other, ... (``--runs`` of
each); it builds that tree's kernels, the full-width planted emvb-msmarco
index and 32 planted queries (``chip_smoke.py``'s widths and config), and
at B = 32 and B = 1 under the default config (n_filter 1,024, n_docs 256)
and fig9's post-filter lane (n_filter 20,000, n_docs = k = 10,000), each
also with the filter phase's 1 % predicate (``doc_filter``: most of
pqinter's phase-3 slots are then fillers), times ``ops.pqinter_batched``
on the prefilter's survivors (``chip_smoke.hold_phases``) and, unfiltered,
``ops.pqscore_batched`` on pqinter's phase-3 winners: the median ms of 10
calls (CUDA events, L2 flushed) and the device ms of each ``__global__``
pass (torch.profiler), with this tree's ``chip_smoke.py`` helpers. Both
trees must return the same bits. This tree also reports the Eq. 5/6 plan
of each case and pqscore's device ms with the schedule's runs a query
overridden (``--sweep`` values; 0 is the rule's choice), the measurements
behind the rule in ``csrc/doc_math.cuh``. It prints one JSON line per case
beside the card's ``nvidia-smi`` name and power limit, and keeps every run
in ``chiprun_out/eq56_pass.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
BATCHES = (32, 1)
BUDGETS = {"default": dict(n_filter=1024, n_docs=256, k=100),
           "fig9": dict(n_filter=20_000, n_docs=10_000, k=10_000)}
# config -> (budget, the filter phase's 1 % predicate or not)
CONFIGS = {"default": ("default", False), "fig9": ("fig9", False),
           "default_filter1pct": ("default", True),
           "fig9_filter1pct": ("fig9", True)}


def _digest(xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _event_ms(fn, n: int = 10) -> float:
    """Median device ms of one call of fn, each call timed by CUDA events
    after an L2 flush."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    times = []
    for _ in range(n + 2):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[2:])


def one(tree: str, out: str, sweep: list) -> None:
    """One run in this process: ``tree``'s port timed as the module note
    says; the record goes to ``out``."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import pqscore as kps
    this = os.path.abspath(tree) == ROOT
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    index, _ = synthetic.make_packed_index(0, min_len=cs.MIN_LEN, device=dev,
                                           **cs.WIDTHS)
    queries, _ = synthetic.make_queries(index, 1, 32, cs.ENGINE["n_q"])
    names = tuple(cs.FILTER_PREDICATES)
    index = index._replace(pred_words=cs.predicate_words(
        index.codes.shape[0], dict(enumerate(cs.FILTER_PREDICATES.values())),
        1, dev))
    plan = bitvector.compile_filter(bitvector.Pred("p1"), names)
    rec = {"src": ops.__file__}
    for name, (budget, filtered) in CONFIGS.items():
        cfg = teng.EngineConfig(**dict(cs.ENGINE, **BUDGETS[budget]),
                                use_kernels=True,
                                doc_filter=plan if filtered else None)
        for nb in BATCHES:
            q = queries[:nb]
            h = cs.hold_phases(index, q, cfg, plain_step=0)
            surv, dp, sel1 = h["operands"], h["s1_pass"], h["sel1"]
            tail = (cfg.th_r, cfg.n_docs, cfg.k)

            def pqi():
                return ops.pqinter_batched(*surv, *tail, doc_pass=dp)
            got = pqi()
            runs_of = [("pqinter", pqi, got, surv)]
            win = None
            if not filtered:
                rows = torch.gather(sel1, 1, got[2].long())
                win = teng._survivor_operands(index, h["cs"], h["lut"], rows)

                def pqs():
                    return (ops.pqscore_batched(*win, cfg.th_r),)
                got_s = pqs()
                runs_of.append(("pqscore", pqs, got_s, win))
            torch.cuda.synchronize()
            for kern, fn, res, ops_ in runs_of:
                pass_ms, launches = cs._passes(fn, kern)
                r = {"ms": _event_ms(fn), "pass_ms": pass_ms,
                     "device_ms": None if pass_ms is None
                     else sum(pass_ms.values()),
                     "pass_launches": launches, "sha256": _digest(res)}
                if this:
                    r["eq56_plan"] = cs.eq56_plan_of(kern, ops_, cfg.n_docs)
                rec[f"{name}_b{nb}_{kern}"] = r
            if this and win is not None:
                cs_t, lut_w, codes, res_w, lens = win
                n_q, m, ksub = lut_w.shape[1:]
                terms = kpq.lut_terms("pqscore", n_q, m, ksub)
                lut2 = kpq.flat_lut(lut_w, terms)
                want = got_s[0]
                rs = {}
                for runs in sweep:
                    def fn(runs=runs):
                        return kps._launch(cs_t, lut2, terms, codes, res_w,
                                           lens, None, cfg.th_r, m, ksub,
                                           runs=runs)
                    if not torch.equal(fn().view(torch.int32),
                                       want.view(torch.int32)):
                        raise AssertionError(f"runs {runs} changed bits")
                    pass_ms, _ = cs._passes(lambda: (fn(),), "pqscore")
                    rs[runs] = {"device_ms": None if pass_ms is None
                                else sum(pass_ms.values()),
                                "plan": kps.plan(cs_t, codes, res_w, n_q, m,
                                                 ksub, runs)}
                rec[f"{name}_b{nb}_pqscore"]["runs_sweep"] = rs
            del h, surv, win
            torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(rec, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--sweep", default="0,1,2,4,8,16,32,64")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sweep = [int(v) for v in a.sweep.split(",") if v]
    if a.one:
        one(a.one, a.out, sweep)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    trees = {"other": os.path.abspath(a.other), "this": ROOT}
    order = [t for _ in range(a.runs) for t in ("other", "this", "this",
                                                  "other")][:2 * a.runs]
    runs = {"other": [], "this": []}
    for i, name in enumerate(order):
        path = os.path.join(OUT, f"eq56_pass_{name}_{i}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "x",
                        "--one", trees[name], "--out", path, "--sweep",
                        a.sweep], check=True)
        with open(path) as f:
            runs[name].append(json.load(f))
    summary = {"nvidia_smi": smi, "order": order, "runs": runs, "cases": {}}
    for key in runs["this"][0]:
        if key == "src":
            continue
        digests = {r[key]["sha256"] for rs in runs.values() for r in rs}
        case = {"nvidia_smi": smi, "case": key,
                "results_equal": len(digests) == 1}
        for name, rs in runs.items():
            case[name] = {m: statistics.median(r[key][m] for r in rs)
                          for m in ("ms", "device_ms")
                          if all(r[key][m] is not None for r in rs)}
            case[name]["pass_ms"] = rs[-1][key]["pass_ms"]
        last = runs["this"][-1][key]
        case["eq56_plan"] = last.get("eq56_plan")
        if "runs_sweep" in last:
            case["runs_sweep"] = {
                r: {"device_ms": v["device_ms"], "runs": v["plan"]["runs"],
                    "clusters": v["plan"]["clusters"]}
                for r, v in last["runs_sweep"].items()}
        summary["cases"][key] = case
        print(json.dumps(case), flush=True)
    with open(os.path.join(OUT, "eq56_pass.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if not all(c["results_equal"] for c in summary["cases"].values()):
        raise AssertionError("the trees' results differ")


if __name__ == "__main__":
    main()
