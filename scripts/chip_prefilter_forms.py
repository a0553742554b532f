#!/usr/bin/env python3
"""The prefilter kernel of two trees of the port on one card, in turns.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_prefilter_forms.py OTHER_TREE [--runs 2]

OTHER_TREE is an unpacked copy of another commit (``git archive <commit> |
tar -x -C <dir>``, in a directory that .gitignore lists), typically the
parent. Each run is a process of its own with one tree's ``src`` first on
``sys.path``, in the order other, this, this, other, ... (``--runs`` of
each); it builds that tree's kernels, the full-width planted emvb-msmarco
index and 32 planted queries (``chip_smoke.py``'s widths and config), and
times ``ops.prefilter_batched`` on the default config's CS and candidate
bitmap at n_filter 1,024, 4,096 and 8,192, B = 32 and B = 1: the median ms
of 10 calls (CUDA events, L2 flushed) and the device ms of each
``__global__`` pass (torch.profiler), with this tree's ``chip_smoke.py``
helpers. Both trees must return the same scores and ids, bit for bit. It
prints one JSON line per case, each tree's median over its runs beside the
card's ``nvidia-smi`` name and power limit, and keeps every run in
``chiprun_out/prefilter_forms.json``.
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
N_FILTERS = (1024, 4096, 8192)
BATCHES = (32, 1)
# the __global__ passes of either form of the prefilter's cut: the sort in
# shared memory (threshold, collect, sort) or the counting rank (bin_rank,
# place)
PASSES = ("pack_kernel", "transpose_kernel", "score_kernel",
          "score_query_kernel", "threshold_kernel", "collect_kernel",
          "sort_kernel", "bin_rank_kernel", "place_kernel")


def one(tree: str, out: str) -> None:
    """One run in this process: ``tree``'s port timed as the module note
    says; the record goes to ``out``."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    cs.KERNEL_FUNCTIONS["prefilter"] = PASSES
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    index, _ = synthetic.make_packed_index(0, min_len=cs.MIN_LEN, device=dev,
                                           **cs.WIDTHS)
    queries, _ = synthetic.make_queries(index, 1, 32, cs.ENGINE["n_q"])
    cfg = teng.EngineConfig(**cs.ENGINE, use_kernels=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rec = {"src": ops.__file__}
    for nb in BATCHES:
        scores = teng.centroid_scores(queries[:nb], index.centroids)
        bitmap = teng._candidates(index, scores, cfg)
        for n_filter in N_FILTERS:
            args = (scores, cfg.th, index.codes, index.doc_lens, bitmap,
                    n_filter)

            def fn():
                return ops.prefilter_batched(*args)
            got = fn()
            torch.cuda.synchronize()
            digest = hashlib.sha256(got[0].cpu().numpy().tobytes()
                                    + got[1].cpu().numpy().tobytes())
            pass_ms, launches = cs._passes(fn, "prefilter")
            rec[f"n_filter{n_filter}_b{nb}"] = {
                "ms": cs.time_ms(fn, flush=flush), "pass_ms": pass_ms,
                "device_ms": None if pass_ms is None
                else sum(pass_ms.values()),
                "pass_launches": launches, "sha256": digest.hexdigest()}
    with open(out, "w") as f:
        json.dump(rec, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        one(a.one, a.out)
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
        path = os.path.join(OUT, f"prefilter_forms_{name}_{i}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "x",
                        "--one", trees[name], "--out", path], check=True)
        with open(path) as f:
            runs[name].append(json.load(f))
    summary = {"nvidia_smi": smi, "order": order, "runs": runs, "cases": {}}
    for nb in BATCHES:
        for n_filter in N_FILTERS:
            key = f"n_filter{n_filter}_b{nb}"
            digests = {r[key]["sha256"] for rs in runs.values() for r in rs}
            if len(digests) != 1:
                raise AssertionError(f"{key}: the trees' results differ")
            case = {"nvidia_smi": smi, "case": key, "results_equal": True}
            for name, rs in runs.items():
                case[name] = {m: statistics.median(r[key][m] for r in rs)
                              for m in ("ms", "device_ms")
                              if all(r[key][m] is not None for r in rs)}
                case[name]["pass_ms"] = rs[-1][key]["pass_ms"]
            summary["cases"][key] = case
            print(json.dumps(case), flush=True)
    with open(os.path.join(OUT, "prefilter_forms.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
