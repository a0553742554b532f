"""The readings the check's limits are set from, in one process on the
card: the program's runs of a cell over many seeds (each a whole run of
``--seconds``, as ``run.py`` makes it, checked the same way), then the
control's numbers on a few of those seeds.

    python3 perfbench/tools/readings.py --workload <cell> \\
        --seeds 11 12 ... --control-seeds 11 12 13 --seconds 2 \\
        --control-batches 8

Prints one JSON line per reading and writes them all to
``perfbench/out/readings.<cell>.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-batches", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.join(REPO, "src")]
    import torch
    from harness import control, runner, spec
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, REPO)
    dev = torch.device("cuda")
    out = []

    def note(kind, seed, nums, extra=None):
        rec = {"kind": kind, "workload": args.workload, "seed": seed,
               "numbers": nums, **(extra or {})}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        r = runner.run_cell(cell, seed, args.seconds, False, device=dev,
                            t_start=t, out_dir=os.path.join(HERE, "out"))
        note("program", seed, {k: v["value"] for k, v in r["checks"].items()},
             {"correct": r["correct"], "metrics": r["metrics"]})
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        nums = control.control_numbers(cell, seed, dev, args.control_batches)
        note("control", seed, nums,
             {"seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    with open(os.path.join(HERE, "out", f"readings.{args.workload}.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
