#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for. ``--trace 0`` measures the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics; both check what was served against the plain
reference. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with ``--trace 1`` breakdown, and the
compared numbers with their limits under ``checks``); the compared numbers
are also the last lines of standard error. Profiler tables and traces go
to ``perfbench/out/``. Exits with 2 and prints no result without the cards,
and with 3 when jax, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(HERE, "out")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one client thread on one core: a thread that the scheduler moves
    # between cores left the card idle 3-6 ms between calls on a third of
    # the over-fetch cell's calls, and for 1.6-1.9 ms on none when pinned
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    # every build and kernel cache of the run stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(OUT, "cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(OUT, "cache", "torch_extensions"))
    sys.path[:0] = [HERE, os.path.join(REPO, "src")]
    import torch
    from harness import runner, spec

    cell = spec.cell(args.workload, REPO)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), device=torch.device("cuda"),
                             t_start=T_START, out_dir=OUT)
    found = runner.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
