#!/usr/bin/env python3
"""What the port's tracing costs on the card: one benchmark run of a cell,
with the program's tracer changed as ``--mode`` says.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_trace_cost.py --mode MODE --workload <cell> \\
        --seed <n> --seconds <s>

MODE is one of

* ``off``: the benchmark's untraced run (``perfbench/run.py --trace 0``);
* ``on``: the same run with the tracer enabled from the start, as a service
  that keeps tracing on would run; after the result line, one line
  ``tracer {...}`` gives each span's count and mean host and stream ms
  over the window's calls, and the postings a query;
* ``traced``: the benchmark's traced run (``--trace 1``);
* ``traced-nobridge``: the traced run with the spans' profiler ranges left
  out (no ``record_function`` while the profiler records);
* ``traced-noevents``: the traced run with no span timed on the stream (no
  CUDA events, no ``stream_ms``).

``off`` against ``on`` with one seed gives the cost of tracing in ``qps``;
the three traced modes tell which part of the tracer moves the traced
run's per-layer metrics, such as ``device_idle_pct``. The result line is
the benchmark's (``perfbench/run.py``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("off", "on", "traced", "traced-nobridge", "traced-noevents")
CAPACITY = 1 << 16


def _bench():
    """``perfbench/run.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_run", os.path.join(ROOT, "perfbench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(spans: list) -> dict:
    """Per span name: count, mean host ms and mean stream ms; and the
    postings a query, over the calls' dispatch spans."""
    out, batch = {}, {}
    for s in spans:
        d = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0,
                                       "stream_ms": 0.0})
        d["n"] += 1
        d["host_ms"] += 1e3 * s["duration_s"]
        d["stream_ms"] += s.get("stream_ms", 0.0)
        if s["name"] == "engine.retrieve.dispatch":
            batch[s["span_id"]] = s["attrs"].get("batch", 0)
    for d in out.values():
        d["host_ms"] /= d["n"]
        d["stream_ms"] /= d["n"]
    waits = [s for s in spans if s["name"] == "engine.candgen.bitmap_wait"]
    by_id = {s["span_id"]: s for s in spans}
    queries = sum(batch.get(by_id[w["parent_id"]]["parent_id"], 0)
                  for w in waits if w["parent_id"] in by_id)
    if queries:
        out["postings_per_query"] = sum(
            w["attrs"].get("postings", 0) for w in waits) / queries
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = _bench()
    sys.path[:0] = [os.path.join(ROOT, "src")]
    from repro_torch.obs import trace

    if args.mode == "traced-nobridge":
        trace._profiling = lambda: False
    elif args.mode == "traced-noevents":
        host_span = trace.Tracer.span
        trace.Tracer.span = (lambda self, name, device=None, **attrs:
                             host_span(self, name, None, **attrs))
    tracer = trace.enable(CAPACITY) if args.mode == "on" else None
    rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace",
                     "0" if args.mode in ("off", "on") else "1"])
    if tracer is not None:
        trace.disable()
        spans = tracer.drain()
        summary = _summary(spans)
        summary["dropped"] = tracer.dropped
        print("tracer " + json.dumps(summary), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
