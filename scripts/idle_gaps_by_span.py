#!/usr/bin/env python3
"""Idle gaps of the card in a benchmark run's chrome trace, each put down
to the program span the host was in when it launched the operation that
ended the gap.

    python3 scripts/idle_gaps_by_span.py TRACE [--min-us 50]

TRACE is a ``--trace 1`` run's ``perfbench/out/<cell>.seed<n>.trace.json``
(or the same file gzipped). The window runs from the first profiler step's
start to the last one's end. A gap of at least ``--min-us`` with no kernel,
copy or memset running is keyed by the innermost program span
(``repro_torch.obs.trace``, shown in the trace through its profiler bridge)
and the innermost harness range open at that operation's launch; a gap
whose two operations were launched in different steps is keyed "between
calls". Prints one markdown row per key, largest total first: gaps, gaps a
call, ms a call, largest ms.
"""
from __future__ import annotations

import argparse
import collections
import gzip
import json

PROGRAM = {"engine.retrieve.dispatch", "engine.candgen",
           "engine.candgen.bitmap_wait", "engine.prefilter", "engine.late"}
RANGES = {"engine.centroid_scores", "bitvector.masked_topk_centroids",
          "engine.candidate_bitmap", "engine._query_lut",
          "engine._transposed", "ops.prefilter_batched",
          "ops.pqinter_batched"}
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def gaps(events: list, min_us: float) -> tuple[int, float, dict]:
    """-> (calls, window ms, {(program span, range): [count, total us,
    largest us]})."""
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("ProfilerStep#"))
    w0, w1 = steps[0][0], steps[-1][1]
    ann = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["args"].get("correlation"))
                 for e in events if e.get("cat") in DEVICE)

    def step_of(t):
        for i, (a, b) in enumerate(steps):
            if a <= t <= b:
                return i
        return None

    def innermost(t, names):
        best = None
        for a, b, n in ann:
            if n in names and a <= t <= b and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "(none)"

    out = collections.defaultdict(lambda: [0, 0.0, 0.0])
    end, end_step = w0, None
    for s, e, corr in dev:
        if e <= w0 or s >= w1:
            continue
        s = max(s, w0)
        if s - end >= min_us:
            lt = launch.get(corr)
            st = step_of(lt) if lt is not None else None
            if lt is None:
                key = ("?", "?")
            elif end_step is not None and st is not None and st != end_step:
                key = ("between calls", innermost(lt, PROGRAM))
            else:
                key = (innermost(lt, PROGRAM), innermost(lt, RANGES))
            g = out[key]
            g[0] += 1
            g[1] += s - end
            g[2] = max(g[2], s - end)
        if e > end:
            end, end_step = e, step_of(launch.get(corr, s))
    return len(steps), (w1 - w0) / 1e3, dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--min-us", type=float, default=50.0)
    args = ap.parse_args(argv)
    calls, window_ms, out = gaps(_load(args.trace), args.min_us)
    print(f"{calls} calls, window {window_ms:.3f} ms")
    for (a, b), (n, tot, mx) in sorted(out.items(), key=lambda kv: -kv[1][1]):
        print(f"| {a} | {b} | {n} | {n / calls:.2f} | "
              f"{tot / calls / 1e3:.4f} | {mx / 1e3:.4f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
