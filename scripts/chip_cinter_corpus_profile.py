#!/usr/bin/env python3
"""Profile cinter's whole-corpus launch, PLAID's phase 2, on one CUDA card:
the device time of one launch over every doc of the emvb-msmarco widths.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_cinter_corpus_profile.py

It builds the planted synthetic index at the emvb-msmarco widths
(8,841,823 docs, cap 80, 2^18 centroids; ``data.synthetic``), takes one
planted query's CS^T (n_c, 32) and runs ``ops.cinter`` over the whole
corpus, as ``core/plaid.py``'s phase 2 does a query, under
``torch.profiler`` after a warm-up. It prints the card's name and power
limit first, then one JSON object: the wall ms a call (host clock around
synchronized calls), the device ms a call (the kernel's time in the
profile), the CUDA launches a call and each kernel's device ms. It exits
non-zero without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(n_docs=8_841_823, cap=80, d=128, n_centroids=1 << 18, m=16,
              nbits=8, list_cap=4096)     # chip_smoke.py's WIDTHS
MIN_LEN = 54
CALLS = 10


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_cinter_corpus_profile: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    index, _ = synthetic.make_packed_index(0, min_len=MIN_LEN, device=dev,
                                           **WIDTHS)
    queries, _ = synthetic.make_queries(index, 1, 1, 32)
    cs_t = engine._transposed(engine.centroid_scores(
        queries, index.centroids))[0]

    def fn():
        return ops.cinter(cs_t, index.codes, index.doc_lens)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / CALLS
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    print(json.dumps({
        "docs": WIDTHS["n_docs"], "calls": CALLS, "wall_ms": wall,
        "device_ms": sum(map(sum, by_name.values())) / 1e3 / CALLS,
        "launches": sum(map(len, by_name.values())) / CALLS,
        "by_kernel_ms": {k[:60]: sum(v) / 1e3 / CALLS
                         for k, v in by_name.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
