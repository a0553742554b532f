#!/usr/bin/env python3
"""Measure on one CUDA card whether the engine's two query products give a
query the same bits in any batch: the centroid scores (CS,
``engine.centroid_scores``) and the PQ lookup table (``engine._query_lut``).

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_batch_invariance.py

For each width (a small one; the emvb-msmarco d, n_q, m and nbits over
4,096 and 2^18 centroids) it builds a planted index on the card, plans 32
queries and counts the elements of each product that differ between the
first B rows computed in a batch of B and the same rows in the batch of 32,
for B in 1, 2, 4, 8, 16 and 17. The result service's cache equals an
uncached run only where every count is 0. It prints the card, then one
JSON object of counts, and exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (n_centroids, d, n_q, m, nbits)
WIDTHS = ((512, 32, 16, 4, 4), (4096, 128, 32, 16, 8),
          (1 << 18, 128, 32, 16, 8))
BATCHES = (1, 2, 4, 8, 16, 17)


def main() -> int:
    """Count the differing elements per width and batch; print them."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    if not torch.cuda.is_available():
        print("chip_batch_invariance: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    out = {}
    for n_c, d, n_q, m, nbits in WIDTHS:
        index, _ = synthetic.make_packed_index(
            0, n_docs=3000, cap=16, min_len=6, d=d, n_centroids=n_c, m=m,
            nbits=nbits, list_cap=None, device=dev)
        q, _ = synthetic.make_queries(index, 1, 32, n_q)
        cs = teng.centroid_scores(q, index.centroids).view(torch.int32)
        lut = teng._query_lut(index, q).view(torch.int32)
        out[f"n_c={n_c},d={d},n_q={n_q}"] = {
            b: {"cs_elements_differing": int((teng.centroid_scores(
                    q[:b], index.centroids).view(torch.int32)
                    != cs[:b]).sum()),
                "lut_elements_differing": int((teng._query_lut(
                    index, q[:b]).view(torch.int32) != lut[:b]).sum()),
                "cs_elements": cs[:b].numel()}
            for b in BATCHES}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
