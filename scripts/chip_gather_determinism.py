#!/usr/bin/env python3
"""Measure on one CUDA card whether a row gather's backward gives the same
bits twice: ``torch.nn.functional.embedding`` against indexing
(``table[idx]``) and ``repro_torch.models.flat.take_rows``, the gather
every ported model uses.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_gather_determinism.py

For each (rows, indices) case, from few indices to many repeating a few
rows, it draws a table, indices and an upstream gradient from a seed,
runs each gather's backward twice and counts the gradient elements whose
bits differ. A training step is bit-equal when repeated (and a resumed run
equals the continuous one) only where its gather's counts are 0. It
prints the card, then one JSON object of counts, and exits non-zero
without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (rows, indices): under and over 3,072 indices, few rows and many
CASES = ((200, 2_000), (64, 8_192), (500, 53_248), (1_000_000, 208_896))
DIM = 16


def main() -> int:
    """Count the differing gradient elements per gather and case."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.models.flat import take_rows
    if not torch.cuda.is_available():
        print("chip_gather_determinism: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gathers = {"F.embedding": lambda t, i: F.embedding(i, t),
               "indexing": lambda t, i: t[i], "take_rows": take_rows}
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    out = {"torch": torch.__version__, "dim": DIM, "cases": {}}
    for rows, n in CASES:
        table = torch.randn((rows, DIM), generator=g, device=dev,
                            requires_grad=True)
        idx = torch.randint(0, rows, (n,), generator=g, device=dev)
        up = torch.randn((n, DIM), generator=g, device=dev)
        counts = {}
        for name, gather in gathers.items():
            a, b = (torch.autograd.grad((gather(table, idx) * up).sum(),
                                        [table])[0] for _ in range(2))
            counts[name] = int((a.view(torch.int32)
                                != b.view(torch.int32)).sum())
        out["cases"][f"rows{rows}_indices{n}"] = counts
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
