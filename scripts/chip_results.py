#!/usr/bin/env python3
"""Check that trees of the PyTorch/CUDA port give the same main-path results
on one card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_results.py TREE [TREE ...]

Each TREE is an unpacked copy of a commit (``git archive <commit> | tar -x
-C <dir>``) or ``.``. In a process of its own, each tree's package builds
the planted emvb-msmarco index of ``chip_smoke.py`` (this tree's widths,
seeds and engine config) and serves its queries with ``retrieve`` on both
kernel lanes, unfiltered and in score_all mode: two B = 32 batches and
eight B = 1 queries. It prints one JSON line per tree with the sha256 of
each run's doc ids and float32 score bits (``chip_smoke.result_digest``),
then one line saying whether every tree gave the same digests, and exits
non-zero if not.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import dataclasses, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs
from repro_torch.core import engine as teng
from repro_torch.data import synthetic
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
index, _ = synthetic.make_packed_index(0, min_len=cs.MIN_LEN, device=dev,
                                       **cs.WIDTHS)
queries, _ = synthetic.make_queries(index, 1, cs.N_QUERIES,
                                    cs.ENGINE["n_q"])
cfg = teng.EngineConfig(**cs.ENGINE, use_kernels=True)
ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                           fused_late_interaction=False)
out = {}
for lane, c in (("fused", cfg), ("unfused", ucfg)):
    b32 = [teng.retrieve(index, queries[s:s + 32], c)
           for s in range(0, cs.N_QUERIES, 32)]
    b1 = [teng.retrieve(index, queries[i:i + 1], c)
          for i in range(cs.N_SINGLE)]
    out[lane] = {"b32": cs.result_digest(b32), "b1": cs.result_digest(b1)}
print(json.dumps(out))
"""


def digests(tree: str) -> dict:
    """The main path's result digests of ``tree``'s package."""
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, os.path.join(tree, "src"), ROOT],
        capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-6000:])
        raise SystemExit(f"the main path failed in {tree} "
                         f"({proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [ROOT]
    seen = []
    for tree in trees:
        d = digests(tree)
        seen.append(d)
        print(json.dumps({"tree": os.path.relpath(tree, ROOT), **d}),
              flush=True)
    same = all(d == seen[0] for d in seen)
    print(json.dumps({"same_results": same}), flush=True)
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
