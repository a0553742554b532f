#!/usr/bin/env python3
"""Compare two trees of the PyTorch/CUDA port on one card, in turns.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_compare.py OTHER_TREE [--runs 5]

OTHER_TREE is an unpacked copy of another commit (``git archive <commit> |
tar -x -C <dir>``), typically the parent, in a directory that .gitignore
lists. This tree's ``chip_smoke.py`` is copied into it, so both trees run the
same phases, each with its own package and kernels. The runs alternate
other, this, this, other, ... (``--runs`` of each). Every run's
``chiprun_out/chip_smoke.json`` is kept as
``chiprun_out/compare/<tree>_<i>.json``; a run that fails stops the script.
It prints one JSON line per metric of ``HEADLINE``: the median, min and max
over each tree's runs, and the card's ``nvidia-smi`` name and power limit;
``chiprun_out/compare/summary.json`` holds the same for every numeric leaf.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "compare")

# Dotted paths into chip_smoke.json printed on their own lines.
HEADLINE = (
    "profile_fused_b32.pass_device_ms_per_wrapper_call.pqinter",
    "profile_fused_b1.pass_device_ms_per_wrapper_call.pqinter",
    "profile_fused_bf16_b32.pass_device_ms_per_wrapper_call.pqinter",
    "profile_fused_bf16_b1.pass_device_ms_per_wrapper_call.pqinter",
    "profile_unfused_b32.pass_device_ms_per_wrapper_call.cinter",
    "profile_unfused_b1.pass_device_ms_per_wrapper_call.cinter",
    "profile_unfused_bf16_b32.pass_device_ms_per_wrapper_call.cinter",
    "profile_unfused_bf16_b1.pass_device_ms_per_wrapper_call.cinter",
    "limits.pqinter_nf4096_n_docs256_b32.pass_ms.sbar_kernel",
    "limits.pqinter_nf4096_n_docs256_b1.pass_ms.sbar_kernel",
    "timing_b32.step_ms.pqinter_kernel",
    "timing_b1.step_ms.pqinter_kernel",
    "timing_b32.unfused_step_ms.cinter_kernel",
    "timing_b1.unfused_step_ms.cinter_kernel",
    "timing_b32.wrapper_host_ms",
    "timing_b1.wrapper_host_ms",
    "timing_b32.step_ms.cs_transpose",
    "timing_b1.step_ms.cs_transpose",
    "timing_b32.step_ms.end_to_end",
    "timing_b1.step_ms.end_to_end",
    "timing_b32.unfused_step_ms.end_to_end",
    "timing_b1.unfused_step_ms.end_to_end",
)


def leaves(x, path=""):
    """{dotted path: number} for every int or float leaf of x."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(leaves(v, f"{path}.{k}" if path else str(k)))
        return out
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return {path: x}
    return {}


def run(tree: str) -> dict:
    """One chip_smoke.py run in tree; raises if it fails."""
    out = os.path.join(tree, "chiprun_out", "chip_smoke.json")
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"chip_smoke.py failed in {tree} "
                         f"({proc.returncode})")
    with open(out) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"),
                os.path.join(other, "chip_smoke.py"))
    os.makedirs(OUT, exist_ok=True)
    trees = {"other": other, "this": ROOT}
    order = [("other", "this", "this", "other")[i % 4]
             for i in range(2 * args.runs)]
    samples = {"other": [], "this": []}
    smi = None
    for name in order:
        rec = run(trees[name])
        smi = rec["device"]["nvidia_smi"]
        i = len(samples[name])
        with open(os.path.join(OUT, f"{name}_{i}.json"), "w") as f:
            json.dump(rec, f)
        samples[name].append(leaves(rec))
        print(json.dumps({"run": f"{name}_{i}"}), flush=True)
    summary = {}
    for name, runs in samples.items():
        for key in sorted(set().union(*runs)):
            vals = [r[key] for r in runs if key in r]
            summary.setdefault(key, {})[name] = {
                "median": statistics.median(vals), "min": min(vals),
                "max": max(vals), "runs": vals}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "order": order, "metrics": summary}, f,
                  indent=1)
    print(json.dumps({"nvidia_smi": smi, "order": order}), flush=True)
    for head in HEADLINE:
        for key in sorted(k for k in summary if k == head
                          or k.startswith(head + ".")):
            print(json.dumps({key: {t: {s: v[s] for s in ("median", "min",
                                                          "max")}
                                    for t, v in summary[key].items()}}),
                  flush=True)


if __name__ == "__main__":
    main()
