"""Dry run (counterpart of ``repro/launch/dryrun.py``): reckon EVERY
(architecture x input-shape) cell on the production meshes, per chip, with
no card and no memory, print each and append its record to a JSON log.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch.json

Each cell is built on ``meta`` (``launch/steps.py``) and its program
counted (``launch/op_stats.py``); the two meshes share one global count
per cell. A record keeps the reference's keys where they have a
counterpart: ``argument_bytes_per_chip``, ``output_bytes_per_chip``,
``temp_bytes_per_chip``, ``peak_bytes_per_chip``, ``n_collective_sites``,
``collective_by_kind_gib`` and the roofline's fields (``launch/
analysis.py``, the H100's constants); the reference's ``lower_s`` and
``compile_s`` become ``reckon_s``; ``xla_cost_flops_unscaled`` has no
counterpart. FITS means the peak a chip is under the H100's memory as torch
reports it on the card (``analysis.HBM_CAPACITY``). Runs are resumable:
cells already present in ``--out`` are skipped unless ``--force``; a cell
that fails is recorded with its error and the run goes on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import registry
from . import analysis, op_stats
from .mesh import make_production_mesh
from .steps import build_cell


def run_cell(arch: str, shape: str, multi_pod: bool, shared: dict = None,
             verbose: bool = True) -> dict:
    """The record of one cell on one production mesh. ``shared`` maps
    (arch, shape) to the global program's counts
    (``op_stats.global_counts``), which both meshes share: they are taken
    from it, or made and put there."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, make_production_mesh(multi_pod=multi_pod))
    shared = {} if shared is None else shared
    if (arch, shape) not in shared:
        shared[(arch, shape)] = op_stats.global_counts(cell)
    rec = op_stats.reckon(cell, shared[(arch, shape)])
    rec["reckon_s"] = time.perf_counter() - t0
    if verbose:
        print(line(rec), flush=True)
    return rec


def line(rec: dict) -> str:
    """One printed line of a record."""
    fit = "FITS" if rec["fits"] else "OVER-BUDGET"
    return (f"[{rec['arch']} x {rec['shape']} @ {rec['mesh']}] "
            f"args={rec['argument_bytes_per_chip'] / 1e9:.3f}GB "
            f"peak={rec['peak_bytes_per_chip'] / 1e9:.3f}GB ({fit} in "
            f"{analysis.HBM_CAPACITY / 1e9:.1f}GB) "
            f"dom={rec['dominant']} bound={rec['bound_s']:.4g}s "
            f"useful={rec.get('useful_flops_ratio', float('nan')):.3f}")


def cells(arch=None, shape=None, mesh: str = "single",
          all_cells: bool = False) -> list:
    """[(arch, shape, multi_pod)] the arguments select."""
    out = []
    archs = registry.names() if (all_cells or arch is None) else [arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[mesh]
    for a in archs:
        shapes = [shape] if shape else list(registry.get(a).shapes)
        for s in shapes:
            out += [(a, s, mp) for mp in meshes]
    return out


def run(todo: list, out_path: str = None, force: bool = False,
        verbose: bool = True) -> list:
    """Reckon ``todo``'s cells -> every record (those already in
    ``out_path`` included, unless ``force``); each record is written to
    ``out_path`` as it is made."""
    done = {}
    if out_path and os.path.exists(out_path) and not force:
        with open(out_path) as f:
            for rec in json.load(f):
                done[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    results = list(done.values())
    shared: dict = {}
    for arch, shape, mp in todo:
        mesh = make_production_mesh(multi_pod=mp).name
        key = (arch, shape, mesh)
        if key in done:
            if verbose:
                print(f"skip (recorded): {key}")
            continue
        try:
            rec = run_cell(arch, shape, mp, shared, verbose)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            if verbose:
                print(f"[{arch} x {shape} @ {mesh}] FAILED: {rec['error']}")
        results.append(rec)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = run(cells(args.arch, args.shape, args.mesh, args.all),
                  args.out, args.force)
    n_err = sum(1 for r in results if "error" in r)
    print(f"\n{len(results)} cells recorded, {n_err} failures -> {args.out}")


if __name__ == "__main__":
    main()
