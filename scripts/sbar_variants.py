#!/usr/bin/env python3
"""Time variants of the S̄ pass (``emvb::sbar_block``) on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/sbar_variants.py '{"k4mb6": {"K": 4, "MB": 6},
                                       "k8mb4": {"K": 8, "MB": 4}}' \
        [--other build/parent]

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with the
constants ``SBAR_K`` (gathers a lane issues a round), ``SBAR_MIN_BLOCKS``
(blocks an SM the launch bounds promise) and optionally ``SBAR_CODES`` of
``doc_math.cuh`` set as given; ``--other`` adds another tree's unchanged
``cinter.cu`` as the variant ``other``. Every variant's ``cinter.cu`` is
built with nvcc (all at once) into ``build/sbar_variants/<name>/`` and
called through ctypes on the cinter operands of ``chip_smoke.py``'s planted
emvb-msmarco index (B = 32 and B = 1, float32 and bf16 CS^T), each output
held bit for bit against the plain version. Per variant it prints one JSON
line: registers and spill bytes by form, then per operand set the ms per
call in a burst of 20 after one L2 flush, the median ms of single calls
with L2 flushed, and the profiler's device ms per call (0 when the profiler
lost the launches). All lines also go to ``chiprun_out/sbar_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "sbar_variants")


def build(variants: dict, other: str | None) -> dict:
    """Copy, edit and compile each variant; -> {name: ptxas's registers and
    spill bytes per (LP, type)}."""
    from repro_torch.kernels import _build
    procs = {}
    for name, v in variants.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(other, "src/repro_torch/kernels/csrc")
                        if v == "other" else _build.CSRC, d)
        if v != "other":
            p = os.path.join(d, "doc_math.cuh")
            s = open(p).read()
            for key, const in (("K", "SBAR_K"), ("MB", "SBAR_MIN_BLOCKS"),
                               ("CODES", "SBAR_CODES")):
                if key in v:
                    s = re.sub(rf"constexpr int {const} = \d+;",
                               f"constexpr int {const} = {v[key]};", s)
            open(p, "w").write(s)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(d, "cinter.so"), os.path.join(d, "cinter.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs[name] = re.findall(
            r"kernelILi(\d)E(f|13__nv_bfloat16)E.*?\n.*?(\d+) bytes spill "
            r"stores.*?\n.*?Used (\d+) registers", log)
    return regs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", help="JSON {name: {K, MB[, CODES]}}")
    ap.add_argument("--other", help="another tree whose cinter.cu runs too")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import cinter as kci
    if not torch.cuda.is_available():
        raise SystemExit("sbar_variants: needs a CUDA card")
    variants = json.loads(args.variants)
    if args.other:
        variants["other"] = "other"
    regs = build(variants, args.other and os.path.abspath(args.other))
    dev = torch.device("cuda")
    index, _ = synthetic.make_packed_index(0, min_len=cs.MIN_LEN, device=dev,
                                           **cs.WIDTHS)
    queries, _ = synthetic.make_queries(index, 1, cs.N_QUERIES,
                                        cs.ENGINE["n_q"])
    cfg = teng.EngineConfig(**cs.ENGINE, use_kernels=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in variants:
        fn = ctypes.CDLL(os.path.join(OUT, name, "cinter.so")).cinter_batched
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
        fns[name] = fn
    out = {name: {"ptxas": regs[name]} for name in variants}
    p = _build.ptr
    for b, q in (("b32", queries[:32]), ("b1", queries[:1])):
        h = cs.hold_phases(index, q, cfg)
        sel1 = h["sel1"].long()
        codes, lens = index.codes[sel1], index.doc_lens[sel1]
        nb, nd, cap = codes.shape
        for dt in ("float32", "bfloat16"):
            cs_t = teng._transposed(h["cs"]).to(getattr(torch, dt))
            n_c, n_q = cs_t.shape[1:]
            want = kci.cinter_batched_ref(cs_t, codes, lens)
            for name, fn in fns.items():
                sbar = torch.empty((nb, nd), dtype=torch.float32, device=dev)

                def call():
                    err = fn(p(cs_t), int(dt == "bfloat16"), p(codes),
                             p(lens), None, nb, nd, cap, n_c, n_q, p(sbar),
                             _build.stream())
                    _build.check(err, name)
                call()
                cs._exact((sbar,), (want,))
                prof, _ = cs._profiled(call, 5)
                dev_us = sum(cs._dev_us(e) for e in cs._device_events(prof)
                             if "cinter_kernel" in e.key) / 5
                out[name][f"{b}_{dt}"] = {
                    "burst_ms": cs.burst_ms(call, flush=flush),
                    "ms": cs.time_ms(call, flush=flush),
                    "device_ms": dev_us / 1e3}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sbar_variants.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "variants": out}, f, indent=1)
    print(smi)
    for name, rec in out.items():
        print(json.dumps({name: rec}), flush=True)


if __name__ == "__main__":
    main()
