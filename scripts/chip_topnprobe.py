#!/usr/bin/env python3
"""The masked top-nprobe kernel (``csrc/topnprobe.cu``) on one card: held
against its plain version, then timed beside it and its bound.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_topnprobe.py [--no-time]

It prints ``nvcc -Xptxas -v``'s registers and spills of each of the
kernel's functions, holds the kernel's ids equal to the plain version's
(``masked_topk_ref``) on ``tests/torch_inputs.topnprobe_inputs``'s edge
cases at B = 32 and B = 1 (n_q = 32, n_c = 2^18, float32 and bf16, nprobe
4 and 33), and, unless ``--no-time``, times the kernel and the plain
version on CS drawn like centroid scores (normal, sd 0.3) at nprobe 4, th
0.4: the kernel's device ms (torch.profiler, median of 20 back-to-back
calls; ``share`` is the bound over it), a call's ms by CUDA events (median
of 20, L2 flushed before each, the wrapper's host time included where the
card waits for it), the plain version's (median of 5), and the bound: the
CS read once and the ids written, at 3.35 TB/s. One
JSON line per case beside the card's ``nvidia-smi`` name and power limit;
every line also goes to ``chiprun_out/topnprobe.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
HBM_BPS = 3.35e12
N_Q, N_C = 32, 1 << 18
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def _ptxas() -> list:
    """nvcc -Xptxas -v's lines on the kernel's functions: registers,
    shared memory and spills."""
    from repro_torch.kernels import _build
    out = os.path.join(OUT, "topnprobe_ptxas.so")
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
         os.path.join(_build.CSRC, "topnprobe.cu")],
        capture_output=True, text=True)
    if os.path.exists(out):
        os.remove(out)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    return [ln for ln in (log.stdout + log.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Function properties"
            in ln]


def _device_ms(fn, n: int = 20) -> float:
    """Median device ms of the kernel's own launch over n back-to-back calls
    of fn (torch.profiler: the launches queue behind one another, so the
    host's time a call does not show)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ts = [getattr(e, "device_time_total", 0) or e.cuda_time_total
          for e in prof.events() if "topnprobe_kernel" in e.name]
    return statistics.median(ts) / 1e3


def _event_ms(fn, n: int, flush) -> float:
    """Median ms of one call of fn by CUDA events, L2 flushed before it:
    the call as a caller sees it, host time included where the device
    waits for it."""
    import torch
    fn()
    ts = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import topnprobe as ktp
    from torch_inputs import topnprobe_inputs
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    smi = _smi()
    lines = [{"case": "ptxas", "card": smi, "lines": _ptxas()}]
    for nb in (32, 1):
        for dtype in (torch.float32, torch.bfloat16):
            for nprobe in (4, 33):
                cs, qm = topnprobe_inputs(nb, nb, N_Q, N_C, nprobe, 0.4, dev)
                cs = cs.to(dtype)
                got = ktp.masked_topk(cs, 0.4, nprobe, qm)
                want = ktp.masked_topk_ref(cs, 0.4, nprobe, qm)
                lines.append({"case": "hold", "B": nb, "dtype": str(dtype),
                              "nprobe": nprobe,
                              "equal": bool(torch.equal(got, want))})
    if not args.no_time:
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        for nb in (32, 1):
            for dtype in (torch.float32, torch.bfloat16):
                cs = (torch.randn((nb, N_Q, N_C), generator=gen, device=dev)
                      * 0.3).to(dtype)
                ids = nb * N_Q * 4 * 4
                bound = (cs.numel() * cs.element_size() + ids) / HBM_BPS * 1e3
                dev_ms = _device_ms(lambda: ktp.masked_topk(cs, 0.4, 4))
                ms = _event_ms(lambda: ktp.masked_topk(cs, 0.4, 4), 20,
                               flush)
                plain = _event_ms(lambda: ktp.masked_topk_ref(cs, 0.4, 4), 5,
                                  flush)
                lines.append({"case": "time", "B": nb, "dtype": str(dtype),
                              "nprobe": 4, "device_ms": dev_ms, "ms": ms,
                              "plain_ms": plain, "bound_ms": bound,
                              "share": bound / dev_ms, "card": smi})
                del cs
    with open(os.path.join(OUT, "topnprobe.json"), "w") as f:
        for ln in lines:
            print(json.dumps(ln), flush=True)
            f.write(json.dumps(ln) + "\n")
    if not all(ln["equal"] for ln in lines if ln["case"] == "hold"):
        raise SystemExit("the kernel's ids differ from the plain version's")


if __name__ == "__main__":
    main()
