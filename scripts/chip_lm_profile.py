#!/usr/bin/env python3
"""Profile the LM serving path on one CUDA card: where the time of a
prefill and of a decode step goes at granite-moe-1b-a400m's full config.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/chip_lm_profile.py

With weights from a seed it runs, each under ``torch.profiler`` after a
warm-up: ``transformer.prefill`` at 2 x 32,768 tokens (the chunked
attention and the capacity gather), and ``transformer.decode_step`` at
B = 2 over a 32,800-position cache and at B = 32 over 32,768 positions. For
each it prints the wall ms a call (host clock around synchronized work),
the device ms a call (the kernels' time in the profile), their ratio (the
device's busy share), the CUDA launches a call and the top kernels, and
writes the full tables to ``chiprun_out/lm_profile_<run>.txt``. The card's
name and power limit come first, one JSON object of the numbers last. It
exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
RUNS = (("prefill", 2, 32_768, 1), ("decode_b2", 2, 32_800, 5),
        ("decode_b32", 32, 32_768, 5))      # (name, batch, length, calls)


def profiled(fn, calls: int, warmup: int) -> tuple:
    """(wall ms, device ms, launches, the 8 kernels with the most device
    ms) a call of ``fn``, and the profile's averages."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device = sum(map(sum, by_name.values())) / 1e3 / calls
    launches = sum(map(len, by_name.values())) / calls
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return wall, device, launches, {k[:60]: sum(v) / 1e3 / calls
                                    for k, v in top}, prof.key_averages()


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_lm_profile: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = registry.get("granite-moe-1b-a400m").make_config()
    model = transformer.init_params(0, cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    os.makedirs(OUT, exist_ok=True)
    out = {}
    for name, b, s, calls in RUNS:
        if name == "prefill":
            tok = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                device=dev)

            def fn():
                return transformer.prefill(model, tok, cfg)
            warmup = 1
        else:
            cache = transformer.init_cache(cfg, b, s, dev)
            tok = torch.randint(0, cfg.vocab, (b,), generator=gen,
                                device=dev)

            def fn():
                return transformer.decode_step(model, cache, tok, s - 1, cfg)
            warmup = 3
        wall, device, launches, top, avg = profiled(fn, calls, warmup)
        out[name] = {
            "batch": b, "length": s, "wall_ms": wall, "device_ms": device,
            "busy_share": device / wall, "launches": launches,
            "top_kernels_ms": top}
        with open(os.path.join(OUT, f"lm_profile_{name}.txt"), "w") as f:
            f.write(avg.table(sort_by="self_cuda_time_total", row_limit=40))
        print(name, json.dumps(out[name]), flush=True)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
