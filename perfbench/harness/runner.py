"""One run of one cell: set-up, warm-up, the measured window, the check.

1. The cell's data is made on the device from the seed
   (``harness/planted.py``), with every query and filter of the run
   (``harness/traffic.py``).
2. The program's set-up takes the data (``systems/<system>.py``): it lays
   out its IVF and builds its index; the first call builds its kernels.
3. The loop sends ``warmup_calls`` batches of other queries, which run
   every shape the window uses. All of this is ``setup_s``, from the
   start of the process.
4. The window: the mix's loop (``loops/<loop>.py``) sends the pool's
   batches for ``seconds`` (or until the pool of distinct batches is
   spent) and returns its end-to-end readings. With ``trace`` the profiler
   records a few of its calls, the program's spans are on, and named
   functions of the program run inside ``record_function`` ranges.
5. Once the window has closed and the peak memory is read, the program's
   state is freed and the plain reference checks a sample of the window's
   batches drawn from the seed (with ``trace``: the recorded calls).
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import check, planted, traffic
from .readers import Readings
from .trace_view import TraceView

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN_CAPACITY = 1 << 16


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (by default the loaded modules), the top-level names
    that are jax's, jaxlib's, flax's or the JAX package's, compared
    whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def kernels_built() -> bool:
    """Whether the program's kernel libraries were already built in this
    checkout (``build/repro_torch_kernels/``): a run that builds them is
    the checkout's first, whose set-up is recorded apart."""
    from repro_torch.kernels import _build
    d = _build._build_dir()
    return all(os.path.exists(os.path.join(d, f[:-3] + ".so"))
               for f in _build.sources())


def _profiler(tr: dict):
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, schedule=schedule(
        wait=tr["wait_calls"], warmup=tr["warmup_calls"], active=tr["calls"],
        repeat=1))


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: torch.device, t_start: float, out_dir: str) -> dict:
    """One run of ``cell`` (``harness/spec.py``) -> the result line's
    object."""
    cfg, mix = cell.config, cell.traffic
    eng = cfg["engine"]
    widths = {k: cfg[k] for k in ("n_docs", "cap", "min_len", "d",
                                  "n_centroids", "m", "nbits")}
    tr = mix["trace"]
    prof_calls = range(tr["wait_calls"],
                       tr["wait_calls"] + tr["warmup_calls"] + tr["calls"])
    min_calls = prof_calls.stop if trace else 1
    data = planted.make_data(traffic.sub_seed(seed, traffic.DATA),
                             device=device, **widths)
    tf = traffic.make(mix, data, seed, seconds, eng["n_q"], min_calls)
    # the pool holds every query of the window, so it grows with the
    # window's length; no serving process holds it
    pool_bytes = tf.batches.numel() * tf.batches.element_size()
    ranges = None
    if trace:
        from .ranges import Ranges
        ranges = Ranges({k: v for m in cell.per_layer
                         for k, v in m.params.get("ranges", {}).items()})
    built = kernels_built()
    system = cell.system.System(data, tf.plane, cfg, device)
    loop = cell.loop.Loop(system, tf, mix, eng["k"], device)
    tracer = None
    if trace:
        from repro_torch.obs import trace as obs_trace
        tracer = obs_trace.enable(SPAN_CAPACITY)
    _sync(device)
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans = []
    prof = _profiler(tr) if trace else None

    def after_call(i):
        if prof is not None:
            prof.step()
            drained = tracer.drain()
            if i not in prof_calls:
                spans.extend(drained)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if prof is not None:
        prof.__enter__()
    win = loop.window(t0, seconds, min_calls, after_call)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = window_peak = None
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, window_peak)
    calls, served = win.calls, win.served
    if not trace:
        if "call_s" in win.detail:
            q = np.percentile(np.array(win.detail["call_s"]) * 1e3,
                              [0, 50, 90, 95, 99, 100])
            _log("call ms min/p50/p90/p95/p99/max " +
                 "/".join(f"{x:.3f}" for x in q))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{cell.name}.seed{seed}"
                                   ".window.json"), "w") as f:
                json.dump(win.detail, f)
    _log(f"{cell.name} seed {seed}: setup {setup_s:.3f} s "
         f"({'kernels found built' if built else 'kernels built'}), "
         f"{calls} calls in {win.window_s:.3f} s, pool "
         f"{tf.batches.shape[0]} batches ({pool_bytes / 1e9:.3f} GB), "
         f"IVF entries dropped {system.n_dropped}")
    if calls == tf.batches.shape[0] and win.window_s < seconds:
        _log(f"the pool's {calls} batches ran out after {win.window_s:.3f} "
             f"s of the window's {seconds:g} s: raise the mix's "
             "pool_batches_per_s")

    view = None
    if trace:
        from repro_torch.obs import trace as obs_trace
        obs_trace.disable()
        ranges.close()
        view = _read_trace(prof, ranges, cell, seed, out_dir)

    system.close()
    del system, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if trace:
        picked = [c for c in range(prof_calls.start + tr["warmup_calls"],
                                   prof_calls.stop)]
    else:
        rng = np.random.default_rng(seed)
        picked = sorted(rng.choice(calls, size=min(mix["check_batches"],
                                                   calls), replace=False))
    t_ref = time.perf_counter()
    ref = cell.reference.Reference(data, tf.plane, cfg)
    refs, fails = [], ([] if tf.filters is not None else None)
    for c in picked:
        pred = None if tf.filters is None else tf.filters[c]
        refs.append(ref.run(tf.batches[c], pred, score_ids=served[c][1],
                            counts=trace))
        if fails is not None:
            dp = ref.doc_pass(pred).cpu()
            ids = served[c][1].long().clamp(0, dp.numel() - 1)
            fails.append(~dp[ids])
    nums = check.numbers([served[c] for c in picked], refs, fails)
    correct, checks = check.verdict(nums, cell.limits)
    _log(f"reference checked {len(picked)} batches in "
         f"{time.perf_counter() - t_ref:.3f} s")

    result = {"correct": correct, "attempted": calls * tf.batches.shape[1],
              "failed": 0, "first_run": not built}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    if not trace:
        e2e = dict(win.readings, setup_s=setup_s)
        if window_peak is not None:
            e2e["peak_mem_gb"] = (window_peak - pool_bytes) / 1e9
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in e2e}
    else:
        readings = Readings(view, spans, [r["counts"] for r in refs],
                            ranges.missing)
        metrics = {}
        for m in cell.per_layer:
            v = m.read(readings, m.params)
            if v is not None:
                metrics[m.entry["name"]] = {"value": v,
                                            "unit": m.entry["unit"]}
        result["metrics"] = metrics
        dev_info["busy_s"] = view.busy_s()
        dev_info["window_s"] = view.window_s()
        result["breakdown"] = view.breakdown()
    result["device"] = dev_info
    if device.type == "cuda":
        result["card"] = card()
    result["checks"] = {k: {"value": _num(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    return result


def _num(v):
    """A number for the JSON line: a non-finite one as a string."""
    return v if math.isfinite(v) else str(v)


def _read_trace(prof, ranges, cell, seed: int, out_dir: str) -> TraceView:
    """Write the profiler's table and chrome trace to ``out_dir`` and read
    the trace back."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{cell.name}.seed{seed}")
    with open(base + ".table.txt", "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total", row_limit=60) + "\n")
    prof.export_chrome_trace(base + ".trace.json")
    with open(base + ".trace.json") as f:
        trace = json.load(f)
    labels = {k for m in cell.per_layer
              for k in m.params.get("ranges", {})}
    return TraceView(trace, labels)
