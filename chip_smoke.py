#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, and serves ``retrieve`` at the
full widths of the ``emvb-msmarco`` config (``src/repro/configs/
emvb_msmarco.py``) on a planted synthetic index. Every phase prints one JSON
line; a failing phase raises, so the script exits non-zero and prints no
result. It needs a CUDA card and fails without one.

Phases:
  1. device  — the card's name and power limit (nvidia-smi), torch, TF32 off
  2. build   — one nvcc per kernel source, all started together
  3. small   — each kernel == its plain version, exactly, on small, ragged,
               tie-heavy inputs with dead query terms, at B in {1, 3, 32} and
               th_r None and set
  4. full    — the planted index on the card at MS MARCO width; retrieve at
               B = 32 and B = 1 through both kernels (launch counts read
               around those runs only); each phase held against the plain
               versions on the same CS and LUT; the candidate funnel; the
               planted docs' Success@100 and MRR@10
  5. timing  — CUDA-event medians of every step, end to end, each kernel
               beside its plain version and its bound
  6. profile — torch.profiler over retrieve at B = 32 and B = 1: the
               device's busy share, device time and launches by CUDA
               kernel, and each hand-written kernel's __global__ launches
               per wrapper call (tables in chiprun_out/profile_b<B>.txt)
  7. kernels — one JSON line describing both kernels
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# The emvb-msmarco config (src/repro/configs/emvb_msmarco.py:12-28).
WIDTHS = dict(n_docs=8_841_823, cap=80, d=128, n_centroids=1 << 18, m=16,
              nbits=8, list_cap=4096)
MIN_LEN = 54          # lengths uniform in [54, 80]: MS MARCO's mean of ~67
ENGINE = dict(n_q=32, nprobe=4, th=0.4, th_r=0.5, n_filter=1024, n_docs=256,
              k=100)
N_QUERIES = 64        # two B = 32 batches
N_SINGLE = 8          # B = 1 queries
SUCCESS_FLOOR = 0.9

# H100 SXM data-sheet peaks (no measurement): HBM rate, float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    """Print one phase line and keep it for chiprun_out/chip_smoke.json."""
    RECORD[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _import_port():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)


# --- 1. device ---------------------------------------------------------------

def device_phase() -> dict:
    """Phase 1: refuse to run without CUDA; print the card and torch; TF32
    off. -> the device record of the last line."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs the port on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, **dev, torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return dev


# --- 2. build ----------------------------------------------------------------

def build_phase() -> None:
    """Phase 2: build every kernel source with nvcc, all at once."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all(verbose=True)
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(paths),
         flags=_build.NVCC_FLAGS)


# --- 3. kernel == plain at small shapes ---------------------------------------

def _exact(got, want) -> float:
    """Max |kernel - plain| over the outputs; raises unless every output is
    bit-identical (float32 compared by bits)."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"kernel output {g.dtype}{tuple(g.shape)} "
                                 f"vs plain {w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                if g.dtype == torch.float32 else torch.equal(g, w))
        if not same:
            raise AssertionError(f"kernel differs from its plain version "
                                 f"(max abs err {err})")
    return err


def _quant(rng, shape, scale, levels):
    import numpy as np
    x = np.round(rng.normal(size=shape) * scale * levels) / levels + 0.0
    return x.astype(np.float32)


def small_phase(dev) -> dict:
    """Phase 3: each kernel against its plain version on small, ragged,
    tie-heavy inputs. -> max abs error per kernel (0: exact)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import prefilter as kpf

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    err = {"prefilter": 0.0, "pqinter": 0.0}
    cases = 0
    for nb in (1, 3, 32):
        rng = np.random.default_rng(nb)
        n_q, n_c, n_docs, cap, n_filter = 32, 700, 5003, 17, 300
        cs = _quant(rng, (nb, n_q, n_c), 0.5, 4)
        codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
        lens = rng.integers(0, cap + 1, size=n_docs).astype(np.int32)
        codes[np.arange(cap)[None, :] >= lens[:, None]] = n_c
        bitmap = rng.random((nb, n_docs)) < 0.3
        qm = rng.random((nb, n_q)) < 0.8
        qm[:, 0] = True
        args = (t(cs), 0.25, t(codes), t(lens), t(bitmap), n_filter, t(qm))
        err["prefilter"] = max(err["prefilter"], _exact(
            ops.prefilter_batched(*args), kpf.prefilter_batched_ref(*args)))
        cases += 1

        nf, m, ksub, n_docs2, k = 700, 16, 256, 90, 25
        cs_t = _quant(rng, (nb, n_c, n_q), 0.5, 2)
        lut = _quant(rng, (nb, n_q, m, ksub), 0.1, 8)
        pcodes = rng.integers(0, n_c, size=(nb, nf, cap)).astype(np.int32)
        plens = rng.integers(0, cap + 1, size=(nb, nf)).astype(np.int32)
        pcodes[np.arange(cap) >= plens[..., None]] = n_c
        res = rng.integers(0, ksub, size=(nb, nf, cap, m)).astype(np.uint8)
        for th_r in (None, 0.25):
            args = (t(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                    n_docs2, k, t(qm))
            err["pqinter"] = max(err["pqinter"], _exact(
                ops.pqinter_batched(*args), kpq.pqinter_batched_ref(*args)))
            cases += 1
    torch.cuda.synchronize()
    emit("small", cases=cases, exact=True, max_abs_err=err)
    return err


# --- 4. the main path at full width -------------------------------------------

def _field_bytes(index) -> dict:
    return {f: getattr(index, f).numel() * getattr(index, f).element_size()
            for f in index._fields}


def prefilter_bound(cs, index, bitmap, n_filter) -> dict:
    """Least bytes the prefilter must move on these inputs: the CS, the
    bitmap, the term mask, the lengths and valid-token codes of every doc
    that is some query's candidate, and its outputs."""
    nb, n_q, n_c = cs.shape
    any_cand = bitmap.any(0)
    n_cand_docs = int(any_cand.sum())
    tokens = int(index.doc_lens[any_cand].sum())
    nbytes = (cs.numel() * 4 + bitmap.numel() + nb * n_q
              + n_cand_docs * 4 + tokens * 4
              + nb * n_filter * 8 + nb * n_c * 4)
    ops_ = nb * n_q * n_c + nb * tokens          # compares + word ORs
    return _bound(nbytes, ops_)


def pqinter_bound(cs_t, lut, codes, lens, sel2, n_docs, k) -> dict:
    """Least bytes the pqinter must move on these inputs: the survivors'
    valid-token codes and lengths, the CS^T rows those tokens touch, the
    LUT, the phase-3 winners' residual codes, the term mask, the outputs."""
    import torch
    nb, nf, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    m = lut.shape[2]
    valid = torch.arange(cap, device=codes.device) < lens[..., None]
    rows = (torch.arange(nb, device=codes.device)[:, None, None] * n_c
            + codes.clamp(0, n_c - 1).long())[valid]
    n_rows = int(torch.unique(rows).numel())
    win_tokens = int(torch.gather(lens, 1, sel2.long()).sum())
    tokens = int(lens.sum())
    nbytes = (tokens * 4 + nb * nf * 4 + n_rows * n_q * 4 + lut.numel() * 4
              + win_tokens * m + nb * n_q + nb * k * 8 + nb * n_docs * 8)
    ops_ = tokens * n_q + win_tokens * n_q * (m + 1)   # maxes + LUT adds
    return _bound(nbytes, ops_)


def _bound(nbytes: int, n_ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def hold_phases(index, q, cfg) -> dict:
    """One batch through the engine's own steps: each kernel against its
    plain version on the SAME CS, bitmap, LUT and survivor operands, and the
    composed result against ``retrieve``. Returns the intermediates."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import prefilter as kpf
    cs = teng.centroid_scores(q, index.centroids)
    bitmap = teng._candidates(index, cs, cfg)
    pf_args = (cs, cfg.th, index.codes, index.doc_lens, bitmap, cfg.n_filter)
    pf = ops.prefilter_batched(*pf_args)
    err_pf = _exact(pf, kpf.prefilter_batched_ref(*pf_args))
    sel1 = pf[1].long()
    lut = teng._query_lut(index, q)
    operands = teng._survivor_operands(index, cs, lut, sel1)
    pq_args = (*operands, cfg.th_r, cfg.n_docs, cfg.k)
    pq = ops.pqinter_batched(*pq_args)
    err_pq = _exact(pq, kpq.pqinter_batched_ref(*pq_args))
    return dict(cs=cs, bitmap=bitmap, pf=pf, sel1=sel1, lut=lut,
                operands=operands, pq=pq, err=(err_pf, err_pq),
                ids=torch.gather(sel1, 1, pq[1].long()).to(torch.int32))


def funnel(index, h, cfg) -> dict:
    """What the batch's phases did: candidates, the F distribution, ties at
    the n_filter cut, and the phase-3/4 spread."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.kernels import prefilter as kpf
    bits = bitvector.build_bitvectors(h["cs"], cfg.th)
    f = kpf.filter_scores_ref(bits, index.codes, index.doc_lens, h["bitmap"])
    cand = h["bitmap"].sum(1)
    hist = torch.bincount(f[f >= 0].long(), minlength=33)
    f_cut = h["pf"][0][:, -1:]
    tied = ((f == f_cut) & h["bitmap"]).sum(1)
    kept = (h["pf"][0] == f_cut).sum(1)
    return {"candidates_per_query": {"mean": float(cand.float().mean()),
                                     "min": int(cand.min()),
                                     "max": int(cand.max())},
            "F_histogram_over_candidates": hist.tolist(),
            "F_at_cut": h["pf"][0][:, -1].tolist(),
            "docs_tied_at_cut_mean": float(tied.float().mean()),
            "tied_docs_kept_mean": float(kept.float().mean()),
            "sbar_top_mean": float(h["pq"][3][:, 0].mean()),
            "sbar_cut_mean": float(h["pq"][3][:, -1].mean()),
            "score_top_mean": float(h["pq"][0][:, 0].mean()),
            "score_kth_mean": float(h["pq"][0][:, -1].mean())}


def full_phase(dev) -> dict:
    """Phase 4: the planted index at full width, the main path at B = 32
    and B = 1 with its launch counts, the held phases, funnel and
    quality."""
    import numpy as np
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, meta = synthetic.make_packed_index(0, min_len=MIN_LEN, device=dev,
                                              **WIDTHS)
    queries, gt = synthetic.make_queries(index, 1, N_QUERIES, ENGINE["n_q"])
    torch.cuda.synchronize()
    fb = _field_bytes(index)
    emit("index", seconds=time.perf_counter() - t0, **WIDTHS,
         min_len=MIN_LEN, n_tokens=meta.n_raw_tokens,
         n_dropped=meta.n_dropped, field_bytes=fb,
         total_gb=sum(fb.values()) / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)

    cfg = teng.EngineConfig(**ENGINE, use_kernels=True)
    batches = [queries[s:s + 32] for s in range(0, N_QUERIES, 32)]
    # the main path, B = 32: counts read just around these calls
    ops.reset_launches()
    res = [teng.retrieve(index, q, cfg) for q in batches]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # the main path, B = 1
    ops.reset_launches()
    res1 = [teng.retrieve(index, queries[i:i + 1], cfg)
            for i in range(N_SINGLE)]
    torch.cuda.synchronize()
    launches_b1 = ops.launch_counts()
    for name in ("prefilter", "pqinter"):
        if launches[name] != len(batches) or launches_b1[name] != N_SINGLE:
            raise AssertionError(
                f"{name} launched {launches[name]}x at B=32 (expected "
                f"{len(batches)}) and {launches_b1[name]}x at B=1 (expected "
                f"{N_SINGLE}): the main path did not run through it")

    ids = torch.cat([r.doc_ids for r in res])
    scores = torch.cat([r.scores for r in res])
    if ids.shape != (N_QUERIES, ENGINE["k"]) or not torch.isfinite(
            scores).all() or not (scores[:, :-1] >= scores[:, 1:]).all() \
            or not ((ids >= 0) & (ids < WIDTHS["n_docs"])).all():
        raise AssertionError("retrieve returned malformed results")
    gt_np = gt.cpu().numpy()
    ids_np = ids.cpu().numpy()
    ids1_np = torch.cat([r.doc_ids for r in res1]).cpu().numpy()
    quality = {
        "success_at_100": synthetic.success_at_k(ids_np, gt_np, 100),
        "mrr_at_10": synthetic.mrr_at_k(ids_np, gt_np, 10),
        "success_at_100_b1": synthetic.success_at_k(ids1_np,
                                                    gt_np[:N_SINGLE], 100),
        "mrr_at_10_b1": synthetic.mrr_at_k(ids1_np, gt_np[:N_SINGLE], 10),
        "b1_rows_equal_b32": int(sum(
            np.array_equal(ids1_np[i], ids_np[i]) for i in range(N_SINGLE))),
    }

    held = {}
    for name, q in (("b32", batches[0]), ("b1", queries[:1])):
        h = hold_phases(index, q, cfg)
        ref = res[0] if name == "b32" else res1[0]
        if not (torch.equal(h["ids"], ref.doc_ids) and torch.equal(
                h["pq"][0].view(torch.int32), ref.scores.view(torch.int32))):
            raise AssertionError(f"{name}: the held phases do not compose "
                                 "to retrieve's result")
        held[name] = h
    fun = funnel(index, held["b32"], cfg)
    emit("full", launches_b32=launches, launches_b1=launches_b1,
         phases_exact=True, funnel=fun, **quality,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if quality["success_at_100"] < SUCCESS_FLOOR:
        raise AssertionError(f"planted Success@100 "
                             f"{quality['success_at_100']} < {SUCCESS_FLOOR}")
    return dict(index=index, cfg=cfg, queries=queries, held=held,
                launches=launches, launches_b1=launches_b1)


# --- 5. timing -----------------------------------------------------------------

def time_samples(fn, n: int = 10, warmup: int = 2, flush=None) -> list:
    """CUDA-event times (ms) of ``n`` runs of ``fn`` after ``warmup``;
    ``flush`` (a large tensor) is rewritten before each run so L2 is cold."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_ms(fn, **kw) -> float:
    """Median of :func:`time_samples`."""
    return statistics.median(time_samples(fn, **kw))


def latency_stats(times: list) -> dict:
    """Median and the highest percentile with at least ten samples beyond
    it (p80 of 50, p90 of 100), with the sample count."""
    ts = sorted(times)
    n = len(ts)
    pct = 100 * (n - 10) // n // 10 * 10
    return {"median_ms": statistics.median(ts), f"p{pct}_ms":
            ts[min(n - 1, -(-pct * n // 100) - 1)], "n": n}


def timing_phase(full: dict) -> dict:
    """Phase 5: every step, end to end, each kernel beside its plain
    version and its bound, at B = 32 and B = 1."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import prefilter as kpf
    index, cfg = full["index"], full["cfg"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    out = {}
    for name, q in (("b32", full["queries"][:32]),
                    ("b1", full["queries"][:1])):
        h = full["held"][name]
        cs, bitmap, sel1 = h["cs"], h["bitmap"], h["sel1"]
        probe = bitvector.masked_topk_centroids(cs, cfg.th, cfg.nprobe)
        pf_args = (cs, cfg.th, index.codes, index.doc_lens, bitmap,
                   cfg.n_filter)
        pq_args = (*h["operands"], cfg.th_r, cfg.n_docs, cfg.k)
        steps = {
            "cs_matmul": lambda: teng.centroid_scores(q, index.centroids),
            "probe_topk": lambda: bitvector.masked_topk_centroids(
                cs, cfg.th, cfg.nprobe),
            "bitmap": lambda: teng.candidate_bitmap(
                index.ivf, index.ivf_lens, probe, index.codes.shape[0]),
            "prefilter_kernel": lambda: ops.prefilter_batched(*pf_args),
            "lut_and_gathers": lambda: teng._survivor_operands(
                index, cs, teng._query_lut(index, q), sel1),
            "pqinter_kernel": lambda: ops.pqinter_batched(*pq_args),
        }
        ms = {k: time_ms(fn, flush=flush) for k, fn in steps.items()}
        e2e = latency_stats(time_samples(
            lambda: teng.retrieve(index, q, cfg), n=50 if name == "b32"
            else 100, flush=flush))
        ms["end_to_end"] = e2e["median_ms"]
        t0 = time.perf_counter()
        for _ in range(5):
            teng.retrieve(index, q, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        plain = {
            "prefilter": time_ms(lambda: kpf.prefilter_batched_ref(*pf_args),
                                 n=3, warmup=1, flush=flush),
            "pqinter": time_ms(lambda: kpq.pqinter_batched_ref(*pq_args),
                               n=5, warmup=1, flush=flush),
        }
        bounds = {
            "prefilter": prefilter_bound(cs, index, bitmap, cfg.n_filter),
            "pqinter": pqinter_bound(h["operands"][0], h["operands"][1],
                                     h["operands"][2], h["operands"][4],
                                     h["pq"][2], cfg.n_docs, cfg.k),
        }
        nb = q.shape[0]
        out[name] = dict(step_ms=ms, end_to_end=e2e, plain_ms=plain,
                         bounds=bounds, host_ms_per_batch=host_ms,
                         qps=nb * 1e3 / ms["end_to_end"])
        emit(f"timing_{name}", batch=nb, **out[name])
    return out


# --- 6. device time by kernel ---------------------------------------------------

# The __global__ functions each wrapper launches, in launch order.
KERNEL_FUNCTIONS = {
    "prefilter": ("pack_kernel", "score_kernel", "threshold_kernel",
                  "collect_kernel", "sort_kernel"),
    "pqinter": ("sbar_kernel", "select1_kernel", "eq56_kernel",
                "select2_kernel"),
}


def profile_phase(full: dict, calls: int = 5) -> dict:
    """Phase 6: ``torch.profiler`` over ``calls`` ``retrieve`` calls at
    B = 32 and B = 1 on the index already built: the device's busy share
    of the profiled window, device time and launches per call by CUDA
    kernel, and each hand-written kernel's __global__ launches per wrapper
    call. The profiler's table goes to chiprun_out/profile_b<B>.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    index, cfg = full["index"], full["cfg"]
    smi = RECORD["device"]["nvidia_smi"]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    out = {}
    for name, q in (("b32", full["queries"][:32]),
                    ("b1", full["queries"][:1])):
        for _ in range(3):
            teng.retrieve(index, q, cfg)
        torch.cuda.synchronize()
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                teng.retrieve(index, q, cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        wrapper_calls = ops.launch_counts()
        averages = prof.key_averages()
        # device-side events only (kernels, copies): an aten op's row
        # repeats the time of the kernels it launched
        events = sorted((e for e in averages if e.device_type ==
                         DeviceType.CUDA and dev_us(e) > 0),
                        key=dev_us, reverse=True)
        if not events:
            raise AssertionError("the profiler saw no device time")
        busy_us = sum(dev_us(e) for e in events)
        per_wrapper = {}
        for kern, fns in KERNEL_FUNCTIONS.items():
            n = sum(e.count for e in events
                    if any(e.key.startswith(f"(anonymous namespace)::{fn}(")
                           for fn in fns))
            per_wrapper[kern] = n / wrapper_calls[kern]
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
            f.write(f"{smi}\n" + averages.table(
                sort_by="self_cuda_time_total", row_limit=40) + "\n")
        out[name] = {
            "calls": calls,
            "wall_ms_per_call": wall_us / calls / 1e3,
            "device_busy_ms_per_call": busy_us / calls / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_launches_per_call": sum(e.count for e in events) / calls,
            "kernel_launches_per_wrapper_call": per_wrapper,
            "by_kernel_ms_per_call": {
                e.key[:90]: dev_us(e) / calls / 1e3 for e in events[:25]},
            "launches_per_call": {
                e.key[:90]: e.count / calls for e in events[:25]},
        }
        emit(f"profile_{name}", **out[name])
    return out


# --- 7. the kernels line ---------------------------------------------------------

KERNELS = {
    "prefilter": dict(
        source="src/repro_torch/kernels/csrc/prefilter.cu",
        replaces="src/repro/kernels/prefilter.py:163",
        replaces_b1="src/repro/kernels/prefilter.py:258"),
    "pqinter": dict(
        source="src/repro_torch/kernels/csrc/pqinter.cu",
        replaces="src/repro/kernels/pqinter.py:322",
        replaces_b1="src/repro/kernels/pqinter.py:159"),
}


def kernels_line(small_err: dict, full: dict, timing: dict,
                 prof: dict) -> dict:
    """Phase 6: one record per kernel, from this run's measurements."""
    rows = []
    for i, (name, info) in enumerate(KERNELS.items()):
        t32, t1 = timing["b32"], timing["b1"]
        err = max(small_err[name], full["held"]["b32"]["err"][i],
                  full["held"]["b1"]["err"][i])
        rows.append({
            "name": name, "route": "cuda", **info,
            "launches": full["launches"][name],
            "launches_b1": full["launches_b1"][name],
            "kernel_launches_per_call": prof["b32"][
                "kernel_launches_per_wrapper_call"][name],
            "max_abs_err": err,
            "ms": t32["step_ms"][f"{name}_kernel"],
            "plain_ms": t32["plain_ms"][name],
            "bound_ms": t32["bounds"][name]["bound_ms"],
            "bound_by": t32["bounds"][name]["bound_by"],
            "bound_bytes": t32["bounds"][name]["bytes"],
            "library_ms": None,
            "ms_b1": t1["step_ms"][f"{name}_kernel"],
            "plain_ms_b1": t1["plain_ms"][name],
            "bound_ms_b1": t1["bounds"][name]["bound_ms"],
            "ok": True,
        })
    return {"kernels": rows}


def main() -> None:
    """Run every phase in order; any failure raises."""
    _import_port()
    import torch
    dev_info = device_phase()
    dev = torch.device("cuda")
    build_phase()
    small_err = small_phase(dev)
    full = full_phase(dev)
    timing = timing_phase(full)
    prof = profile_phase(full)
    line = kernels_line(small_err, full, timing, prof)
    RECORD["kernels"] = line["kernels"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": dev_info}), flush=True)


if __name__ == "__main__":
    main()
