"""MODEL_FLOPS — the *algorithmically required* flops of one step
(counterpart of ``repro/launch/modelflops.py``, formula for formula), used
for the roofline's "useful flops" ratio (how much of the counted compute is
the model vs remat/padding/redundancy).

LM family keeps the classic 6·N·D (train) / 2·N·D (inference) with N =
(active) params. RecSys/GNN/retrieval use exact per-shape formulas: their
parameter counts are dominated by embedding tables that are *looked up*, not
multiplied, per sample — 6·N·D over table params overcounts by orders of
magnitude.
"""
from __future__ import annotations

from typing import Optional

from ..configs.registry import ArchSpec


def _mlp_macs(dims: tuple[int, ...]) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def _dlrm_fwd(batch: int) -> float:
    bot = _mlp_macs((13, 512, 256, 128))
    inter = 27 * 27 * 128                       # dot-interaction gram
    top = _mlp_macs((479, 1024, 1024, 512, 256, 1))
    return 2.0 * batch * (bot + inter + top)


def _dcn_fwd(batch: int) -> float:
    d_in = 13 + 26 * 16                          # 429
    cross = 3 * d_in * d_in
    mlp = _mlp_macs((d_in, 1024, 1024, 512)) + (d_in + 512)
    return 2.0 * batch * (cross + mlp)


def _dien_fwd(batch: int) -> float:
    d_in, gru = 36, 108                          # item+cat embed, gru_dim
    per_step = 2 * 3 * (d_in + gru) * gru + gru * d_in   # GRU+AUGRU+attention
    mlp = _mlp_macs((gru + d_in + 36, 200, 80)) + 80
    return 2.0 * batch * (100 * per_step + mlp)


def _mind_fwd(batch: int) -> float:
    seq, d, n_i, iters = 50, 64, 4, 3
    u_hat = seq * d * d                          # shared bilinear map
    routing = iters * 2 * seq * n_i * d
    return 2.0 * batch * (u_hat + routing + n_i * d)


def _gcn_fwd(cell) -> float:
    dims = cell.dims
    feat = dims.get("d_feat", 0)
    if "batch_nodes" in dims:                    # sampled minibatch
        b, f0, f1 = dims["batch_nodes"], dims["fanout0"], dims["fanout1"]
        n_sub = b * (1 + f0 + f0 * f1)
        e_sub = b * (f0 + f0 * f1)
        n1 = b * (1 + f0)                        # nodes needing layer-2 input
        return 2.0 * (n_sub * feat * 16 + e_sub * 16 + n1 * 16 * 41 + e_sub * 41)
    n, e = dims["n_nodes"], dims["n_edges"]
    ncls = {1433: 7, 100: 47, 32: 16}.get(feat, 8)
    return 2.0 * (n * feat * 16 + e * 16 + n * 16 * ncls + e * ncls)


def _emvb_fwd(batch: int) -> float:
    # CS matmul + centroid interaction on n_filter docs + PQ phase on n_docs
    n_q, d, n_c, cap = 32, 128, 1 << 18, 80
    n_filter, n_docs, m = 1024, 256, 16
    cs = n_q * d * n_c
    cinter = n_filter * cap * n_q
    pq = n_docs * cap * n_q * (m + 1)
    return 2.0 * batch * (cs + cinter + pq)


def model_flops(spec: ArchSpec, shape: str) -> Optional[float]:
    cell = spec.shapes[shape]
    mf = spec.model_flops_params or {}
    if spec.family == "lm":
        n = mf.get("n_active") or mf.get("n_params")
        if not n:
            return None
        if cell.kind == "train":
            return 6.0 * n * cell.dims["batch"] * cell.dims["seq"]
        if cell.kind == "prefill":
            return 2.0 * n * cell.dims["batch"] * cell.dims["seq"]
        if cell.kind == "decode":
            return 2.0 * n * cell.dims["batch"]
        return None
    if spec.family == "gnn":
        return 3.0 * _gcn_fwd(cell)              # fwd+bwd = 3x fwd
    if spec.family == "retrieval":
        return _emvb_fwd(cell.dims.get("query_batch", 1))
    if spec.family == "recsys":
        fwd = {"dlrm-mlperf": _dlrm_fwd, "dcn-v2": _dcn_fwd,
               "dien": _dien_fwd, "mind": _mind_fwd}.get(spec.name)
        if fwd is None:
            return None
        if cell.kind == "retrieval":
            b = cell.dims["n_candidates"]
            if spec.name == "mind":
                # user tower once + MaxSim over the candidate corpus
                return _mind_fwd(1) + 2.0 * b * 4 * 64
            return fwd(b)                        # ranking models re-run per cand
        mult = 3.0 if cell.kind == "train" else 1.0
        return mult * fwd(cell.dims["batch"])
    return None
