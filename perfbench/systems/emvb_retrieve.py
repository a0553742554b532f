"""The system under test: ``repro_torch.core.engine.retrieve(index,
queries, cfg)`` on the fused kernel lane (``use_kernels=True``, float32 CS),
the call that batch users make and that ``RetrievalService``'s miss lane
makes.

Set-up is the program's own: ``core.index.build_ivf`` lays out the inverted
file over the benchmark's codes, and the ``PackedIndex`` holds the tensors
the benchmark made (its identity OPQ rotation, and PLAID fields at their
smallest shapes, as the port's planted index has them). Filters are
compiled by the program's ``bitvector.compile_filter``, one a predicate.
"""
from __future__ import annotations

import torch

PREDICATE = "p{}"


class System:
    """One index and configuration, ready to serve batches."""

    def __init__(self, data, plane, config: dict, device: torch.device):
        from repro_torch.core import bitvector, engine
        from repro_torch.core.index import PackedIndex, build_ivf
        self.engine = engine
        self.device = None if device.type == "cuda" else str(device)
        n_c, d = data.centroids.shape
        ivf, ivf_lens, self.list_cap, self.n_dropped = build_ivf(
            data.codes, n_c, config["list_cap"], origin="perfbench")
        n_docs = data.codes.shape[0]
        if plane is None:
            plane = torch.zeros(n_docs, dtype=torch.uint32,
                                device=data.codes.device)
        dev = data.codes.device
        self.index = PackedIndex(
            centroids=data.centroids, codes=data.codes,
            doc_lens=data.doc_lens, res_codes=data.res_codes,
            pq_codebooks=data.pq_codebooks, ivf=ivf, ivf_lens=ivf_lens,
            plaid_res=torch.zeros((1, 1, 1), dtype=torch.uint8, device=dev),
            plaid_cutoffs=torch.zeros(3, device=dev),
            plaid_weights=torch.zeros(4, device=dev),
            opq_rotation=torch.eye(d, device=dev), pred_words=plane)
        eng = config["engine"]
        self.cfg = engine.EngineConfig(
            n_q=eng["n_q"], nprobe=eng["nprobe"], th=eng["th"],
            th_r=eng["th_r"], n_filter=eng["n_filter"], n_docs=eng["n_docs"],
            k=eng["k"], use_kernels=True, cs_dtype=eng["cs_dtype"])
        names = tuple(PREDICATE.format(i) for i in range(32))
        self.plans = [bitvector.compile_filter(bitvector.Pred(n), names)
                      for n in names]

    def __call__(self, queries: torch.Tensor, predicate=None):
        """One batch -> (scores (B, k), doc ids (B, k)) on the device."""
        plan = None if predicate is None else self.plans[predicate]
        res = self.engine.retrieve(self.index, queries, self.cfg,
                                   doc_filter=plan, device=self.device)
        return res.scores, res.doc_ids

    def close(self) -> None:
        """Drop the program's state (its IVF, its config)."""
        self.index = self.cfg = self.plans = None
