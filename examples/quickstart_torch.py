"""Quickstart on the PyTorch port: build an EMVB index over a synthetic
corpus and retrieve, on the card unless asked otherwise. The counterpart of
``examples/quickstart.py``:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Walks the paper's full pipeline: synthetic corpus with planted relevance ->
k-means centroids + PQ residuals -> bit-vector pre-filter -> centroid
interaction -> PQ late interaction -> top-k, on the fused kernel lane; then
the PLAID baseline on the same index for comparison.
"""
import argparse
import time

import torch

from repro_torch.core import EngineConfig, PlaidConfig, build_index
from repro_torch.core import engine, plaid
from repro_torch.data.synthetic import make_corpus, mrr_at_k, recall_at_k
from repro_torch.device import resolve_device


def _timed(fn, dev: torch.device):
    """(fn's result, seconds of its second call): the first call builds and
    warms what it needs."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(n_docs: int = 2048, n_centroids: int = 1024, n_queries: int = 64,
         device=None) -> dict:
    """Sizes are parameters so a test can run the same code on a tiny
    corpus. Returns both methods' ids, MRR@10 and seconds."""
    dev = resolve_device(device)
    print(f"1) synthetic corpus with planted ground truth ({dev}) ...")
    corpus = make_corpus(0, n_docs=n_docs, cap=48, n_queries=n_queries)

    print("2) building index (k-means centroids, PQ m=16, PLAID 2-bit) ...")
    t0 = time.time()
    index, meta = build_index(0, corpus.doc_embs, corpus.doc_lens,
                              n_centroids=n_centroids, m=16, nbits=8,
                              plaid_b=2, kmeans_iters=4, device=dev)
    print(f"   {meta.n_docs} docs / {meta.n_centroids} centroids "
          f"in {time.time() - t0:.1f}s")

    queries = torch.from_numpy(corpus.queries).to(dev)
    # th calibrated to this corpus's score distribution, as the reference's;
    # the budgets clamp to the corpus on tiny ones
    cfg = EngineConfig(k=10, n_filter=min(512, n_docs),
                       n_docs=min(64, n_docs), th=0.2, th_r=0.3,
                       use_kernels=True)

    print("3) EMVB retrieval (bit-vector prefilter + PQ late interaction) ...")
    res, t_emvb = _timed(lambda: engine.retrieve(index, queries, cfg,
                                                 device=dev), dev)

    print("4) PLAID baseline (full centroid interaction + decompression) ...")
    pcfg = PlaidConfig(k=10, n_docs=min(64, n_docs))
    pres, t_plaid = _timed(lambda: plaid.retrieve(index, queries, pcfg,
                                                  device=dev), dev)

    ids_e, ids_p = res.doc_ids.cpu().numpy(), pres.doc_ids.cpu().numpy()
    mrr_e, mrr_p = mrr_at_k(ids_e, corpus.gt_doc), mrr_at_k(ids_p,
                                                            corpus.gt_doc)
    print(f"\n   EMVB : mrr@10={mrr_e:.3f} "
          f"r@10={recall_at_k(ids_e, corpus.gt_doc, 10):.3f} "
          f"({t_emvb / len(queries) * 1e3:.2f} ms/q)")
    print(f"   PLAID: mrr@10={mrr_p:.3f} "
          f"r@10={recall_at_k(ids_p, corpus.gt_doc, 10):.3f} "
          f"({t_plaid / len(queries) * 1e3:.2f} ms/q)")
    print(f"   speedup x{t_plaid / t_emvb:.2f} "
          f"(paper Table 1: 2.1-2.8x at equal quality)")
    return {"emvb_ids": ids_e, "plaid_ids": ids_p, "mrr_emvb": mrr_e,
            "mrr_plaid": mrr_p, "emvb_s": t_emvb, "plaid_s": t_plaid,
            "gt": corpus.gt_doc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
