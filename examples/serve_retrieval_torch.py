"""Distributed EMVB serving on the PyTorch port — the production execution
plan over a ``torch.distributed`` group, on the card unless asked
otherwise. The counterpart of ``examples/serve_retrieval.py`` (which runs
on 8 host devices):

    PYTHONPATH=src python examples/serve_retrieval_torch.py
    PYTHONPATH=src python examples/serve_retrieval_torch.py --device cpu

Each of ``n_shards`` ranks (processes of this script, joined in a gloo
group through a file) owns a doc shard with a local IVF, runs the full
four-phase pipeline for every request in the batch, and the shards merge
with a two-level top-k (one small all-gather). Over gloo the ranks share
one card: gloo is the backend for several ranks on one device, the (B, k)
partials crossing through the host. Prints per-batch latency and the
sharded result's top-1 agreement with the unsharded ``retrieve``.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import (EngineConfig, build_index, engine, load_index,
                              save_index)
from repro_torch.data.synthetic import make_corpus, mrr_at_k
from repro_torch.device import resolve_device

REPEATS = 5          # timed calls of the sharded plan after one warm-up


def _config(nf: int, nd: int) -> EngineConfig:
    return EngineConfig(k=10, n_filter=nf, n_docs=nd, th=0.2, th_r=0.3,
                        use_kernels=True)


def rank_main(rank: int, world: int, init_file: str, index_path: str,
              queries_path: str, out_dir: str, nf: int, nd: int,
              device: str) -> None:
    """One rank: join the gloo group, load the saved index on ``device``,
    shard it, serve the queries through the sharded plan (one warm-up,
    then REPEATS timed calls); rank 0 writes the ids and latencies."""
    import torch.distributed as dist

    from repro_torch.launch.serve import make_shardmap_retriever, shard_index
    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        index, _ = load_index(index_path, device=dev)
        stacked = shard_index(index, world, device=dev)
        run = make_shardmap_retriever(None, _config(nf, nd), device=dev)
        queries = torch.from_numpy(np.load(queries_path)).to(dev)
        run(stacked, queries)
        lat = []
        for _ in range(REPEATS):
            dist.barrier()
            t0 = time.perf_counter()
            res = run(stacked, queries)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            lat.append(time.perf_counter() - t0)
        if rank == 0:
            np.savez(os.path.join(out_dir, "sharded.npz"),
                     ids=res.doc_ids.cpu().numpy(), lat=np.asarray(lat))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(world: int, args: list) -> None:
    """Run ``world`` ranks of this script and wait for all of them."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["repro_torch"].__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), "--world", str(world),
                               *args], env=env) for r in range(world)]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")


def main(n_docs: int = 2048, n_centroids: int = 512, n_queries: int = 32,
         n_shards: int = 8, device=None) -> dict:
    """Sizes are parameters so a test can run the same code on a tiny
    corpus. Returns the sharded and unsharded ids and the latencies."""
    dev = resolve_device(device)
    print(f"ranks: {n_shards} (gloo, {dev})")
    corpus = make_corpus(3, n_docs=n_docs, cap=32, n_queries=n_queries)
    index, meta = build_index(0, corpus.doc_embs, corpus.doc_lens,
                              n_centroids=n_centroids, m=8, kmeans_iters=4,
                              device=dev)
    # selection budgets clamp to the per-rank shard size on tiny corpora
    nf, nd = min(128, n_docs // n_shards), min(32, n_docs // n_shards)

    print("sharding index across ranks (local IVFs, two-level top-k) ...")
    with tempfile.TemporaryDirectory() as tmp:
        path = save_index(os.path.join(tmp, "index"), index, meta)
        np.save(os.path.join(tmp, "queries.npy"), corpus.queries)
        _spawn(n_shards, ["--init", os.path.join(tmp, "init"),
                          "--index", path,
                          "--queries", os.path.join(tmp, "queries.npy"),
                          "--out", tmp, "--nf", str(nf), "--nd", str(nd),
                          "--device", dev.type])
        out = np.load(os.path.join(tmp, "sharded.npz"))
        ids_sharded, lat = out["ids"], out["lat"]

    # single-device reference on the unsharded index
    queries = torch.from_numpy(corpus.queries).to(dev)
    ref = engine.retrieve(index, queries, _config(nf * n_shards,
                                                  nd * n_shards), device=dev)
    ids_ref = ref.doc_ids.cpu().numpy()

    mrr_s = mrr_at_k(ids_sharded, corpus.gt_doc)
    mrr_r = mrr_at_k(ids_ref, corpus.gt_doc)
    b = len(queries)
    agree = float((ids_sharded[:, 0] == ids_ref[:, 0]).mean())
    print(f"\nsharded  mrr@10={mrr_s:.3f}   reference mrr@10={mrr_r:.3f}")
    print(f"top-1 agreement: {agree * 100:.0f}%")
    print(f"latency: {np.median(lat) / b * 1e3:.2f} ms/query "
          f"(batch={b}, {n_shards}-way doc sharding + two-level top-k)")
    return {"ids_sharded": ids_sharded, "ids_ref": ids_ref,
            "top1_agreement": agree, "latency_s": lat, "gt": corpus.gt_doc}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init")
    ap.add_argument("--index")
    ap.add_argument("--queries")
    ap.add_argument("--out")
    ap.add_argument("--nf", type=int)
    ap.add_argument("--nd", type=int)
    a = ap.parse_args()
    if a.rank is None:
        main(device=a.device)
    else:
        rank_main(a.rank, a.world, a.init, a.index, a.queries, a.out, a.nf,
                  a.nd, a.device)
