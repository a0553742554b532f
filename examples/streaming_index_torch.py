"""Index lifecycle on the PyTorch port — persistence, incremental growth,
and multi-generation (PLAID SHIRTTT-style) streaming retrieval, on the card
unless asked otherwise. The counterpart of ``examples/streaming_index.py``:

    PYTHONPATH=src python examples/streaming_index_torch.py
    PYTHONPATH=src python examples/streaming_index_torch.py --device cpu

The corpus arrives in four slices. The demo:
  1. builds an index over slice 0 and saves/loads it (bit-exact round trip);
  2. grows it in place with ``add_passages`` (no k-means re-run) and reads
     the quantization-drift statistic that tells you when to re-train;
  3. serves slices 1..3 as immutable generations of a ``ShardedTimeline``,
     watching MRR@10 climb as the corpus streams in;
  4. persists and reloads the whole timeline.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.core import (EngineConfig, ShardedTimeline, add_passages,
                              build_index, engine, load_index, load_timeline,
                              new_generation, retrieve_timeline, save_index,
                              save_timeline)
from repro_torch.data.synthetic import make_corpus, mrr_at_k
from repro_torch.device import resolve_device


def _same(a, b) -> bool:
    return (torch.equal(a.doc_ids, b.doc_ids)
            and torch.equal(a.scores.view(torch.int32),
                            b.scores.view(torch.int32)))


def main(n_docs: int = 2048, n_centroids: int = 512, n_queries: int = 64,
         device=None) -> dict:
    """Sizes are parameters so a test can run the same code on a tiny
    corpus. Returns the MRR@10 after each generation and the two
    round-trip verdicts."""
    dev = resolve_device(device)
    corpus = make_corpus(0, n_docs=n_docs, cap=48, n_queries=n_queries)
    queries = torch.from_numpy(corpus.queries).to(dev)
    per = n_docs // 4                     # the corpus arrives in 4 slices
    # selection budgets clamp to the slice size on tiny corpora
    cfg = EngineConfig(k=10, n_filter=min(256, per), n_docs=min(64, per),
                       th=0.2, th_r=0.3, use_kernels=True)

    print(f"1) build generation 0 over the first slice ({dev}) ...")
    t0 = time.time()
    gen0, meta0 = build_index(
        0, corpus.doc_embs[:per], corpus.doc_lens[:per],
        n_centroids=n_centroids, m=16, nbits=8, kmeans_iters=4, device=dev)
    print(f"   {meta0.n_docs} docs, {meta0.n_centroids} centroids "
          f"in {time.time() - t0:.1f}s "
          f"(train_quant_mse={meta0.train_quant_mse:.3f})")

    mrrs = []
    with tempfile.TemporaryDirectory() as tmp:
        print("2) save -> load round trip (bit-exact) ...")
        path = save_index(f"{tmp}/gen0", gen0, meta0)
        loaded, _ = load_index(path, device=dev)
        exact = _same(engine.retrieve(gen0, queries, cfg, device=dev),
                      engine.retrieve(loaded, queries, cfg, device=dev))
        print(f"   retrieval on loaded index bit-exact "
              f"(ids AND score bits): {exact}")

        print("3) grow the index in place with add_passages "
              "(frozen codebooks, no k-means) ...")
        grown, gmeta = add_passages(gen0, meta0, corpus.doc_embs[per:2 * per],
                                    corpus.doc_lens[per:2 * per], device=dev)
        print(f"   {meta0.n_docs} -> {gmeta.n_docs} docs; "
              f"n_grown={gmeta.n_grown}, drift=x{gmeta.drift:.2f} "
              "(>> 1 would mean: re-train the codebooks)")

        print("4) stream the corpus as a ShardedTimeline of immutable "
              "generations ...")
        timeline = ShardedTimeline.of((gen0, meta0))
        for g in range(1, 4):
            lo = g * per
            timeline = timeline.append(*new_generation(
                gen0, meta0, corpus.doc_embs[lo:lo + per],
                corpus.doc_lens[lo:lo + per], device=dev))
            res = retrieve_timeline(timeline, queries, cfg, device=dev)
            mrr = mrr_at_k(res.doc_ids.cpu().numpy(), corpus.gt_doc)
            mrrs.append(mrr)
            print(f"   gens={g + 1} docs={timeline.n_docs} "
                  f"mrr@10={mrr:.3f} "
                  f"drift=x{timeline.metas[-1].drift:.2f}")

        print("5) persist + reload the whole timeline ...")
        save_timeline(f"{tmp}/timeline", timeline)
        reloaded = load_timeline(f"{tmp}/timeline", device=dev)
        same = _same(res, retrieve_timeline(reloaded, queries, cfg,
                                            device=dev))
        print(f"   {len(reloaded)} generations reloaded; retrieval "
              f"identical: {same}")
    return {"mrr": mrrs, "round_trip_exact": exact, "timeline_same": same}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
