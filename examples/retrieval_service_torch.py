"""The serving subsystem on the PyTorch port — per-generation result caching
and request micro-batching over a streaming ShardedTimeline, on the card
unless asked otherwise. The counterpart of ``examples/retrieval_service.py``:

    PYTHONPATH=src python examples/retrieval_service_torch.py
    PYTHONPATH=src python examples/retrieval_service_torch.py --device cpu

The demo:
  1. streams a corpus into a 3-generation timeline and stands up a
     ``RetrievalService`` over it;
  2. shows the cold -> warm transition on repeated queries (bit-exact vs
     the uncached ``retrieve_timeline``, at a fraction of the cost);
  3. micro-batches heterogeneous-length queries through submit/flush (a
     padded, masked query's result equals the unpadded query's);
  4. mutates the timeline — ``add_passages`` on the open generation, then
     ``new_generation`` — and watches the cache invalidate by fingerprint
     (old generations keep hitting; changed ones recompute);
  5. prints the metrics snapshot: hit rate, warm share, p50/p99 latency,
     cache bytes, timeline footprint;
  6. turns on observability: scoped span tracing over a served batch, the
     per-phase ``explain_timeline`` funnel for one query, and a Prometheus
     exposition excerpt.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (EngineConfig, ShardedTimeline, build_index,
                              new_generation, retrieve_timeline)
from repro_torch.data.synthetic import make_corpus
from repro_torch.device import resolve_device
from repro_torch.serving import RetrievalService


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(n_docs: int = 2048, n_centroids: int = 512, n_queries: int = 64,
         device=None) -> dict:
    """Sizes are parameters so a test can run the same code on a tiny
    corpus. Returns the verdicts and the metrics snapshot."""
    dev = resolve_device(device)
    corpus = make_corpus(0, n_docs=n_docs, cap=48, n_queries=n_queries)
    per = n_docs // 4                     # generation size
    # selection budgets clamp to the generation size on tiny corpora
    cfg = EngineConfig(k=10, n_filter=min(256, per), n_docs=min(64, per),
                       th=0.2, th_r=0.3, use_kernels=True)

    print(f"1) stream 3 generations and stand up the service ({dev}) ...")
    gen0, meta0 = build_index(
        0, corpus.doc_embs[:per], corpus.doc_lens[:per],
        n_centroids=n_centroids, m=16, nbits=8, kmeans_iters=4, device=dev)
    timeline = ShardedTimeline.of((gen0, meta0))
    for g in range(1, 3):
        lo = g * per
        timeline = timeline.append(*new_generation(
            gen0, meta0, corpus.doc_embs[lo:lo + per],
            corpus.doc_lens[lo:lo + per], device=dev))
    service = RetrievalService(timeline, cfg, device=dev)
    nq = min(16, n_queries - 2)
    queries = corpus.queries[:nq]

    print("2) cold -> warm on repeated queries ...")
    ref = retrieve_timeline(timeline, corpus.queries[:nq], cfg, device=dev)
    t0 = time.perf_counter()
    cold = service.query(queries)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = service.query(queries)
    t_warm = time.perf_counter() - t0
    exact = all(
        np.array_equal(_np(a), _np(b))
        for r in (cold, warm) for a, b in ((r.doc_ids, ref.doc_ids),
                                           (r.scores, ref.scores)))
    print(f"   cold {t_cold * 1e3:.0f}ms -> warm {t_warm * 1e3:.0f}ms "
          f"(x{t_cold / t_warm:.1f}); bit-exact vs retrieve_timeline "
          f"(ids AND scores, both passes): {exact}")

    print("3) micro-batch heterogeneous queries via submit/flush ...")
    qa = min(20, n_queries - 2)           # two queries past the warm set
    short = service.submit(corpus.queries[qa][:12])     # 12-term query
    full = service.submit(corpus.queries[qa + 1])       # all 32 terms
    service.flush()
    ref12 = retrieve_timeline(timeline, corpus.queries[qa:qa + 1, :12], cfg,
                              device=dev)
    padded_ok = np.array_equal(short.result()[1], _np(ref12.doc_ids)[0])
    print(f"   12-term ticket == unpadded-prefix retrieval: {padded_ok}"
          f"; full-length ticket done: {full.done}")

    print("4) mutate: add_passages on the open generation, then freeze ...")
    h0 = service.cache.hits
    grow = 3 * per + per // 2             # grow by half a slice, then freeze
    service.add_passages(corpus.doc_embs[3 * per:grow],
                         corpus.doc_lens[3 * per:grow])
    service.query(queries)      # old gens hit, grown gen recomputed
    print(f"   after add_passages: {service.cache.hits - h0} cache hits "
          "(old generations), grown generation recomputed fresh")
    service.new_generation(corpus.doc_embs[grow:], corpus.doc_lens[grow:])
    service.query(queries)      # previously-open gen now caching too
    service.query(queries)
    print(f"   after new_generation: {len(service.timeline)} generations, "
          f"{service.timeline.n_docs} docs; newly frozen generation now "
          "cacheable")

    print("5) metrics snapshot ...")
    s = service.stats()
    print(f"   hit_rate={s['cache']['hit_rate']:.2f} "
          f"warm_fraction={s['warm_fraction']:.2f} "
          f"p50={s['latency']['p50_ms']:.1f}ms "
          f"p99={s['latency']['p99_ms']:.1f}ms")
    print(f"   cache={s['cache']['bytes'] / 1024:.1f}KiB "
          f"({s['cache']['entries']} partials), "
          f"timeline={s['timeline']['total_bytes'] / 2**20:.1f}MiB "
          f"({s['timeline']['bytes_per_embedding_actual']:.1f} B/emb actual "
          f"vs {s['timeline']['bytes_per_embedding']:.1f} paper constant)")

    print("6) observability: spans, explain funnel, exposition ...")
    with obs.tracing() as tracer:          # scoped: no-op outside the with
        service.query(queries)
    names = sorted({sp["name"] for sp in tracer.finished()})
    print(f"   {len(tracer.finished())} spans from one served batch: "
          + ", ".join(names))

    funnel = obs.explain.explain_timeline(service.timeline, queries[0], cfg,
                                          device=dev)
    g0 = funnel.generations[0]
    print(f"   explain: {funnel.n_generations} generations, contributions "
          f"{[g.contribution for g in funnel.generations]} (sum = k = "
          f"{funnel.k}); gen0 funnel: {g0.funnel.candidates} candidates -> "
          f"{g0.funnel.n_filter_survivors} prefiltered -> "
          f"{g0.funnel.phase4_docs_scored} scored "
          f"(term fraction {g0.funnel.scored_term_fraction:.2f})")

    text = service.exposition()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("emvb_queries_total", "emvb_cache_hits",
                               "emvb_batch_latency_seconds{"))]
    print("   exposition excerpt (full text is service.exposition()):")
    for ln in lines:
        print(f"     {ln}")
    return {"exact": exact, "padded_equals_prefix": padded_ok,
            "stats": s, "spans": names}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
