"""The benchmark's planted data, made on the device from the seed.

A frozen copy of the port's planted generator, so that a later change to
the program cannot change what the benchmark serves:

* :func:`make_data` is ``src/repro_torch/data/synthetic.py:122-192``
  (``make_packed_index``) up to, and not including, its ``build_ivf`` call
  and ``PackedIndex``: the benchmark hands these tensors to the program's
  own set-up, which lays out the IVF itself. Same random stream: for one
  seed and one set of widths it makes the same tensors.
* :func:`make_queries` is ``synthetic.py:248-272`` with ``decode_pq``
  (``src/repro_torch/core/pq.py:87-92``) written inline.
* :func:`make_predicate_plane` is new: 32 predicates, each held by a
  seeded share of the docs, one uint32 word per doc.

Imports torch only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

GEN_BLOCK_DOCS = 1 << 20   # docs generated per step (bounds temporaries)
CENTROIDS_PER_TOPIC = 64
CENTROID_SPREAD = 3.0      # two centroids of a topic: cosine about 0.1
PRIMARY_SHARE = 0.75       # tokens drawn from a doc's primary topic
CODEBOOK_SCALE = 0.3       # norm of a decoded PQ residual
QUERY_NOISE = 0.1          # norm of the noise added to a query term
PLANE_BLOCK_DOCS = 1 << 20


class PlantedData(NamedTuple):
    """What the benchmark hands both the program and the reference."""

    centroids: torch.Tensor      # (n_c, d) float32, unit rows
    codes: torch.Tensor          # (n_docs, cap) int32, pad = n_c
    doc_lens: torch.Tensor       # (n_docs,) int32
    res_codes: torch.Tensor      # (n_docs, cap, m) uint8 PQ codes
    pq_codebooks: torch.Tensor   # (m, K, d / m) float32


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


def make_data(seed: int, *, n_docs: int, cap: int, min_len: int, d: int,
              n_centroids: int, m: int, nbits: int,
              device: torch.device) -> PlantedData:
    """The planted corpus in index space: topic-clustered unit centroids,
    docs of uniform length in [min_len, cap] whose tokens draw a centroid
    from a primary (share ``PRIMARY_SHARE``) or a secondary topic, uniform
    uint8 residual codes and normal codebooks."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ksub = 1 << nbits
    per = max(1, min(CENTROIDS_PER_TOPIC, n_centroids))
    n_topics = max(1, n_centroids // per)
    topics = _unit(torch.randn(n_topics, d, generator=g, device=device))
    topic_of = torch.clamp(torch.arange(n_centroids, device=device) // per,
                           max=n_topics - 1)
    centroids = _unit(topics[topic_of] + CENTROID_SPREAD / d ** 0.5
                      * torch.randn(n_centroids, d, generator=g,
                                    device=device))
    codes = torch.empty((n_docs, cap), dtype=torch.int32, device=device)
    doc_lens = torch.randint(min_len, cap + 1, (n_docs,), generator=g,
                             device=device, dtype=torch.int32)
    tok = torch.arange(cap, device=device)
    for s in range(0, n_docs, GEN_BLOCK_DOCS):
        e = min(s + GEN_BLOCK_DOCS, n_docs)
        nb = e - s
        two = torch.randint(0, n_topics, (nb, 2), generator=g, device=device)
        primary = torch.rand((nb, cap), generator=g, device=device) \
            < PRIMARY_SHARE
        topic = torch.where(primary, two[:, :1], two[:, 1:])
        slot = torch.randint(0, per, (nb, cap), generator=g, device=device)
        c = torch.clamp(topic * per + slot, max=n_centroids - 1)
        pad = tok[None, :] >= doc_lens[s:e, None]
        codes[s:e] = torch.where(pad, n_centroids, c).to(torch.int32)
    res_codes = torch.randint(0, ksub, (n_docs, cap, m), generator=g,
                              device=device, dtype=torch.uint8)
    pq_codebooks = CODEBOOK_SCALE / d ** 0.5 * torch.randn(
        m, ksub, d // m, generator=g, device=device)
    return PlantedData(centroids, codes, doc_lens, res_codes, pq_codebooks)


def make_queries(data: PlantedData, seed: int, n_queries: int,
                 n_q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries planted on target docs: each term one of the target's tokens
    rebuilt as ``centroid + decoded residual + noise``, normalized.
    -> (queries (n_queries, n_q, d) float32, gt (n_queries,) int64)."""
    dev = data.codes.device
    n_docs = data.codes.shape[0]
    n_c, d = data.centroids.shape
    m = data.pq_codebooks.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    gt = torch.randint(0, n_docs, (n_queries,), generator=g, device=dev)
    u = torch.rand((n_queries, n_q), generator=g, device=dev)
    lens = data.doc_lens[gt, None]
    take = torch.clamp((u * lens).long(), min=0)
    take = torch.minimum(take, (lens - 1).clamp(min=0).long())
    c = torch.clamp(data.codes[gt[:, None], take].long(), max=n_c - 1)
    res = data.res_codes[gt[:, None], take].reshape(-1, m).long()
    sub = torch.arange(m, device=dev)
    decoded = data.pq_codebooks[sub[None, :], res].reshape(n_queries, n_q, d)
    vec = data.centroids[c] + decoded
    vec = vec + QUERY_NOISE / d ** 0.5 * torch.randn(
        n_queries, n_q, d, generator=g, device=dev)
    return _unit(vec), gt


def make_predicate_plane(seed: int, n_docs: int, n_predicates: int,
                         pass_share: float,
                         device: torch.device) -> torch.Tensor:
    """(n_docs,) uint32 words: bit i set, independently for each doc and
    predicate, with probability ``pass_share``."""
    if not 1 <= n_predicates <= 32:
        raise ValueError(f"n_predicates={n_predicates}: a word holds 1-32")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shifts = torch.arange(n_predicates, device=device, dtype=torch.int64)
    words = torch.empty(n_docs, dtype=torch.int32, device=device)
    for s in range(0, n_docs, PLANE_BLOCK_DOCS):
        e = min(s + PLANE_BLOCK_DOCS, n_docs)
        hold = torch.rand((e - s, n_predicates), generator=g,
                          device=device) < pass_share
        w = (hold.to(torch.int64) << shifts).sum(1)
        words[s:e] = torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32)
    return words.view(torch.uint32)
