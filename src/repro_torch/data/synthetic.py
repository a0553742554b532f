"""Synthetic data with planted relevance.

Two parts:

* A numpy copy of the reference corpus generator and metrics
  (``repro/data/synthetic.py``): :func:`make_corpus`,
  :func:`make_ood_corpus`, :func:`mrr_at_k`, :func:`success_at_k`. The
  tests build the reference's index from it.
* :func:`make_packed_index` / :func:`make_queries`: a seeded, planted index
  built directly in index space on the device, at any width. This is the
  data of ``chip_smoke.py``, not a user feature: a real MS MARCO index
  cannot be downloaded here, and building one takes k-means over about 700M
  token vectors. Its shapes and dtypes are a real index's; its contents are
  random but structured so that retrieval has a right answer.
* :func:`make_raw_docs` / :func:`make_raw_queries`: new passages for such an
  index as raw token embeddings (what ``store.new_generation`` and
  ``store.add_passages`` encode), and queries planted on them.
* :func:`with_plaid_residuals`: the PLAID baseline's b-bit residuals for
  such an index, encoded on its device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..core.index import IndexMeta, PackedIndex, build_ivf
from ..core.pq import PQCodebooks, decode_pq
from ..core.residual import encode_residual, train_residual_codec


class Corpus(NamedTuple):
    """Padded token embeddings, lengths, queries and planted targets."""

    doc_embs: np.ndarray   # (n_docs, cap, d) fp32, zero-padded, L2-normed rows
    doc_lens: np.ndarray   # (n_docs,) int32
    queries: np.ndarray    # (n_queries, n_q, d) fp32, L2-normed
    gt_doc: np.ndarray     # (n_queries,) int32 planted ground-truth doc


def make_corpus(seed: int, *, n_docs: int = 2000, cap: int = 48,
                min_len: int = 16, d: int = 128, n_topics: int = 64,
                n_queries: int = 64, n_q: int = 32,
                token_noise: float = 0.35, query_noise: float = 0.12,
                topic_shift: float = 0.0) -> Corpus:
    """Topic-clustered token embeddings; each query perturbs n_q tokens of a
    planted target doc. The same numbers as the reference for a seed."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(n_topics, d)).astype(np.float32)
    if topic_shift:
        topics += topic_shift * rng.normal(size=(1, d)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=-1, keepdims=True)

    doc_lens = rng.integers(min_len, cap + 1, size=n_docs).astype(np.int32)
    doc_topic = rng.integers(0, n_topics, size=n_docs)
    noise = rng.normal(size=(n_docs, cap, d)).astype(np.float32) * token_noise
    doc_embs = topics[doc_topic][:, None, :] + noise
    doc_embs /= np.maximum(
        np.linalg.norm(doc_embs, axis=-1, keepdims=True), 1e-12)
    pad_mask = np.arange(cap)[None, :] >= doc_lens[:, None]
    doc_embs[pad_mask] = 0.0

    gt = rng.integers(0, n_docs, size=n_queries).astype(np.int32)
    queries = np.empty((n_queries, n_q, d), np.float32)
    for qi, docid in enumerate(gt):
        take = rng.integers(0, doc_lens[docid], size=n_q)
        qtok = doc_embs[docid, take] + \
            rng.normal(size=(n_q, d)).astype(np.float32) * query_noise
        queries[qi] = qtok / np.maximum(
            np.linalg.norm(qtok, axis=-1, keepdims=True), 1e-12)
    return Corpus(doc_embs, doc_lens, queries, gt)


def make_ood_corpus(seed: int, **kw) -> Corpus:
    """LoTTE-like (ref ``synthetic.py:59``): distribution-shifted topics,
    longer documents: :func:`make_corpus` with ``cap`` 96, ``min_len`` 48
    and ``topic_shift`` 0.8 unless given."""
    kw.setdefault("cap", 96)
    kw.setdefault("min_len", 48)
    kw.setdefault("topic_shift", 0.8)
    return make_corpus(seed, **kw)


def mrr_at_k(ranked_ids: np.ndarray, gt: np.ndarray, k: int = 10) -> float:
    """ranked_ids (B, >=k) -> mean reciprocal rank@k of the planted doc."""
    rr = 0.0
    for ids, g in zip(ranked_ids[:, :k], gt):
        hits = np.nonzero(ids == g)[0]
        if hits.size:
            rr += 1.0 / (hits[0] + 1)
    return rr / len(gt)


def recall_at_k(ranked_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Fraction of queries whose planted doc is in the top k."""
    return float(np.mean([g in ids[:k] for ids, g in zip(ranked_ids, gt)]))


def success_at_k(ranked_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Success@k: with one planted doc per query, Recall@k."""
    return recall_at_k(ranked_ids, gt, k)


# --- the planted index, built in index space on the device --------------------

GEN_BLOCK_DOCS = 1 << 20   # docs generated per step (bounds temporaries)
CENTROIDS_PER_TOPIC = 64
CENTROID_SPREAD = 3.0      # two centroids of a topic: cosine about 0.1
PRIMARY_SHARE = 0.75       # tokens drawn from a doc's primary topic
CODEBOOK_SCALE = 0.3       # norm of a decoded PQ residual
QUERY_NOISE = 0.1          # norm of the noise added to a query term
TOKEN_NOISE = 0.3          # norm of the noise on a raw token embedding


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


def make_packed_index(seed: int, *, n_docs: int, cap: int, min_len: int,
                      d: int, n_centroids: int, m: int, nbits: int,
                      list_cap, device=None
                      ) -> tuple[PackedIndex, IndexMeta]:
    """A seeded planted index at the given widths, on ``device`` — the data
    ``chip_smoke.py`` serves, not a user feature (see the module docstring).

    * Centroids: unit vectors in topics of ``CENTROIDS_PER_TOPIC``, each
      ``normalize(topic + CENTROID_SPREAD * g / sqrt(d))``: two centroids of
      a topic have cosine about 0.1, so a query term is close (above th) to
      little beyond its own centroid.
    * Documents: lengths uniform in [min_len, cap]; each doc has a primary
      and a secondary topic, and each token draws a centroid uniformly from
      the primary topic (share ``PRIMARY_SHARE``) or the secondary.
    * PQ: uniform uint8 residual codes and normal codebooks whose decoded
      residual has norm about ``CODEBOOK_SCALE``; identity OPQ rotation;
      zero predicate plane;
      PLAID fields are placeholders of the smallest shapes.
    * IVF: :func:`build_ivf` over the codes, truncated at ``list_cap``.
    * ``meta.train_quant_mse``: a planted token is its centroid plus its
      decoded residual, so the drift baseline is the mean squared norm of
      the real tokens' decoded residuals (:func:`_planted_quant_mse`).
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ksub = 1 << nbits
    per = max(1, min(CENTROIDS_PER_TOPIC, n_centroids))
    n_topics = max(1, n_centroids // per)
    topics = _unit(torch.randn(n_topics, d, generator=g, device=dev))
    topic_of = torch.clamp(torch.arange(n_centroids, device=dev) // per,
                           max=n_topics - 1)
    centroids = _unit(topics[topic_of] + CENTROID_SPREAD / d ** 0.5
                      * torch.randn(n_centroids, d, generator=g, device=dev))

    codes = torch.empty((n_docs, cap), dtype=torch.int32, device=dev)
    doc_lens = torch.randint(min_len, cap + 1, (n_docs,), generator=g,
                             device=dev, dtype=torch.int32)
    tok = torch.arange(cap, device=dev)
    for s in range(0, n_docs, GEN_BLOCK_DOCS):
        e = min(s + GEN_BLOCK_DOCS, n_docs)
        nb = e - s
        two = torch.randint(0, n_topics, (nb, 2), generator=g, device=dev)
        primary = torch.rand((nb, cap), generator=g, device=dev) \
            < PRIMARY_SHARE
        topic = torch.where(primary, two[:, :1], two[:, 1:])
        slot = torch.randint(0, per, (nb, cap), generator=g, device=dev)
        c = torch.clamp(topic * per + slot, max=n_centroids - 1)
        pad = tok[None, :] >= doc_lens[s:e, None]
        codes[s:e] = torch.where(pad, n_centroids, c).to(torch.int32)
    res_codes = torch.randint(0, ksub, (n_docs, cap, m), generator=g,
                              device=dev, dtype=torch.uint8)
    pq_codebooks = CODEBOOK_SCALE / d ** 0.5 * torch.randn(
        m, ksub, d // m, generator=g, device=dev)
    ivf, ivf_lens, list_cap, n_dropped = build_ivf(
        codes, n_centroids, list_cap, origin="make_packed_index")
    index = PackedIndex(
        centroids=centroids, codes=codes, doc_lens=doc_lens,
        res_codes=res_codes, pq_codebooks=pq_codebooks, ivf=ivf,
        ivf_lens=ivf_lens,
        plaid_res=torch.zeros((1, 1, 1), dtype=torch.uint8, device=dev),
        plaid_cutoffs=torch.zeros(3, device=dev),
        plaid_weights=torch.zeros(4, device=dev),
        opq_rotation=torch.eye(d, device=dev),
        pred_words=torch.zeros(n_docs, dtype=torch.uint32, device=dev))
    meta = IndexMeta(n_docs=n_docs, n_centroids=n_centroids, d=d, cap=cap,
                     m=m, nbits=nbits, plaid_b=2, list_cap=list_cap,
                     n_dropped=n_dropped,
                     train_quant_mse=_planted_quant_mse(index),
                     n_raw_tokens=int(doc_lens.sum()))
    return index, meta


PLAID_SAMPLE_TOKENS = 1 << 16   # real tokens the PLAID codec is trained on
PLAID_BLOCK_DOCS = 1 << 14      # docs encoded per step (bounds temporaries)


def with_plaid_residuals(index: PackedIndex, meta: IndexMeta, b: int = 2
                         ) -> tuple[PackedIndex, IndexMeta]:
    """The planted index with PLAID's b-bit residual codes (ColBERTv2's
    codec, ``core/residual.py``) in place of its placeholders, made on its
    device from what the seed made: a planted token is its centroid plus
    the decoded PQ residual (:func:`make_queries` rebuilds query terms so),
    and that residual is what PLAID stores. The codec's 2^b quantile
    buckets (all dimensions pooled) are trained on the decoded residuals of
    the first ``PLAID_SAMPLE_TOKENS`` real tokens, then every token slot,
    padding too as in ``build_index``, is encoded to ``d * b / 8`` bytes —
    22.6 GB at the emvb-msmarco widths (b = 2, d = 128, 8,841,823 x 80
    slots). -> (index, meta with ``plaid_b=b``)."""
    cb = PQCodebooks(index.pq_codebooks)
    n_docs, cap = index.codes.shape
    d = index.centroids.shape[1]
    real = (torch.arange(cap, device=index.codes.device)[None, :]
            < index.doc_lens[:, None])
    docs = 2 * -(-PLAID_SAMPLE_TOKENS // cap)   # enough real tokens
    sample = index.res_codes[:docs][real[:docs]][:PLAID_SAMPLE_TOKENS]
    codec = train_residual_codec(decode_pq(sample, cb), b)
    plaid_res = torch.empty((n_docs, cap, d * b // 8), dtype=torch.uint8,
                            device=index.codes.device)
    for s in range(0, n_docs, PLAID_BLOCK_DOCS):
        block = index.res_codes[s:s + PLAID_BLOCK_DOCS]
        res = decode_pq(block.reshape(-1, block.shape[-1]), cb)
        plaid_res[s:s + PLAID_BLOCK_DOCS] = encode_residual(
            res, codec).reshape(block.shape[0], cap, -1)
    index = index._replace(plaid_res=plaid_res, plaid_cutoffs=codec.cutoffs,
                           plaid_weights=codec.bucket_weights)
    return index, dataclasses.replace(meta, plaid_b=b)


def _planted_quant_mse(index: PackedIndex) -> float:
    """Mean over the real tokens of ``|decode_pq(residual code)|^2`` — the
    squared distance of a planted token to its centroid — summed in
    float64 a block of docs at a time."""
    sq = (index.pq_codebooks ** 2).sum(-1)                    # (m, K)
    sub = torch.arange(sq.shape[0], device=sq.device)
    cap = index.codes.shape[1]
    tok = torch.arange(cap, device=sq.device)
    total = torch.zeros((), dtype=torch.float64, device=sq.device)
    step = max(1, GEN_BLOCK_DOCS // 8)
    for s in range(0, index.codes.shape[0], step):
        per_token = sq[sub, index.res_codes[s:s + step].long()].sum(-1)
        valid = tok[None, :] < index.doc_lens[s:s + step, None]
        total += per_token[valid].double().sum()
    return float(total) / max(int(index.doc_lens.sum()), 1)


def make_queries(index: PackedIndex, seed: int, n_queries: int,
                 n_q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries planted on target docs: each term is one of the target's
    tokens rebuilt as ``centroid + decode_pq(residual code) + noise``,
    normalized. -> (queries (n_queries, n_q, d) float32, gt (n_queries,)
    int64 target doc ids), on the index's device."""
    dev = index.codes.device
    n_docs = index.codes.shape[0]
    d = index.centroids.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    gt = torch.randint(0, n_docs, (n_queries,), generator=g, device=dev)
    u = torch.rand((n_queries, n_q), generator=g, device=dev)
    take = torch.clamp((u * index.doc_lens[gt, None]).long(), min=0)
    take = torch.minimum(take, (index.doc_lens[gt, None] - 1).clamp(min=0)
                         .long())
    c = index.codes[gt[:, None], take].long()
    c = torch.clamp(c, max=index.centroids.shape[0] - 1)
    res = index.res_codes[gt[:, None], take]                 # (Q, n_q, m)
    vec = index.centroids[c] + decode_pq(
        res.reshape(-1, res.shape[-1]),
        PQCodebooks(index.pq_codebooks)).reshape(n_queries, n_q, d)
    vec = vec + QUERY_NOISE / d ** 0.5 * torch.randn(n_queries, n_q, d,
                                               generator=g, device=dev)
    return _unit(vec), gt


def make_raw_docs(index: PackedIndex, seed: int, n_docs: int, min_len: int,
                  token_noise: float = TOKEN_NOISE
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """New passages for a planted index as raw token embeddings, on its
    device: topics and centroids drawn as :func:`make_packed_index` draws
    them, each token ``normalize(centroid + noise)`` with noise of norm
    about ``token_noise``, lengths uniform in [min_len, cap], zero-padded.
    A larger ``token_noise`` than the default moves the passages away from
    the index's centroids, which the grown generation's drift reads.
    -> (doc_embs (n_docs, cap, d) float32, doc_lens (n_docs,) int32)."""
    dev = index.codes.device
    n_c, d = index.centroids.shape
    cap = index.codes.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    per = max(1, min(CENTROIDS_PER_TOPIC, n_c))
    n_topics = max(1, n_c // per)
    doc_lens = torch.randint(min_len, cap + 1, (n_docs,), generator=g,
                             device=dev, dtype=torch.int32)
    two = torch.randint(0, n_topics, (n_docs, 2), generator=g, device=dev)
    primary = torch.rand((n_docs, cap), generator=g, device=dev) \
        < PRIMARY_SHARE
    topic = torch.where(primary, two[:, :1], two[:, 1:])
    slot = torch.randint(0, per, (n_docs, cap), generator=g, device=dev)
    c = torch.clamp(topic * per + slot, max=n_c - 1)
    embs = _unit(index.centroids[c] + token_noise / d ** 0.5 * torch.randn(
        n_docs, cap, d, generator=g, device=dev))
    pad = torch.arange(cap, device=dev)[None, :] >= doc_lens[:, None]
    return embs.masked_fill(pad[..., None], 0.0), doc_lens


def make_raw_queries(doc_embs: torch.Tensor, doc_lens: torch.Tensor,
                     seed: int, n_queries: int, n_q: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries planted on raw passages: each term is one of the target's
    token embeddings plus noise of norm about ``QUERY_NOISE``, normalized.
    -> (queries (n_queries, n_q, d) float32, gt (n_queries,) int64 target
    positions among the passages), on their device."""
    dev = doc_embs.device
    n_docs, _, d = doc_embs.shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    gt = torch.randint(0, n_docs, (n_queries,), generator=g, device=dev)
    u = torch.rand((n_queries, n_q), generator=g, device=dev)
    take = (u * doc_lens[gt, None]).long()
    vec = doc_embs[gt[:, None], take] + QUERY_NOISE / d ** 0.5 * torch.randn(
        n_queries, n_q, d, generator=g, device=dev)
    return _unit(vec), gt


# ---------------------------------------------------------------------------
# Token pairs for the encoder (ref ``examples/train_colbert.py:29``)
# ---------------------------------------------------------------------------

def _check_topics(n_topics: int, words_per_topic: int, vocab: int) -> None:
    if n_topics * words_per_topic > vocab:
        raise ValueError(f"{n_topics} topics x {words_per_topic} words "
                         f"exceed the vocabulary of {vocab}")


def _corrupt(rng: np.random.Generator, tokens: np.ndarray, vocab: int,
             rate: float) -> np.ndarray:
    """``tokens`` with each one replaced by a uniform id at ``rate``."""
    hit = rng.random(tokens.shape) < rate
    return np.where(hit, rng.integers(0, vocab, tokens.shape), tokens)


def token_pairs(seed: int, *, n_topics: int, words_per_topic: int,
                vocab: int, batch: int, q_len: int, d_len: int,
                corrupt: float = 0.15):
    """The example's paired (query, positive passage) batches -> ``make(step)``
    -> ``{"q_tokens", "q_valid", "d_tokens", "d_valid"}``, CPU tensors
    (int64 ids, bool validity, every token valid). A passage draws its
    ``d_len`` tokens from its topic's ``words_per_topic``-word slice of the
    vocabulary; its query is the first ``q_len`` of them with each replaced
    by a uniform id at ``corrupt``. A batch is a function of (seed, step)
    alone, so a resumed trainer sees the batches a continuous one does.
    ``n_topics=32, words_per_topic=24, vocab=1000, batch=16, q_len=12,
    d_len=24`` is ``examples/train_colbert.py``'s generator (its numbers
    come from numpy, not jax.random)."""
    _check_topics(n_topics, words_per_topic, vocab)

    def make(step: int) -> dict:
        rng = np.random.default_rng([seed, step])
        topic = rng.integers(0, n_topics, (batch, 1))
        d = topic * words_per_topic + rng.integers(0, words_per_topic,
                                                   (batch, d_len))
        q = _corrupt(rng, d, vocab, corrupt)[:, :q_len]
        return {"q_tokens": torch.from_numpy(q),
                "q_valid": torch.ones((batch, q_len), dtype=torch.bool),
                "d_tokens": torch.from_numpy(d),
                "d_valid": torch.ones((batch, d_len), dtype=torch.bool)}
    return make


def token_corpus(seed: int, *, n_docs: int, n_topics: int,
                 words_per_topic: int, vocab: int, cap: int, min_len: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Passages of the :func:`token_pairs` kind with lengths uniform in
    [min_len, cap] -> (tokens (n_docs, cap) int64, 0 past each length;
    lens (n_docs,) int32)."""
    _check_topics(n_topics, words_per_topic, vocab)
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, n_topics, (n_docs, 1))
    tokens = topic * words_per_topic + rng.integers(0, words_per_topic,
                                                    (n_docs, cap))
    lens = rng.integers(min_len, cap + 1, n_docs).astype(np.int32)
    tokens[np.arange(cap)[None, :] >= lens[:, None]] = 0
    return tokens, lens


def token_queries(seed: int, tokens: np.ndarray, lens: np.ndarray, *,
                  n_queries: int, q_len: int, vocab: int,
                  corrupt: float = 0.15) -> tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Queries planted on passages of :func:`token_corpus`: the first
    ``q_len`` tokens of a uniformly drawn passage (with replacement), each
    replaced by a uniform id at ``corrupt`` -> (q_tokens (n, q_len) int64,
    q_valid (n, q_len) bool: the passage's tokens, gt (n,) int64)."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, tokens.shape[0], n_queries)
    q = _corrupt(rng, tokens[gt][:, :q_len], vocab, corrupt)
    valid = np.arange(q_len)[None, :] < lens[gt][:, None]
    return np.where(valid, q, 0), valid, gt
