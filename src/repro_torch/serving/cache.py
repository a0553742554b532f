"""Per-generation result cache — the serving layer's memory (counterpart of
``repro/serving/cache.py``; its keys are the reference's strings byte for
byte).

EMVB's candidate-generation phases dominate latency (PLAID, Santhanam et
al., 2022), and on a ``ShardedTimeline`` every generation except the newest
is immutable — so a generation's partial top-k for a given query is a pure
function of three fingerprints and can be cached forever:

    key = (query_fingerprint, generation_fingerprint, config_fingerprint)

* ``query_fingerprint`` hashes the quantized query bytes (the f32 array the
  engine actually consumes) AND the per-term ``q_mask`` — a padded query
  and its unpadded prefix hash differently even though they retrieve
  identically (the padded == prefix contract); collapsing them would be a
  second equivalence the cache does not need to assume.
* the generation fingerprint is
  ``repro_torch.core.store.index_fingerprint`` — content-addressed,
  persisted in the store manifest, bumped by ANY mutation
  (``add_passages`` on the open generation changes ``codes`` and with it
  the fingerprint), so stale entries are unreachable by construction
  rather than by eviction discipline.
* ``config_fingerprint`` hashes every ``EngineConfig`` field: the same
  query over the same generation under a different ``k``/``th``/kernel
  choice is a different result.

Entries are the per-query, per-generation partial ``(scores (k,), global
doc ids (k,))`` pairs that
:func:`repro_torch.core.engine.merge_partial_topk` merges — stored as
numpy on the host, so a hit costs no device work and a warm merge is
bit-identical to a cold one. Eviction is LRU under a
byte budget (``max_bytes``); hit/miss/eviction counters feed
``repro_torch.serving.metrics``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..core.engine import EngineConfig

CacheKey = tuple[str, str, str]


def query_fingerprint(query: np.ndarray,
                      q_mask: Optional[np.ndarray] = None) -> str:
    """Fingerprint one query: sha1 over the quantized query bytes + mask.

    ``query`` is the (n_q, d) f32 array the engine consumes (already
    padded/quantized by the batcher); ``q_mask`` is the (n_q,) bool term
    mask, ``None`` meaning all-True (the two hash identically, since they
    retrieve identically bit for bit). Shape and dtype are hashed
    too, so a (16, d) prefix and its (32, d) zero-padded form stay distinct
    keys (they run different batch shapes even though scores agree).
    """
    q = np.ascontiguousarray(np.asarray(query, dtype=np.float32))
    m = (np.ones(q.shape[0], dtype=bool) if q_mask is None
         else np.ascontiguousarray(np.asarray(q_mask, dtype=bool)))
    h = hashlib.sha1()
    h.update(repr(q.shape).encode())
    h.update(q.tobytes())
    h.update(m.tobytes())
    return h.hexdigest()


def config_fingerprint(cfg: EngineConfig, doc_budget=None) -> str:
    """Fingerprint an ``EngineConfig``: sha1 over every field, sorted —
    the reference's string for the same config.

    Python's ``hash()`` is salted per process, so the dataclass hash cannot
    key anything that outlives a process; the field dump can. Every field
    participates — kernel dispatch flags included, since the bit-exactness
    contract is per config, not just per budget. The reference's config
    has one field the port's lacks, ``kernel_interpret`` (Pallas interpret
    mode, whose job the tensors' device does here): it joins the dump at
    the reference's default, ``True``, in its sorted place, so both
    packages key a config alike.

    ``doc_budget`` folds the served timeline's document budget (or a tuple
    of per-epoch budgets) into the key: a pooled and an unpooled index over
    the same corpus can coincidentally share a generation fingerprint when
    every doc fits the budget, so the representation regime must be keyed
    explicitly — pooled and unpooled partials never collide. ``None`` (the
    per-token layout) leaves the fingerprint as it is without a budget.
    """
    fields = sorted({**dataclasses.asdict(cfg),
                     "kernel_interpret": True}.items())
    if doc_budget is not None:
        fields.append(("doc_budget", doc_budget))
    return hashlib.sha1(repr(fields).encode()).hexdigest()


@dataclasses.dataclass
class _Entry:
    """One cached partial: scores + GLOBAL doc ids for a single query over
    a single immutable generation."""

    scores: np.ndarray    # (k,) — dtype as the engine produced it
    doc_ids: np.ndarray   # (k,) int32, global id space
    nbytes: int


class ResultCache:
    """LRU result cache under a byte budget.

    Maps :data:`CacheKey` -> per-query partial top-k. ``get`` refreshes
    recency; ``put`` evicts least-recently-used entries until the budget
    holds (an entry larger than the whole budget is simply not cached).
    Counters (``hits``/``misses``/``evictions``/``bytes``) are cumulative;
    ``repro_torch.serving.metrics`` snapshots them. Not thread-safe — the
    service loop is cooperative single-thread (docs/SERVING.md).
    """

    def __init__(self, max_bytes: int = 64 << 20):
        """``max_bytes``: LRU byte budget over entry payloads (default
        64 MiB — at k=10 a partial is ~80 payload bytes, so the default
        holds hundreds of thousands of (query, generation) partials)."""
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[CacheKey, _Entry] = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        """Number of cached (query, generation, config) partials."""
        return len(self._entries)

    def get(self, key: CacheKey
            ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """-> (scores, doc_ids) and refresh recency, or None on miss."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e.scores, e.doc_ids

    def put(self, key: CacheKey, scores: np.ndarray,
            doc_ids: np.ndarray) -> None:
        """Insert one partial (copied to owned host arrays); LRU-evict to
        budget.

        The copy is load-bearing, not defensive: callers pass row VIEWS
        into a whole batch's device-result buffer, and caching the view
        would pin the full (B, k) buffer alive while accounting only the
        row — the byte budget would hold on paper while resident memory
        exceeded it by up to the batch size.
        """
        scores = np.array(scores, copy=True)
        doc_ids = np.array(doc_ids, copy=True)
        nbytes = scores.nbytes + doc_ids.nbytes
        if nbytes > self.max_bytes:
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        self._entries[key] = _Entry(scores, doc_ids, nbytes)
        self.bytes += nbytes
        while self.bytes > self.max_bytes:
            _, evicted = self._entries.popitem(last=False)
            self.bytes -= evicted.nbytes
            self.evictions += 1

    def clear(self) -> None:
        """Drop every entry (counters keep their cumulative totals)."""
        self._entries.clear()
        self.bytes = 0

    def stats(self) -> dict:
        """Cumulative counters + current occupancy, one flat dict."""
        lookups = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "lookups": lookups,
            "evictions": self.evictions,
            "hit_rate": self.hits / lookups if lookups else 0.0,
        }
