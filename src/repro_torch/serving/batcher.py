"""Size/deadline micro-batching for the retrieval service (counterpart of
``repro/serving/batcher.py``).

Kernel launches amortize across concurrent users: a batch of B queries
costs far less than B single-query calls (the kernels take the whole
batch in one launch). But the engine's shapes are static — every query must
arrive as (n_q, d) — while real queries have heterogeneous term counts.
The batcher bridges the two with the engine's term masks: each submitted
query is zero-padded to the static ``n_q`` with a per-term mask, which the
engine honors bit-exactly (a padded query with its mask retrieves
identically to the unpadded prefix), so heterogeneous queries batch
without changing any result.

Batching policy (cooperative, no background thread — docs/SERVING.md):

* **size** — a batch closes as soon as ``max_batch`` queries are pending
  (the service flushes it immediately);
* **deadline** — otherwise it closes ``max_delay_s`` after its OLDEST
  PENDING query was submitted: ``due()`` turns True and the next
  ``poll()``/``flush()`` drains it. The anchor is per query, not per
  batch: a query left behind when a full ``max_batch`` drains keeps its
  original submit time, so EVERY query — lone, batched, or overflowed —
  waits at most ``max_delay_s`` for company. The clock is injectable for
  deterministic tests.

Predicate filters (docs/FILTERING.md) batch by HOMOGENEITY: the engine's
filter plan is static per launch, so one drained batch must share one
filter. ``drain`` therefore pops the longest FRONT RUN of pending queries
whose filter equals the oldest entry's — FIFO order is preserved (no
reordering, so the per-query deadline promise still holds; a query never
waits behind a younger one), and a filter change simply closes the batch
early. Alternating filters degrade to batch-of-one, which is correct,
just unamortized.

The cache-hit/cache-miss lane split happens per generation downstream
(``RetrievalService._execute``): the batcher's job ends at a dense
:class:`~repro_torch.core.engine.QueryBatch` — (B, n_q, d) queries + (B, n_q)
mask — plus the batch's shared filter and the tickets to fill.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..core.engine import QueryBatch
from ..obs import trace


def pad_query(query: np.ndarray, n_q: int,
              q_mask: Optional[np.ndarray] = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad one (t, d) query to the static (n_q, d) + its (n_q,) mask.

    ``q_mask`` (optional, (t,) bool) masks terms of the UNPADDED query —
    e.g. the mask ``prune_queries`` returned; padding slots are always
    masked False on top of it. A query already at ``n_q`` terms passes
    through unchanged (its mask defaulting to all-True). Rejects t > n_q
    with an actionable error — the engine's bit-vector word is 32 bits
    wide, splitting longer queries is the caller's call, not a silent
    truncation.
    """
    q = np.asarray(query, dtype=np.float32)
    if q.ndim != 2:
        raise ValueError(f"query has shape {q.shape}: expected (terms, d)")
    t = q.shape[0]
    if t > n_q:
        raise ValueError(
            f"query has {t} terms but the service is configured for "
            f"n_q={n_q}; prune it first "
            "(repro_torch.core.engine.prune_queries) "
            "or raise cfg.n_q")
    mask = np.ones(t, dtype=bool) if q_mask is None \
        else np.asarray(q_mask, dtype=bool)
    if mask.shape != (t,):
        raise ValueError(f"q_mask has shape {mask.shape}: expected ({t},) "
                         "— one bool per (unpadded) query term")
    if t == n_q:
        return q, mask
    out = np.zeros((n_q, q.shape[1]), dtype=np.float32)
    out[:t] = q
    full = np.zeros(n_q, dtype=bool)
    full[:t] = mask
    return out, full


class Ticket:
    """A submitted query's handle: filled by the flush that computes it."""

    __slots__ = ("scores", "doc_ids", "_done")

    def __init__(self):
        """A fresh, unfilled ticket."""
        self.scores: Optional[np.ndarray] = None
        self.doc_ids: Optional[np.ndarray] = None
        self._done = False

    @property
    def done(self) -> bool:
        """True once a flush has filled this ticket."""
        return self._done

    def _fill(self, scores: np.ndarray, doc_ids: np.ndarray) -> None:
        self.scores = scores
        self.doc_ids = doc_ids
        self._done = True

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores (k,), global doc ids (k,)); raises if still pending
        (drive the service: ``flush()`` now or ``poll()`` past the
        deadline)."""
        if not self._done:
            raise RuntimeError(
                "ticket is still pending — the batch has not been flushed; "
                "call service.flush() (or poll() once the deadline passes)")
        return self.scores, self.doc_ids


class MicroBatcher:
    """Accumulates padded queries until size or deadline closes the batch.

    The service owns the flush loop; the batcher only answers "is a batch
    due?" and hands over dense arrays. Not thread-safe (docs/SERVING.md).
    """

    def __init__(self, n_q: int, max_batch: int = 16,
                 max_delay_s: float = 0.002,
                 clock: Callable[[], float] = time.monotonic):
        """``n_q``: static term count queries are padded to. ``max_batch``:
        size trigger. ``max_delay_s``: deadline trigger, measured from the
        oldest pending submit. ``clock``: injectable monotonic clock."""
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} < 1")
        self.n_q = n_q
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.clock = clock
        self._queries: list[np.ndarray] = []
        self._masks: list[np.ndarray] = []
        self._tickets: list[Ticket] = []
        self._submits: list[float] = []     # submit time per pending query
        self._filters: list = []            # compiled FilterPlan (or None)
        # cumulative count of queries drained LATER than max_delay_s after
        # their submit — i.e. the cooperative poll loop broke the per-query
        # deadline promise. A size-triggered drain or an exactly-on-time
        # poll never counts (the comparison is strict); a slow poll cadence
        # shows up here before it shows up in p99.
        self.deadline_misses = 0

    def __len__(self) -> int:
        """Number of pending (not yet drained) queries."""
        return len(self._queries)

    def submit(self, query: np.ndarray,
               q_mask: Optional[np.ndarray] = None,
               doc_filter=None) -> Ticket:
        """Enqueue one (t, d) query (padded to n_q) -> its :class:`Ticket`.

        ``doc_filter`` (optional compiled ``bitvector.FilterPlan``) rides
        with the query; ``drain`` groups consecutive same-filter queries
        into one batch."""
        q, m = pad_query(query, self.n_q, q_mask)
        self._queries.append(q)
        self._masks.append(m)
        self._submits.append(self.clock())
        self._filters.append(doc_filter)
        ticket = Ticket()
        self._tickets.append(ticket)
        return ticket

    def due(self) -> bool:
        """True when the pending batch should flush: full, or the OLDEST
        pending query is older than ``max_delay_s``."""
        if not self._queries:
            return False
        if len(self._queries) >= self.max_batch:
            return True
        return self.clock() - self._submits[0] >= self.max_delay_s

    def drain(self) -> Optional[tuple[QueryBatch, list[Ticket], object]]:
        """Pop up to ``max_batch`` pending queries as one dense batch.

        -> (QueryBatch with (B, n_q, d) f32 ``q`` and (B, n_q) bool
        ``q_mask``, the B tickets to fill, the batch's shared
        ``doc_filter``), or ``None`` when nothing is pending. The batch is
        the longest front run sharing the OLDEST entry's filter — filters
        never mix within a batch (the engine's filter plan is static per
        launch) and queries are never reordered (a later same-filter query
        does NOT jump a differing one; the deadline promise is FIFO).
        Queries left behind — by ``max_batch`` or by a filter change —
        stay queued with their ORIGINAL submit times: the deadline is a
        per-query latency promise ("a lone query waits at most
        ``max_delay_s``"), so a query left behind keeps aging —
        re-anchoring its deadline to the drain would let it wait up to
        twice the promise.

        Telemetry per drain: the drained queries' queue wait (oldest
        entry's, the batch's worst case) is recorded as a
        ``batcher.queue_wait`` span on the current tracer, and every
        drained query that waited STRICTLY longer than ``max_delay_s``
        bumps ``deadline_misses``.
        """
        if not self._queries:
            return None
        doc_filter = self._filters[0]
        n = 1
        while (n < min(len(self._queries), self.max_batch)
               and self._filters[n] == doc_filter):
            n += 1
        now = self.clock()
        self.deadline_misses += sum(
            1 for t in self._submits[:n] if now - t > self.max_delay_s)
        trace.record("batcher.queue_wait", now - self._submits[0],
                     batch=n, pending=len(self._queries) - n)
        qb = QueryBatch(np.stack(self._queries[:n]),
                        np.stack(self._masks[:n]))
        tickets = self._tickets[:n]
        del self._queries[:n], self._masks[:n], self._tickets[:n], \
            self._submits[:n], self._filters[:n]
        return qb, tickets, doc_filter
