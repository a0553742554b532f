"""Online index maintenance: compaction, drift-triggered re-epoching, and
the policy that decides between them (counterpart of
``repro/serving/maintenance.py``).

A long-running service accumulates generations (``new_generation`` per
arrival batch) and drift (``IndexMeta.drift`` grows as appended passages
quantize worse against the frozen codebooks). Left alone, both degrade the
serving path: many small generations mean many per-generation kernel
launches and cache entries per query, and drifted quantization means Eq. 5
scores that no longer rank faithfully. This module closes the loop with
three pieces, mirroring the PLAID SHIRTTT shard-management playbook
(PAPERS.md) on top of the store's temporal sharding:

* :func:`repro_torch.core.store.merge_generations` (re-exported here) — the
  mechanism for **compaction**: generations share frozen codebooks, so a
  contiguous range concatenates into one generation losslessly (same ids,
  same score bits).
* :func:`reepoch_tail` — the mechanism for **re-training**: rebuild the
  drifted suffix of the timeline with ``build_index`` (fresh codebooks =
  a new epoch, ``store.EpochedTimeline``), preserving every surviving
  doc's GLOBAL id so caches and downstream references stay valid.
* :class:`MaintenancePolicy` + :class:`MaintenanceRunner` — the decision
  loop: inspect the timeline's shape and drift telemetry, pick merge vs
  retrain, apply it OFF the serving path, and hand the result to
  ``RetrievalService.update_timeline`` (the double-buffered hot swap).

Merge vs retrain in one line: **merge when the codebooks still fit**
(drift under threshold — compaction is free of quality risk because it is
bit-exact) **and retrain when they don't** (drift over threshold — no
amount of merging fixes quantization error; docs/MAINTENANCE.md has the
full decision table).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Union

import numpy as np

from ..core.index import build_index, pool_documents
from ..core.kmeans import Seed, generator, split
from ..core.store import (EpochedTimeline, ShardedTimeline,
                          merge_generations)
from ..device import resolve_on
from ..obs import trace

Timeline = Union[ShardedTimeline, EpochedTimeline]

# fetch_embeddings(start, stop) -> ((stop-start, cap, d) fp32 zero-padded
# embeddings, (stop-start,) int lengths) for GLOBAL doc ids [start, stop).
# Re-epoching re-quantizes raw embeddings, which the index does not store —
# the corpus owner (whoever called add_passages) must supply them.
EmbeddingFetcher = Callable[[int, int], tuple[np.ndarray, np.ndarray]]


class MaintenanceAction(NamedTuple):
    """One decided maintenance step over the NEWEST epoch's generations.

    ``kind`` is ``"merge"`` (compact generations ``[lo, hi)`` into one,
    bit-exact) or ``"reepoch"`` (rebuild generations ``[lo, hi)`` — always
    a suffix, ``hi == len(epoch)`` — with fresh codebooks). ``reason`` is a
    human-readable sentence for logs/metrics.
    """

    kind: str
    lo: int
    hi: int
    reason: str


@dataclass(frozen=True)
class MaintenancePolicy:
    """When to compact and when to retrain (docs/MAINTENANCE.md).

    merge_factor           : generations per hierarchical merge — frozen
                             generations sit in size tiers
                             (``tier = floor(log_merge_factor(n_docs))``,
                             the LSM/PLAID-SHIRTTT schedule) and
                             ``merge_factor`` adjacent same-tier ones
                             compact into one of the next tier. Total
                             merge work stays O(n log n) docs.
    max_frozen_generations : hard bound on frozen generations regardless
                             of tiers — each frozen generation costs a
                             kernel launch and a cache lookup per query,
                             so the serving path wants few of them. "Age"
                             is measured in generation ARRIVALS (metas
                             carry no wall-clock timestamps; a generation
                             with many newer siblings is old).
    drift_threshold        : ``IndexMeta.drift`` above this marks a
                             generation's quantization stale and triggers
                             re-epoching of the tail from the first such
                             generation (the ~1.5 rule of thumb from
                             ``IndexMeta.drift``).
    """

    merge_factor: int = 4
    max_frozen_generations: int = 8
    drift_threshold: float = 1.5

    def __post_init__(self):
        """Reject thresholds the decision rules cannot work with."""
        if self.merge_factor < 2:
            raise ValueError(
                f"merge_factor={self.merge_factor} < 2: a merge must "
                "combine at least two generations")
        if self.max_frozen_generations < 1:
            raise ValueError(
                f"max_frozen_generations={self.max_frozen_generations} "
                "< 1: the timeline always has at least the open "
                "generation")
        if self.drift_threshold <= 1.0:
            raise ValueError(
                f"drift_threshold={self.drift_threshold} <= 1.0: drift "
                "is a ratio with baseline 1.0 (no drift); a threshold "
                "at or below it would retrain forever")

    def tier(self, n_docs: int) -> int:
        """Size tier of a generation: ``floor(log_merge_factor(n_docs))``."""
        return int(math.floor(
            math.log(max(n_docs, 1)) / math.log(self.merge_factor)))

    def decide(self, timeline: Timeline) -> Optional[MaintenanceAction]:
        """Inspect a timeline and return the next action, or ``None`` when
        it is in shape.

        Checks in priority order over the NEWEST epoch (older epochs are
        already compacted, retrained artifacts):

        1. **drift** — any generation over ``drift_threshold`` means the
           epoch's codebooks no longer fit the data arriving since; the
           tail from the FIRST such generation (including the open one —
           its docs were quantized by the same stale codebooks) is
           re-epoched. Retrain outranks merge: compacting drifted
           generations would only bake the bad quantization into a bigger
           artifact.
        2. **hierarchical merge** — the earliest run of ``merge_factor``
           adjacent same-tier FROZEN generations compacts into one.
        3. **size bound** — more than ``max_frozen_generations`` frozen
           generations (tiers notwithstanding) compacts the oldest
           ``merge_factor`` (at least two).

        One action per call: apply it, then call ``decide`` again — merges
        cascade naturally (a merged generation may complete a run in the
        next tier up).
        """
        tl = EpochedTimeline.of(timeline).epochs[-1]
        n = len(tl)

        for lo, meta in enumerate(tl.metas):
            if meta.drift > self.drift_threshold:
                return MaintenanceAction(
                    "reepoch", lo, n,
                    f"generation {lo} drift {meta.drift:.2f} > "
                    f"{self.drift_threshold:g}: frozen codebooks no "
                    "longer fit, rebuilding tail with fresh ones")

        frozen = tl.metas[:-1]
        tiers = [self.tier(m.n_docs) for m in frozen]
        for i in range(len(frozen) - self.merge_factor + 1):
            run = tiers[i:i + self.merge_factor]
            if all(t == run[0] for t in run):
                return MaintenanceAction(
                    "merge", i, i + self.merge_factor,
                    f"{self.merge_factor} adjacent tier-{run[0]} frozen "
                    f"generations at [{i}, {i + self.merge_factor}): "
                    "hierarchical compaction")

        if len(frozen) > self.max_frozen_generations:
            hi = max(2, min(self.merge_factor, len(frozen)))
            return MaintenanceAction(
                "merge", 0, hi,
                f"{len(frozen)} frozen generations > bound "
                f"{self.max_frozen_generations}: compacting the oldest "
                f"{hi}")

        return None


def reepoch_tail(timeline: Timeline, lo: int, doc_embs: np.ndarray,
                 doc_lens: np.ndarray, *, seed: Seed, device=None,
                 **build_kwargs) -> EpochedTimeline:
    """Rebuild the newest epoch's generations ``[lo:]`` with FRESH codebooks,
    opening a new epoch.

    The drifted tail's raw embeddings (``doc_embs`` (n, cap, d) zero-padded,
    ``doc_lens`` (n,) — the docs of generations ``[lo:]`` in timeline
    order) go through a full :func:`~repro_torch.core.index.build_index`
    on the timeline's device (CUDA unless ``device="cpu"``; a timeline on
    another device raises), its training drawn from ``seed`` (an int or a
    ``torch.Generator``): re-trained centroids and PQ codebooks quantize
    them losslessly-fresh (drift resets to 1.0). Geometry (``n_centroids``/``m``/``nbits``/
    ``plaid_b``) AND the document budget (``doc_budget``) default to the
    old epoch's and are overridable through ``build_kwargs``. A budgeted
    epoch takes RAW embeddings at any cap (the fetcher never sees pooled
    vectors — the index doesn't store raw ones either way): they are
    pooled deterministically, validated against the recorded pooled
    lengths, and re-encoded under the fresh codebooks.

    **Global ids are preserved by construction**: only a SUFFIX is ever
    rebuilt, in corpus order, so doc ``i`` of the old timeline is doc ``i``
    of the new one — which is exactly what keeps result-cache entries
    (storing global ids) and downstream references valid across the swap.
    The truncated old epoch keeps its generations' fingerprints, so their
    cache entries stay warm too.

    -> the new :class:`EpochedTimeline`: old epochs unchanged, newest epoch
    truncated to ``[:lo]`` (dropped entirely when ``lo == 0``), plus a new
    single-generation epoch holding the rebuilt tail. Scores from the new
    epoch are not bit-comparable to the old ones — ``retrieve_timeline``
    merges across epochs by rank (``merge_partial_topk_by_rank``).
    """
    et = EpochedTimeline.of(timeline)
    tl = et.epochs[-1]
    dev = resolve_on(tl.generations[0].device, device)
    if not isinstance(lo, int) or isinstance(lo, bool):
        raise TypeError(f"lo must be an int, got {type(lo).__name__}")
    if not 0 <= lo < len(tl):
        raise ValueError(
            f"lo={lo} out of range for a {len(tl)}-generation epoch: "
            "the rebuilt tail [lo:] must be non-empty")

    tail_docs = sum(m.n_docs for m in tl.metas[lo:])
    embs = np.asarray(doc_embs, dtype=np.float32)
    lens = np.asarray(doc_lens)
    meta0 = tl.metas[0]
    # the document budget is part of the epoch's representation contract
    # and carries into the rebuilt epoch unless explicitly overridden
    kwargs = dict(n_centroids=meta0.n_centroids, m=meta0.m,
                  nbits=meta0.nbits, plaid_b=meta0.plaid_b,
                  doc_budget=meta0.doc_budget)
    kwargs.update(build_kwargs)
    budgeted = meta0.doc_budget is not None or \
        kwargs["doc_budget"] is not None
    if embs.ndim != 3 or embs.shape[2] != meta0.d or \
            (not budgeted and embs.shape[1] != meta0.cap):
        raise ValueError(
            f"doc_embs has shape {embs.shape}: expected "
            f"(n, cap={meta0.cap}, d={meta0.d}) matching the epoch"
            + (" (a budgeted epoch accepts RAW docs at any cap; they are "
               "pooled down)" if budgeted else ""))
    if embs.shape[0] != tail_docs:
        raise ValueError(
            f"doc_embs has {embs.shape[0]} docs but generations "
            f"[{lo}:{len(tl)}) hold {tail_docs}: re-epoching must rebuild "
            "EXACTLY the tail slice (global ids depend on it)")
    want_lens = np.concatenate(
        [g.doc_lens.cpu().numpy() for g in tl.generations[lo:]])
    if meta0.doc_budget is None:
        check_lens = lens
    elif kwargs["doc_budget"] == meta0.doc_budget:
        # recorded lengths are POOLED lengths: pool the supplied raw docs
        # the same deterministic way and compare those
        check_lens = pool_documents(embs, lens, meta0.doc_budget)[1]
    else:
        check_lens = None   # budget override re-pools; lengths can't match
    if check_lens is not None and not np.array_equal(check_lens, want_lens):
        raise ValueError(
            "doc_lens do not match the tail generations' recorded "
            "lengths: the supplied embeddings are not the same docs "
            "(global-id stability would silently break)")
    index, meta = build_index(seed, embs, lens, device=dev, **kwargs)
    fresh = ShardedTimeline((index,), (meta,))

    if lo == 0:
        return et.with_newest_epoch(fresh)
    truncated = ShardedTimeline(tl.generations[:lo], tl.metas[:lo])
    return EpochedTimeline(et.epochs[:-1] + (truncated,)).append_epoch(fresh)


class MaintenanceRunner:
    """Drives the policy against a live :class:`~repro_torch.serving.service
    .RetrievalService` — the glue between deciding and serving.

    ``run_once()`` is cooperative like everything else in the serving loop:
    call it between flushes (e.g. alongside ``poll()``). Each applied
    action builds the new timeline OFF the serving path and installs it via
    ``service.update_timeline`` — the double-buffered swap — so queries
    keep being answered throughout; actions compose on
    ``service.latest_timeline`` (the staged snapshot when one is waiting),
    never on a stale view.
    """

    def __init__(self, service, policy: Optional[MaintenancePolicy] = None,
                 *, fetch_embeddings: Optional[EmbeddingFetcher] = None,
                 build_seed: Optional[Seed] = None,
                 build_kwargs: Optional[dict] = None, max_actions: int = 4):
        """``service``: the RetrievalService to maintain. ``policy``:
        decision thresholds (defaults). ``fetch_embeddings``: raw-embedding
        source for re-epoching, ``(global_start, global_stop) -> (embs,
        lens)`` — required before any reepoch action can apply.
        ``build_seed``: an int or a ``torch.Generator`` (0 by default) from
        which each re-epoch's ``build_index`` draws its own generator. ``build_kwargs``: geometry overrides forwarded to
        :func:`reepoch_tail`. ``max_actions``: cap per ``run_once`` (merges
        cascade; this bounds one call's work)."""
        self.service = service
        self.policy = policy if policy is not None else MaintenancePolicy()
        self.fetch_embeddings = fetch_embeddings
        self._gen = generator(0 if build_seed is None else build_seed)
        self.build_kwargs = dict(build_kwargs) if build_kwargs else {}
        self.max_actions = int(max_actions)

    def run_once(self) -> list[MaintenanceAction]:
        """Decide-and-apply until the policy is satisfied (or
        ``max_actions`` hit); -> the actions applied, oldest first."""
        applied: list[MaintenanceAction] = []
        while len(applied) < self.max_actions:
            et = EpochedTimeline.of(self.service.latest_timeline)
            with trace.span("maintenance.decide") as dsp:
                action = self.policy.decide(et)
                dsp.set(kind=action.kind if action else None)
            if action is None:
                break
            if action.kind == "merge":
                with trace.span("maintenance.merge", lo=action.lo,
                                hi=action.hi):
                    new_tl = merge_generations(et.epochs[-1], action.lo,
                                               action.hi)
                    self.service.update_timeline(
                        et.with_newest_epoch(new_tl))
            else:
                if self.fetch_embeddings is None:
                    raise RuntimeError(
                        f"maintenance wants to re-epoch ({action.reason}) "
                        "but no fetch_embeddings was configured: re-"
                        "training needs the raw embeddings, which the "
                        "index does not store — construct the "
                        "MaintenanceRunner with fetch_embeddings=")
                tl = et.epochs[-1]
                start = et.epoch_offsets[-1] + tl.offsets[action.lo]
                stop = start + sum(m.n_docs for m in tl.metas[action.lo:])
                with trace.span("maintenance.reepoch", lo=action.lo,
                                docs=stop - start):
                    embs, lens = self.fetch_embeddings(start, stop)
                    self.service.update_timeline(
                        reepoch_tail(et, action.lo, embs, lens,
                                     seed=split(self._gen, 1)[0],
                                     device=self.service.device,
                                     **self.build_kwargs))
            self.service.metrics.record_maintenance(action.kind)
            applied.append(action)
        return applied
