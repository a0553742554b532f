"""Serving subsystem of the port (counterpart of ``repro/serving``):
caching, micro-batching, online maintenance.

The service loop over a ``repro_torch.core.store.ShardedTimeline`` (or,
once re-epoching opens codebook epochs, an ``EpochedTimeline``) on the
timeline's device: :class:`RetrievalService` (the façade, double-buffered
timeline hot swap), :class:`ResultCache` (per-immutable-generation partial
top-k, LRU under a byte budget), :class:`MicroBatcher` (size/deadline
batching with the engine's term masks), :class:`ServiceMetrics` (hit rate,
warm/cold split, p50/p99 latency, maintenance counters, byte accounting)
and the maintenance loop (:class:`MaintenancePolicy` deciding generation
compaction vs drift-triggered re-epoching, :class:`MaintenanceRunner`
applying it off the serving path). See docs/SERVING.md and
docs/MAINTENANCE.md.
"""
from .batcher import MicroBatcher, Ticket, pad_query  # noqa: F401
from .cache import ResultCache, config_fingerprint, query_fingerprint  # noqa: F401
from .maintenance import (MaintenanceAction, MaintenancePolicy,  # noqa: F401
                          MaintenanceRunner, reepoch_tail)
from .metrics import LatencyStats, ServiceMetrics  # noqa: F401
from .service import RetrievalService  # noqa: F401
