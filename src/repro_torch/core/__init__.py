"""Core retrieval math of the port: index and its build, store (persistence,
growth and timelines), k-means, PQ, the PLAID residual codec, bit vectors,
interaction, top-k and the engine.

Exports the names the reference's ``repro.core`` exports. The engine and
the PLAID baseline (``plaid``, ``PlaidConfig``) load on first use: they
import the kernels, whose plain versions import ``core.bitvector``, so
loading them here would make ``import repro_torch.kernels.<kernel>``
circular.
"""
from . import (bitvector, index, interaction, kmeans, pq,  # noqa: F401
               residual, store)
from .index import (IndexMeta, PackedIndex, build_index,  # noqa: F401
                    bytes_per_embedding, pool_documents)
from .store import (EpochedTimeline, ShardedTimeline, add_passages,  # noqa: F401
                    generation_footprint, index_fingerprint, load_index,
                    load_timeline, merge_generations, new_generation,
                    save_index, save_timeline, timeline_footprint)

_ENGINE = ("engine", "EngineConfig", "QueryBatch", "RetrievalResult",
           "prune_queries", "retrieve", "retrieve_timeline")
_PLAID = ("plaid", "PlaidConfig")


def __getattr__(name):
    """``engine``, ``plaid`` and their exported names, imported on first
    use."""
    for mod, names in (("engine", _ENGINE), ("plaid", _PLAID)):
        if name in names:
            import importlib
            m = importlib.import_module("." + mod, __name__)
            return m if name == mod else getattr(m, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
