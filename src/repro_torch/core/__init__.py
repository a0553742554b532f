"""Core retrieval math of the port: index and its build, store (persistence,
growth and timelines), k-means, PQ, the PLAID residual codec, bit vectors,
interaction, top-k and the engine.

Exports the names the reference's ``repro.core`` exports (but ``plaid``,
not ported). The engine's load on first use: it imports the kernels, whose
plain versions import ``core.bitvector``, so loading it here would make
``import repro_torch.kernels.<kernel>`` circular.
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


def __getattr__(name):
    """``engine`` and its exported names, imported on first use."""
    if name in _ENGINE:
        import importlib
        engine = importlib.import_module(".engine", __name__)
        return engine if name == "engine" else getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
