"""Recommender models (counterpart of ``repro/models/recsys``): MIND, DLRM,
DCN-v2 and DIEN over the shared EmbeddingBag and MLP."""
