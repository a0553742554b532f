"""Core retrieval math of the port: index, store (persistence, growth and
timelines), k-means assignment, PQ, the PLAID residual codec, bit vectors,
interaction, top-k and the engine."""
