"""Core retrieval math of the port: index, store (read side), PQ, bit
vectors, interaction, top-k and the engine."""
