"""PyTorch/CUDA port of the EMVB retrieval system (the JAX package ``repro``
is the reference).

The port keeps the reference's module names (``core/index.py``,
``core/engine.py``, ``kernels/prefilter.py``, ...) so each function's
counterpart is easy to find. It imports ``torch`` and numpy only: nothing of
``jax`` and nothing of ``repro``.

Entry points (``load_index``, ``load_timeline``, ``index_from_arrays``, the
synthetic index generator, ``retrieve``, ``retrieve_timeline``,
``new_generation``, ``add_passages``, ``build_index`` and the training it
runs, ``serving.RetrievalService``, ``serving.reepoch_tail``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU present and
none declined they raise instead of running on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
