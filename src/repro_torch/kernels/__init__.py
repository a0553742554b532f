"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the dispatch wrappers (``ops``). Kernels are built at first use, never at
import time."""
