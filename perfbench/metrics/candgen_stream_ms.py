"""candgen_stream_ms: the mean device ms of the program's span
``engine.candgen`` (``core/engine.py::_phase12_batch``: the CS product, the
masked top-nprobe, the candidate bitmap), between the CUDA events it
records on its stream, over the window's untraced calls. It counts the
device's idle time at the bitmap's host wait too."""
from harness.span_readers import stream_ms as read  # noqa: F401
