"""prefilter_stream_ms: the mean device ms of the program's span
``engine.prefilter`` (``core/engine.py::_phase12_batch``: the prefilter
kernel and its id gather), between the CUDA events it records on its
stream, over the window's untraced calls."""
from harness.span_readers import stream_ms as read  # noqa: F401
