"""pqinter_stream_ms: the mean device ms of the program's span
``engine.late.pqinter`` (``core/engine.py::_phase34_batch``: the
``ops.pqinter_batched`` call, its S̄ pass, cut, Eq. 5/6 pass and final
top-k), between the CUDA events it records on its stream, over the
window's untraced calls."""
from harness.span_readers import stream_ms as read  # noqa: F401
