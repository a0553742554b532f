"""late_stream_ms: the mean device ms of the program's span ``engine.late``
(``core/engine.py::_phase34_batch``: the LUT, CS^T, the survivor gathers,
the phases 3-4 kernel and the final id gather), between the CUDA events it
records on its stream, over the window's untraced calls."""
from harness.span_readers import stream_ms as read  # noqa: F401
