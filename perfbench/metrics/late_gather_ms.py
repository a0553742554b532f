"""late_gather_ms: the mean device ms of the program's span
``engine.late.gather`` (``core/engine.py::_survivor_operands``: the
survivors' codes, residual codes and lengths gathered for the phases 3-4
kernel), between the CUDA events it records on its stream, over the
window's untraced calls."""
from harness.span_readers import stream_ms as read  # noqa: F401
