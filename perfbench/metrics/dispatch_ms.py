"""dispatch_ms: the mean host ms of the program's own span
``engine.retrieve.dispatch`` (``core/engine.py::retrieve``) over the
window's calls that the profiler did not record. It times the launches and
the host work of a call, not the device's."""
from harness.readers import span_ms as read  # noqa: F401
