"""bitmap_wait_ms: the mean host ms of the program's span
``engine.candgen.bitmap_wait`` (``core/engine.py::candidate_bitmap``), the
candidate bitmap's boolean-mask scatter, whose nonzero makes the host wait
for the card mid-call, over the window's untraced calls."""
from harness.readers import span_ms as read  # noqa: F401
