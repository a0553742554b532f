"""postings_per_query: the ``postings`` of the program's span
``engine.candgen.bitmap_wait`` (every probed IVF list entry of a live term
that the candidate bitmap's scatter writes, duplicates across terms
included) over the queries of the window's untraced calls."""
from harness.span_readers import per_query as read  # noqa: F401
