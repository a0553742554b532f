"""gather_bytes_per_query: the ``bytes`` of the program's span
``engine.late.gather`` (what the survivor gathers write: codes, residual
codes and lengths, n_filter x (cap x (4 + m) + 4) a query) over the
queries of the window's untraced calls."""
from harness.span_readers import per_query as read  # noqa: F401
