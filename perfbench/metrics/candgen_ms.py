"""candgen_ms: device ms a ``retrieve`` call of candidate generation,
the operations launched inside the CS product, the masked top-nprobe and
the candidate bitmap."""
from harness.readers import range_ms as read  # noqa: F401
