"""late_ms: device ms a ``retrieve`` call of late interaction, the
operations launched inside the LUT, the CS^T transpose and the phases 3-4
kernel's wrapper."""
from harness.readers import range_ms as read  # noqa: F401
