"""prefilter_roofline: the prefilter's bound (``harness/yardstick.py``,
from the reference's counts) over the device time of the operations
launched inside ``ops.prefilter_batched``, in %."""
from harness.readers import roofline_pct as read  # noqa: F401
