"""pqinter_roofline: the phases 3-4 kernel's bound (``harness/yardstick.py``,
from the reference's counts, Eq. 6 counted as the inputs need it) over the
device time of the operations launched inside ``ops.pqinter_batched``,
in %."""
from harness.readers import roofline_pct as read  # noqa: F401
