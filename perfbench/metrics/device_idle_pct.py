"""device_idle_pct: the share of the traced window in which no
operation ran on the device, in %."""
from harness.readers import idle_pct as read  # noqa: F401
