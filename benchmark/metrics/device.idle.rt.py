"""Share of the traced slice of the window in which no kernel, copy or set
ran on the device (the union of the profiler's device intervals)."""

from benchmark.metrics._common import idle_percent as read  # noqa: F401
