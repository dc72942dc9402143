"""Share of the traced calls' wall time in which no operation ran on the
device, in %."""

from perf_bench.trace import idle_share as read  # noqa: F401
