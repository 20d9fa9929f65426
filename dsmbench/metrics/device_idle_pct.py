"""The share of the traced window in which nothing ran on the card:
100 x (1 - the union of the device's activity intervals / the window),
from the profiler's trace."""

KIND = "per_layer"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device, H100"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
