"""The 95th percentile of a job's wall time in the untraced window, by
the host's clock around each `mine_torch` call, which ends synchronised
with the card."""

import statistics

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "front door, mining.engine.mine_torch"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.prefix2.asc"]


def read(run):
    walls = [j.wall_s for j in run.jobs]
    if len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=20)[18]
