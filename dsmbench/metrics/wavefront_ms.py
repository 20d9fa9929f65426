"""A job's seconds in the host tail's wavefront (`wavefront_s`: the
program's span around `engine_np.mine_from_level`, within `tail_s`, which
also holds the live pairs' pull, the frontier's decode and the densify),
from the `profile` dict that `mine_torch` fills, a job's average over the
untraced window, in ms; None for a program without the span."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tail, mining.engine_np.mine_from_level"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("wavefront_s")
