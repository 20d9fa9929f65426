"""A job's seconds in the host tail (`tail_s`: the narrow deep frontier mined
on the host), from the `profile` dict that `mine_torch` fills (the program's
host clock around the phase), a job's average over the untraced window, in
ms."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tail, mining.engine_np.mine_from_level"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("tail_s")
