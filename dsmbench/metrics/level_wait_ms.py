"""A job's seconds blocked at its levels' one readback (`level_wait_s`: the
program's span around the `.tolist()` of each level's sums, within
`level_s`), from the `profile` dict that `mine_torch` fills, a job's
average over the untraced window, in ms.  `level_ms` less it is the level
loop's host time; None for a program without the span."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "level loop, mining.engine_device._level (K1, K2, emit, K3)"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("level_wait_s")
