"""A job's seconds in the level loop (`level_s`: each level's launches and its
one readback), from the `profile` dict that `mine_torch` fills (the
program's host clock around the phase), a job's average over the untraced
window, in ms."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "level loop, mining.engine_device._level (K1, K2, emit, K3)"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("level_s")
