"""A job's seconds in the drains (`drain_s`: leftChar codes, path decode, the
host's f64 re-gate and line assembly), from the `profile` dict that
`mine_torch` fills (the program's host clock around the phase), a job's
average over the untraced window, in ms."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "drain, mining.engine_device._drain (K5, K6, re-gate)"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("drain_s")
