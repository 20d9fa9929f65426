"""A job's seconds in the HISTFULL history pulls (`pull_s`; 0 in a job with no
HISTFULL exit), from the `profile` dict that `mine_torch` fills (the
program's host clock around the phase), a job's average over the untraced
window, in ms."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "history pull, mining.engine_device._pull_segment"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("pull_s")
