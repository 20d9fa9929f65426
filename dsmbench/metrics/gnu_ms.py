"""A job's seconds in the gnu reader-order reconstruction (`gnu_s`: the
program's span around `mining.gnulazy.LazyGnuOrder`'s answers, in the
drains and the host tail: the reconstruction of each printed line's
reader order and its entropy sum in that order), from the `profile` dict
that `mine_torch` fills, a job's average over the untraced window, in ms;
None for a program without the span."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "gnu reconstruction, mining.gnulazy.LazyGnuOrder"
MOVES = "paths_per_s"
WORKLOADS = ["d64.whole.gnu"]


def read(run):
    return run.phase_ms("gnu_s")
