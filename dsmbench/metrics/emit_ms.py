"""A job's seconds in the drains' host half (`emit_s`: the program's span
around `_emit_drained`, within `drain_s`: the exact re-gate, the path
decode (K6 and its readback), the lines), from the `profile` dict that
`mine_torch` fills, a job's average over the untraced window, in ms; None
for a program without the span."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "drain, mining.engine_device._drain (K5, K6, re-gate)"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.phase_ms("emit_s")
