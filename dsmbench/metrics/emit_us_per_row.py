"""The drains' host half a staged row: 1e6 x the window's summed `emit_s`
(the program's span around `_emit_drained`: the exact re-gate, the path
decode, the lines) over its summed `drain_rows` (the staged rows the
drains pulled to the host), from the `profile` dicts that `mine_torch`
fills, over the untraced window, in us; None for a program without the
counter."""

KIND = "per_layer"
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "drain, mining.engine_device._drain (K5, K6, re-gate)"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    profs = [j.profile for j in run.jobs if "drain_rows" in j.profile]
    rows = sum(p["drain_rows"] for p in profs)
    if not rows:
        return None
    return 1e6 * sum(p["emit_s"] for p in profs) / rows
