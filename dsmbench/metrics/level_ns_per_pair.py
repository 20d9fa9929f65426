"""The level loop's seconds per (node, sample) pair of the levels run: 1e9 x
the window's summed `level_s` over its summed `pairs` (the pairs of every
level run, a level redone after a HISTFULL exit counted again), from the
`profile` dicts that `mine_torch` fills, over the untraced window, in ns;
None for a program without the counter."""

KIND = "per_layer"
UNIT = "ns"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "level loop, mining.engine_device._level (K1, K2, emit, K3)"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    profs = [j.profile for j in run.jobs if "pairs" in j.profile]
    pairs = sum(p["pairs"] for p in profs)
    if not pairs:
        return None
    return 1e9 * sum(p["level_s"] for p in profs) / pairs
