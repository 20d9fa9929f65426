"""The host tail's wavefront a level: 1e6 x the window's summed
`wavefront_s` (the program's span around `engine_np.mine_from_level`)
over its summed `tail_levels` (the levels that wavefront ran), from the
`profile` dicts that `mine_torch` fills, over the untraced window, in us;
None for a program without the counter."""

KIND = "per_layer"
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tail, mining.engine_np.mine_from_level"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    profs = [j.profile for j in run.jobs if "tail_levels" in j.profile]
    levels = sum(p["tail_levels"] for p in profs)
    if not levels:
        return None
    return 1e6 * sum(p["wavefront_s"] for p in profs) / levels
