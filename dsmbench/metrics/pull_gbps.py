"""The HISTFULL history pulls' copy rate: the window's summed `pull_bytes`
(4 bytes an entry of the pulled levels) over its summed `pull_copy_s` (the
program's span around the device-to-host copy, within `pull_s`), from the
`profile` dicts that `mine_torch` fills, over the untraced window, in GB/s
(1e9 bytes); None in a window without a pull, or for a program without the
counter."""

KIND = "per_layer"
UNIT = "GB/s"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "history pull, mining.engine_device._pull_segment"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc"]


def read(run):
    profs = [j.profile for j in run.jobs if "pull_bytes" in j.profile]
    nbytes = sum(p["pull_bytes"] for p in profs)
    secs = sum(p["pull_copy_s"] for p in profs)
    if not nbytes or secs <= 0:
        return None
    return nbytes / secs / 1e9
