"""End to end: the trie paths that the window's jobs mined, over the time
from the window's start to the last job's end (the host's clock; each job
ends synchronised with the card)."""

KIND = "end_to_end"
UNIT = "paths/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j.paths for j in run.jobs) / run.window_s
