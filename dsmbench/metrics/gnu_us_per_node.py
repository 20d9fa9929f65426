"""The gnu reader-order tracker's host seconds a trie node it expanded: 1e6
x the window's summed `gnu_s` over its summed `gnu_nodes` (the nodes whose
children's reader orders it rebuilt), from the `profile` dicts that
`mine_torch` fills, over the untraced window, in us; None for a program
without the counter, or one that expanded no node.  `gnu_s` is all of
`mining.gnulazy.LazyGnuOrder`'s answers, so the numerator also holds the
work done a printed line (its entropy sum in reader order, and the order
lookups that find the node already expanded): the ratio is an upper bound
on a node's expansion, not its cost alone."""

KIND = "per_layer"
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "gnu reconstruction, mining.gnulazy.LazyGnuOrder"
MOVES = "paths_per_s"
WORKLOADS = ["d64.whole.gnu"]


def read(run):
    profs = [j.profile for j in run.jobs if "gnu_nodes" in j.profile]
    nodes = sum(p["gnu_nodes"] for p in profs)
    if not nodes:
        return None
    return 1e6 * sum(p["gnu_s"] for p in profs) / nodes
