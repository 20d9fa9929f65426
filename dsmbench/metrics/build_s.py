"""Set-up: the seconds of the index build on the card
(`indexes_from_fasta`: FASTA read, transform, suffix arrays, BWT and occ
tables), by the benchmark's clock, ending synchronised."""

KIND = "per_layer"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "index build, index.build.indexes_from_fasta"
MOVES = "setup_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.build_s
