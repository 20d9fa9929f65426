"""Set-up: the seconds of the tables' one upload (`DeviceIndexes.build`:
the host's packing of the fused occ rows and the copy), by the
benchmark's clock, ending synchronised."""

KIND = "per_layer"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "table upload, mining.engine.DeviceIndexes.build"
MOVES = "setup_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    return run.upload_s
