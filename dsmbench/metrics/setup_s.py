"""End to end: the seconds from the process's start to the window's start
(imports, the kernel library's load, the data, the index build, the
upload and the warm-up job)."""

KIND = "end_to_end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
