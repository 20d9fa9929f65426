"""The device time of the program's own CUDA kernels (the `__global__`
functions of dsm_tpu_torch/csrc, matched by name in the profiler's
trace), a job's average over the traced window, in ms."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels, csrc/*.cu via ops/*"
MOVES = "paths_per_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 1e3 * run.trace.kernel_s / run.trace.jobs
