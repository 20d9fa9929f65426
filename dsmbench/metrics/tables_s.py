"""Set-up: the seconds of the dense cumulative tables' builds
(`FMIndex.dcum`/`rdcum`, made on the host tail's first use, in the
warm-up job), the program's once-a-process span `tables_s`
(`dsm_tpu_torch.utils.trace.PROCESS`); None for a program without it."""

KIND = "per_layer"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tail, mining.engine_np.mine_from_level"
MOVES = "setup_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    try:
        from dsm_tpu_torch.utils.trace import PROCESS
    except ImportError:
        return None
    return PROCESS.get("tables_s")
