"""Set-up: the seconds of the upload's host packing (`fused_rows` of every
sample's two tables and their concatenation, in
`DeviceIndexes.build`), the program's once-a-process span `pack_s`
(`dsm_tpu_torch.utils.trace.PROCESS`); `upload_s` less it is mostly the
copy.  None for a program without it."""

KIND = "per_layer"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "table upload, mining.engine.DeviceIndexes.build"
MOVES = "setup_s"
WORKLOADS = ["s1000.whole.asc", "s1000.prefix2.asc"]


def read(run):
    try:
        from dsm_tpu_torch.utils.trace import PROCESS
    except ImportError:
        return None
    return PROCESS.get("pack_s")
