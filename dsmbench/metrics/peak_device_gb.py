"""End to end: the card's peak of allocated memory over set-up and the
window (`torch.cuda.max_memory_allocated`), the resident tables with it,
in GB (1e9 bytes): which sample sets fit a card."""

KIND = "end_to_end"
UNIT = "GB"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
