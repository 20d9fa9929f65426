"""Index construction for the port, the suffix arrays on a torch device:
fmindex (FMIndex from texts), incremental (flush + merge), build (FASTA ->
.dsmi/.fmi, `indexes_from_fasta`)."""

from .build import build_index, indexes_from_fasta

__all__ = ["build_index", "indexes_from_fasta"]
