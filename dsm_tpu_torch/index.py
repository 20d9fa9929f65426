"""Host-side index input for the port: FASTA files -> FM-indexes.

The index build stays on the host (dsm_tpu's numpy suffix array); the
port uploads the fused occ tables (mining/engine.DeviceIndexes).
"""

from __future__ import annotations

import os

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex


def indexes_from_fasta(paths: list[str]) -> list[FMIndex]:
    """One FM-index per FASTA file (one text per record), built with the
    numpy suffix array, as `dsm build --sa-backend numpy` does."""
    return [FMIndex.from_texts([transform(rec.seq) for rec in read_fasta(p)],
                               names=[os.path.basename(p)])
            for p in paths]
