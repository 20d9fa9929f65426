"""Index construction, `dsm_tpu_torch build`: FASTA -> .dsmi or .fmi.

Counterpart of dsm_tpu/index/build.py `build_index` (the reference's
build flow, builder.cpp:203-285) with the suffix arrays on a torch device,
or with device=None by the host NumPy sort (`--sa-backend numpy`): read
the records, apply the reference's transform, build one index over all
records (or flush and merge every `buffer_symbols`), and save it with
`FMIndex.save` (.dsmi) or `fmi_compat.save_fmi` (.fmi).  With -v, stderr
carries the lines `dsm build -v` prints.
"""

from __future__ import annotations

import os
import sys
import time

from .alphabet import transform
from .fasta import read_fasta
from .fmindex import DEFAULT_SAMPLERATE, FMIndex
from .incremental import IncrementalBuilder

INDEX_EXTENSION = ".dsmi"


def libname(path: str) -> str:
    """Sample name from an index/input filename: basename up to the first
    '.' (metaenumerate.cpp:79-88)."""
    base = path.replace("\\", "/").rsplit("/", 1)[-1]
    return base.split(".", 1)[0]


def build_index(input_fasta: str, output: str | None = None,
                samplerate: int = DEFAULT_SAMPLERATE, *, device,
                fmt: str = "dsmi", buffer_symbols: int = 0,
                verbose: bool = False) -> str:
    """Build the index of one FASTA file and save it; -> the path written.
    `device`: the torch device of the suffix sorts, or None for the host
    NumPy sort."""
    t0 = time.time()
    if verbose and device is not None:
        print(f"builder: sa-backend auto -> {device}", file=sys.stderr)
    texts, names = [], []
    for rec in read_fasta(input_fasta):
        texts.append(transform(rec.seq))
        names.append(rec.name)
    if verbose:
        total = sum(len(t) + 1 for t in texts)
        print(f"builder: {len(texts)} sequences, n = {total} "
              f"({time.time() - t0:.1f}s read+transform)", file=sys.stderr)
    if buffer_symbols:
        ib = IncrementalBuilder(buffer_symbols=buffer_symbols,
                                samplerate=samplerate, device=device)
        for t, nm in zip(texts, names):
            ib.insert(t, nm)
        idx = ib.finish()
    else:
        idx = FMIndex.from_texts(texts, names, samplerate=samplerate,
                                 device=device)
    if fmt == "fmi":
        from .fmi_compat import save_fmi

        return save_fmi(idx, output if output is not None else input_fasta)
    out = output if output is not None else input_fasta + INDEX_EXTENSION
    if not out.endswith(INDEX_EXTENSION):
        out += INDEX_EXTENSION
    idx.save(out)
    if verbose:
        print(f"builder: saved {out} (n = {idx.n}, "
              f"{time.time() - t0:.1f}s total)", file=sys.stderr)
    return out


def indexes_from_fasta(paths: list[str], device) -> list[FMIndex]:
    """One FM-index per FASTA file (one text per record), named by the
    file's basename, with the suffix arrays on `device`."""
    return [FMIndex.from_texts([transform(rec.seq) for rec in read_fasta(p)],
                               names=[os.path.basename(p)], device=device)
            for p in paths]
