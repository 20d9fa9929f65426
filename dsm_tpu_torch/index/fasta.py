"""FASTA reading with the reference builder's exact record semantics (the
port's copy of dsm_tpu/index/fasta.py).

Reproduces the parsing loop of the reference builder (builder.cpp:203-264):
  * a '>' header line flushes the previous record (if its text is nonempty),
  * the record name is the first whitespace-delimited token after '>'
    (leading " \\t" skipped); an empty name becomes str(i-2) where i counts
    header lines seen so far,
  * sequence lines are appended verbatim (no stripping beyond the newline),
  * the final record is flushed at EOF.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator


@dataclass
class FastaRecord:
    name: str
    seq: bytes


def _open(path: str) -> io.BufferedReader:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def read_fasta(path: str) -> Iterator[FastaRecord]:
    """Yield records exactly as the reference builder would insert them."""
    with _open(path) as fp:
        yield from parse_fasta(fp)


def parse_fasta(fp) -> Iterator[FastaRecord]:
    i = 0
    name = "undef"
    chunks: list[bytes] = []
    for raw in fp:
        row = raw.rstrip(b"\n")
        if row[:1] == b">":
            # reference: row.substr(find_first_not_of(" \t", 1)), then token
            body = row[1:].lstrip(b" \t")
            token = body.split(b" ")[0].split(b"\t")[0]
            i += 1
            seq = b"".join(chunks)
            if seq:
                yield FastaRecord(name, seq)
            chunks.clear()
            name = token.decode("latin-1") if token else str(i - 2)
        else:
            chunks.append(row)
    seq = b"".join(chunks)
    if seq:
        yield FastaRecord(name, seq)
