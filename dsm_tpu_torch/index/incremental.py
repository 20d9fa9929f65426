"""Incremental FM-index construction with the batch's suffix array on a
torch device.

Counterpart of dsm_tpu/index/incremental.py `merge_indexes` and
`IncrementalBuilder`: buffered texts are flushed into an index, and each
later flush is merged into it by per-suffix gap counts (`batch_gaps`).
Only the batch's suffix arrays move to `device` (ops/sa.suffix_array;
device=None sorts them on the host); the gaps, the interleave and the occ
tables stay on the host, as in dsm_tpu.

The gap of a batch suffix is the number of existing-index suffixes that
sort before it.  Processing each text RIGHT TO LEFT this is one O(1)
recurrence per position,
    r(i) = C_A[c_i] + occ_A(c_i, r(i+1)),
seeded at each terminator with ntexts_A (existing terminators sort first:
the distinct-terminator tie-break, matching RLCSA's sequence-id ordering,
rlcsa.cpp:156-221).  The recurrence is sequential in i but vectorized
across all texts of the batch.  The batch row with batch-rank k lands at
merged position gaps[k] + k; existing rows fill the rest in order.
Suffixes tied through terminators may order differently than a whole-batch
rebuild: no DNA-pattern query can tell them apart.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops.rank import OccTable, occ_prefix_np
from .fmindex import (DEFAULT_SAMPLERATE, FMIndex, _batch_codes,  # noqa: F401
                      collection_codes, sa_and_bwt)


def batch_gaps(table: OccTable, C: np.ndarray, ntexts_a: int,
               codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """gaps[i] = # suffixes of the existing index sorting before the batch
    suffix at concatenated position i (distinct-terminator convention)."""
    n_b = codes.shape[0]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    ends = starts + lengths  # exclusive
    T = lengths.shape[0]
    gaps = np.empty(n_b, dtype=np.int64)
    # terminator rows: all of a's terminators sort first
    gaps[ends - 1] = ntexts_a
    r = np.full(T, ntexts_a, dtype=np.int64)
    maxlen = int(lengths.max())
    for k in range(2, maxlen + 1):
        pos = ends - k
        act = pos >= starts
        p = np.where(act, pos, starts)
        c = codes[p]
        r_new = C[c] + occ_prefix_np(table, c, r)
        r = np.where(act, r_new, r)
        gaps[p[act]] = r[act]
    return gaps


def _merge_bwt(table: OccTable, C: np.ndarray, ntexts_a: int, n_a: int,
               codes: np.ndarray, lengths: np.ndarray, device) -> OccTable:
    """One direction of the merge: interleave the batch's BWT into an
    existing BWT by per-suffix gap counts."""
    sa_b, bwt_b = sa_and_bwt(codes, device=device)
    if device is not None:
        sa_b = sa_b.cpu().numpy().astype(np.int64)
    gaps = batch_gaps(table, C, ntexts_a, codes, lengths)[sa_b]

    n_b = codes.shape[0]
    merged = np.empty(n_a + n_b, dtype=np.int8)
    b_dest = gaps + np.arange(n_b, dtype=np.int64)
    mask = np.ones(n_a + n_b, dtype=bool)
    mask[b_dest] = False
    merged[b_dest] = bwt_b
    merged[mask] = table.blocks.reshape(-1)[:n_a]
    return OccTable.build(merged)


def merge_indexes(a: FMIndex, texts: Sequence[np.ndarray],
                  names: Sequence[str] | None = None, *,
                  device) -> FMIndex:
    """Merge already-transformed `texts` into index `a` -> new FMIndex,
    both directions by the same gap interleave."""
    codes, rcodes, lengths, max_len = collection_codes(texts)
    table = _merge_bwt(a.table, a.C, a.number_of_texts, a.n, codes, lengths,
                       device)
    rtable = _merge_bwt(a.rtable, a.C, a.number_of_texts, a.n, rcodes,
                        lengths, device)
    return FMIndex(
        n=a.n + codes.shape[0],
        table=table,
        number_of_texts=a.number_of_texts + len(texts),
        max_text_length=max(a.max_text_length, max_len),
        samplerate=a.samplerate,
        names=list(a.names) + (list(names) if names is not None else []),
        _rtable=rtable,
    )


class IncrementalBuilder:
    """Bounded-memory construction: buffer transformed texts up to
    `buffer_symbols`, flush each full buffer into an index on `device`,
    merging into the running index."""

    def __init__(self, buffer_symbols: int = 64 << 20,
                 samplerate: int = DEFAULT_SAMPLERATE, *, device) -> None:
        self.buffer_symbols = buffer_symbols
        self.samplerate = samplerate
        self.device = device
        self._texts: list[np.ndarray] = []
        self._names: list[str] = []
        self._pending = 0
        self._index: FMIndex | None = None

    def insert(self, text: np.ndarray, name: str = "") -> None:
        self._texts.append(np.asarray(text, dtype=np.uint8))
        self._names.append(name)
        self._pending += len(text) + 1
        if self._pending >= self.buffer_symbols:
            self.flush()

    def flush(self) -> None:
        if not self._texts:
            return
        if self._index is None:
            self._index = FMIndex.from_texts(
                self._texts, self._names, samplerate=self.samplerate,
                device=self.device)
        else:
            self._index = merge_indexes(self._index, self._texts,
                                        self._names, device=self.device)
        self._texts, self._names, self._pending = [], [], 0

    def finish(self) -> FMIndex:
        self.flush()
        if self._index is None:
            raise ValueError("cannot index an empty collection")
        return self._index
