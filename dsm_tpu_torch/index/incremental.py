"""Incremental FM-index construction with the batch's suffix array on a
torch device.

Counterpart of dsm_tpu/index/incremental.py `merge_indexes` and
`IncrementalBuilder`: buffered texts are flushed into an index, and each
later flush is merged into it by per-suffix gap counts (`batch_gaps`,
imported from dsm_tpu).  Only the batch's suffix
arrays move to `device` (ops/sa.suffix_array); the gaps, the interleave
and the occ tables stay on the host, as in dsm_tpu.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from dsm_tpu.index.fmindex import DEFAULT_SAMPLERATE, FMIndex
from dsm_tpu.index.incremental import batch_gaps
from dsm_tpu.ops.rank import OccTable

from .fmindex import collection_codes, fmindex_from_texts, sa_and_bwt


def _merge_bwt(table: OccTable, C: np.ndarray, ntexts_a: int, n_a: int,
               codes: np.ndarray, lengths: np.ndarray, device) -> OccTable:
    """One direction of the merge: interleave the batch's BWT into an
    existing BWT by per-suffix gap counts."""
    sa_t, bwt_b = sa_and_bwt(codes, device)
    sa_b = sa_t.cpu().numpy().astype(np.int64)
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
            self._index = fmindex_from_texts(
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
