"""FM-index construction with the suffix array on a torch device.

Counterpart of dsm_tpu/index/fmindex.py `FMIndex.from_texts` and
`_rtable_from_texts`: the same collection (each text encoded, then a
TERM), the suffix arrays of the forward and of the per-text reversed
collection by ops/sa.suffix_array on `device`, the BWT by a gather there,
and the occ tables built on the host by `OccTable.build`.  The result is
a `dsm_tpu.index.fmindex.FMIndex`, equal to the one `from_texts` builds:
the mining path, `FMIndex.save` and `save_fmi` take it unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dsm_tpu.index.fmindex import DEFAULT_SAMPLERATE, FMIndex, SASamples
from dsm_tpu.index.incremental import _batch_codes
from dsm_tpu.ops.rank import OccTable

from ..ops.sa import bwt_from_sa, suffix_array


def sa_and_bwt(codes: np.ndarray, device) -> tuple[torch.Tensor, np.ndarray]:
    """-> (suffix array, int32 on `device`; BWT, int8 on the host) of a
    code sequence."""
    codes_t = torch.as_tensor(codes, device=device)
    sa = suffix_array(codes_t)
    return sa, bwt_from_sa(codes_t, sa).cpu().numpy()


def collection_codes(texts: Sequence[np.ndarray]):
    """-> (codes, rcodes, lengths, max_len) of already-transformed texts:
    the forward collection (each text encoded, then a TERM), the per-text
    reversed one (each encoded text reversed, then its TERM), the
    per-text lengths with the TERM, and the largest of them."""
    codes, lengths, max_len = _batch_codes(texts)
    ends = np.cumsum(lengths)
    start = np.repeat(ends - lengths, lengths)
    end = np.repeat(ends, lengths)
    pos = np.arange(codes.shape[0])
    rcodes = codes[np.where(pos == end - 1, pos, start + end - 2 - pos)]
    return codes, rcodes, lengths, max_len


def fmindex_from_texts(texts: Sequence[np.ndarray],
                       names: Sequence[str] | None = None,
                       samplerate: int = DEFAULT_SAMPLERATE, *, device,
                       sample_sa: bool = False) -> FMIndex:
    """Build from already-transformed texts (uint8 byte arrays, no
    terminators), as `FMIndex.from_texts`, with both suffix arrays on
    `device`.  sample_sa=True keeps SA samples every `samplerate` text
    positions and at every text start, for locate()."""
    if not texts:
        raise ValueError("cannot index an empty collection")
    codes, rcodes, lengths, max_len = collection_codes(texts)
    sa_t, bwt = sa_and_bwt(codes, device)
    table = OccTable.build(bwt)
    rtable = OccTable.build(sa_and_bwt(rcodes, device)[1])
    samples = None
    if sample_sa:
        sa = sa_t.cpu().numpy().astype(np.int64)
        rate = max(1, samplerate)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        # every text start is sampled, so a locate() walk stops before a
        # terminator LF step (see FMIndex.from_texts)
        rows = np.flatnonzero((sa % rate == 0) | np.isin(sa, starts))
        samples = SASamples(rows=rows.astype(np.int64),
                            vals=sa[rows].astype(np.int64),
                            text_starts=starts.astype(np.int64))
    return FMIndex(
        n=int(codes.shape[0]), table=table, number_of_texts=len(texts),
        max_text_length=max_len, samplerate=samplerate,
        names=list(names) if names is not None else [],
        sa_samples=samples, _rtable=rtable)
