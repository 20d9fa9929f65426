"""Reader for RLCSA `.rlcsa.array` artifacts (the port's copy of
dsm_tpu/index/rlcsa.py) — the last reference index
format (TextCollection::load dispatches it, TextCollection.cpp:27-62;
format documented in incbwt/README:26-43).

The artifact serializes, with 64-bit little-endian integers (the DSM
build defines MASSIVE_DATA_RLCSA, Makefile:9):

  1. alphabet: 256 x u64 character counts (Alphabet::writeTo,
     alphabet.cpp:63-70);
  2. for every character c with count > 0, ascending: one PsiVector —
     the run-length-encoded increasing position set of c in the BWT
     (rlcsa.h:40-50, rlcsa.cpp:243-249).  PsiVector is NibbleVector in
     the DSM build (incbwt/Makefile:14 PSI_FLAGS=-DUSE_NIBBLE_VECTORS,
     pulled in by the root `make -C incbwt library`) and RLEVector when
     that flag is off; both use the same (gap, run-length) block
     structure with different integer codes, so the reader tries the
     nibble codec first and falls back to Elias delta;
  3. end_points: one DeltaVector of sequence end positions;
  4. sample_rate: u64.

Each bit vector (bits/bitvector.cpp:72-101) is:
    header  = size, items, number_of_blocks, block_size (4 x u64;
              block_size counts u64 WORDS)
    array   = number_of_blocks * block_size u64 words
    samples = 2*(number_of_blocks+1) packed integers of
              integer_bits = bitlength(size) bits each, padded to whole
              u64 words (ReadBuffer, bitbuffer.h)
Bits are consumed MSB-first within each u64 word (bitbuffer.h:71-98).
Block b of an RLEVector holds items [samples[2b], samples[2b+2]): the
first item's value IS samples[2b+1]; the rest follow as Elias
delta-coded (gap, run-length) pairs (RLEVector::Iterator::select,
rlevector.cpp:68-92; delta code bitbuffer.h:223-231).

`read_bwt` reconstructs the BWT exactly like RLCSA::readBWT
(rlcsa.cpp:808-844): every position in array[c] gets byte c; the
remaining number_of_sequences positions are the '\\0' end markers.
"""

from __future__ import annotations

import os

import numpy as np

ARRAY_EXTENSION = ".rlcsa.array"


class _Bits:
    """MSB-first bit cursor over little-endian u64 words."""

    def __init__(self, words: np.ndarray) -> None:
        # big-endian byte view puts the MSB of each u64 first, so the
        # unpacked bit stream is in consumption order
        self.bits = np.unpackbits(
            np.frombuffer(words.astype("<u8").byteswap().tobytes(),
                          dtype=np.uint8))
        self.pos = 0

    def read_bits(self, k: int) -> int:
        v = 0
        for b in self.bits[self.pos:self.pos + k]:
            v = (v << 1) | int(b)
        self.pos += k
        return v

    def read_delta(self) -> int:
        ln = 0
        while self.bits[self.pos] == 0:
            ln += 1
            self.pos += 1
        self.pos += 1
        temp = ((1 << ln) | self.read_bits(ln)) - 1
        return (1 << temp) | self.read_bits(temp)

    def read_nibble_code(self) -> int:
        """Nibble code (bitbuffer.h:118-130): 4-bit chunks MSB-first in
        the stream, each contributing 3 value bits LSB-first, terminated
        by a chunk with bit 3 set; the coded value is offset by 1."""
        value = 0
        shift = 0
        while True:
            nib = self.read_bits(4)
            value |= (nib & 0x7) << shift
            shift += 3
            if nib & 0x8:
                return value + 1


def _read_packed_items(words: np.ndarray, count: int,
                       item_bits: int) -> np.ndarray:
    """Vectorized MSB-first fixed-width field extraction."""
    if count == 0 or item_bits == 0:
        return np.zeros(count, dtype=np.uint64)
    bits = np.unpackbits(
        np.frombuffer(words.astype("<u8").byteswap().tobytes(),
                      dtype=np.uint8))
    idx = (np.arange(count)[:, None] * item_bits
           + np.arange(item_bits)[None, :])
    fields = bits[idx].astype(np.uint64)
    weights = (np.uint64(1) << np.arange(item_bits - 1, -1, -1,
                                         dtype=np.uint64))
    return fields @ weights


class _File:
    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            self.buf = f.read()
        self.off = 0

    def u64(self, count: int = 1) -> np.ndarray:
        out = np.frombuffer(self.buf, dtype="<u8", count=count,
                            offset=self.off)
        self.off += 8 * count
        return out


def _read_vector_header(f: _File):
    size, items, nblocks, block_size = (int(v) for v in f.u64(4))
    array = f.u64(nblocks * block_size)
    integer_bits = max(int(size).bit_length(), 0)
    n_sample_items = 2 * (nblocks + 1)
    sample_words = -(-n_sample_items * integer_bits // 64)
    samples = _read_packed_items(f.u64(sample_words), n_sample_items,
                                 integer_bits)
    return size, items, nblocks, block_size, array, samples


def _rle_positions(size, items, nblocks, block_size, array,
                   samples, codec: str = "nibble") -> np.ndarray:
    """All 1-positions of one PsiVector, ascending."""
    out = np.empty(items, dtype=np.int64)
    k = 0
    for b in range(nblocks):
        idx0 = int(samples[2 * b])
        val = int(samples[2 * b + 1])
        count = int(samples[2 * b + 2]) - idx0
        if count <= 0:
            continue
        out[k] = val
        k += 1
        got = 1
        bits = _Bits(array[b * block_size:(b + 1) * block_size])
        read = (bits.read_nibble_code if codec == "nibble"
                else bits.read_delta)
        while got < count:
            gap = read()
            run = read()
            run = min(run, count - got)
            start = val + gap
            if start <= val or start + run > size:
                raise ValueError("PsiVector run out of range")
            out[k:k + run] = np.arange(start, start + run)
            val = start + run - 1
            k += run
            got += run
    if k != items:
        raise ValueError(
            f"PsiVector decode mismatch: {k} items, header says {items}")
    return out


def _delta_positions(size, items, nblocks, block_size, array,
                     samples) -> np.ndarray:
    """All 1-positions of one DeltaVector (one delta code per item —
    DeltaVector::Iterator::nextValue, deltavector.cpp:143-154)."""
    out = np.empty(items, dtype=np.int64)
    k = 0
    for b in range(nblocks):
        idx0 = int(samples[2 * b])
        val = int(samples[2 * b + 1])
        count = int(samples[2 * b + 2]) - idx0
        if count <= 0:
            continue
        out[k] = val
        k += 1
        bits = _Bits(array[b * block_size:(b + 1) * block_size])
        for _ in range(count - 1):
            val += bits.read_delta()
            out[k] = val
            k += 1
    if k != items:
        raise ValueError(
            f"DeltaVector decode mismatch: {k} items, header says {items}")
    return out


def read_bwt(path: str) -> tuple[np.ndarray, int, np.ndarray]:
    """Decode `<base>.rlcsa.array` -> (BWT bytes as uint8, number of
    sequences, end positions).  The BWT is over the reference byte
    alphabet with '\\0' end markers, ready for alphabet.encode."""
    f = _File(path)
    counts = f.u64(256).astype(np.int64)
    data_size = int(counts.sum())
    vecs: list[tuple[int, tuple]] = []
    for c in range(256):
        if counts[c] == 0:
            continue
        vec = _read_vector_header(f)
        if vec[1] != counts[c]:
            raise ValueError(
                f"{path}: char {c} vector has {vec[1]} items, alphabet "
                f"says {counts[c]}")
        vecs.append((c, vec))
    pos_sets: list[tuple[int, np.ndarray]] = []
    for codec in ("nibble", "delta"):
        try:
            pos_sets = [(c, _rle_positions(*vec, codec=codec))
                        for c, vec in vecs]
            break
        except ValueError:
            if codec == "delta":
                raise
    ep = _read_vector_header(f)
    ends = _delta_positions(*ep)       # sequence end positions
    nseq = int(ep[1])
    n = data_size + nseq
    bwt = np.zeros(n, dtype=np.uint8)
    covered = 0
    for c, pos in pos_sets:
        if pos.size and (pos[0] < 0 or pos[-1] >= n):
            raise ValueError(f"{path}: position out of range for char {c}")
        bwt[pos] = c
        covered += pos.size
    if covered != data_size:
        raise ValueError(f"{path}: covered {covered} of {data_size}")
    return bwt, nseq, ends


def load_rlcsa(path: str):
    """`FMIndex` from an RLCSA artifact.  `path` may be the base name or
    the `.rlcsa.array` file itself.  The samplerate is taken from a
    sibling `.rlcsa.parameters` file when present (SAMPLE_RATE key,
    incbwt/README:38-43)."""
    from . import alphabet
    from ..ops.rank import OccTable
    from .fmindex import DEFAULT_SAMPLERATE, FMIndex

    base = (path[: -len(ARRAY_EXTENSION)]
            if path.endswith(ARRAY_EXTENSION) else path)
    array_path = base + ARRAY_EXTENSION
    bwt, nseq, ends = read_bwt(array_path)
    codes = alphabet.encode(bwt)
    table = OccTable.build(codes)
    # Known limit (ADVICE.md, as in dsm_tpu): SAMPLE_RATE is read but the
    # sibling .rlcsa.sa_samples file is not decoded, so the index comes
    # back with a samplerate and sa_samples=None: it searches and mines,
    # locate() raises.  An artifact without sequences fails in the
    # starts/ends arithmetic below, not with a message of its own.
    samplerate = DEFAULT_SAMPLERATE
    params = base + ".rlcsa.parameters"
    if os.path.exists(params):
        for line in open(params):
            if line.split("=")[0].strip() == "SAMPLE_RATE":
                samplerate = int(line.split("=")[1])
    # per-text lengths from the end-point positions (position space is
    # the original collection: text k occupies (ends[k-1], ends[k]))
    starts = np.concatenate([[-1], ends[:-1]])
    max_len = int((ends - starts).max(initial=0))
    return FMIndex(n=int(bwt.shape[0]), table=table,
                   number_of_texts=nseq,
                   max_text_length=max_len, samplerate=samplerate,
                   names=[])
