"""Alphabet codes and the exact builder input transform (the port's copy
of dsm_tpu/index/alphabet.py).

The post-normalization alphabet of the reference mining pipeline is at most
seven symbols: '\\0' (text terminator), '-' (forward/revcomp separator),
and A C G T N (reference: builder.cpp:60-104,183-201).  We map them to dense
int8 codes in ASCII order so that the C-table/occ-table layout is a flat
8-wide array (code 7 is a padding sentinel that never occurs in a text).

The `transform` function reproduces the reference builder's preprocessing
bit-exactly (reference: builder.cpp:183-201):
  1. normalize to upper-case ACGTN ('0123.' kept for the deprecated SOLiD
     path, every other byte -> 'N') (builder.cpp:60-104)
  2. append '-' + reverse-complement (complement swaps only ACGT;
     builder.cpp:35-55,192-197)
  3. reverse the whole string (builder.cpp:199-200)
"""

from __future__ import annotations

import numpy as np

# Dense codes, ASCII order: '\0' < '-' < 'A' < 'C' < 'G' < 'N' < 'T'
TERM = 0      # '\0'
SEP = 1       # '-'
A, C, G, N, T = 2, 3, 4, 5, 6
PAD = 7       # padding sentinel, never present in any text
SIGMA = 8     # occ-table width

CODE_TO_CHAR = np.frombuffer(b"\x00-ACGNT\xff", dtype=np.uint8).copy()

CHAR_TO_CODE = np.full(256, -1, dtype=np.int16)
for _code, _ch in enumerate(CODE_TO_CHAR):
    CHAR_TO_CODE[_ch] = _code

# Extension alphabet in the reference's enumeration order {A,C,G,T}
# (reference: Query.cpp:3).  These are the only symbols ever pushed.
EXT_CODES = np.array([A, C, G, T], dtype=np.int8)
EXT_CHARS = b"ACGT"

_NORMALIZE_LUT = np.full(256, ord("N"), dtype=np.uint8)
for _b in b"ACGTN0123.":
    _NORMALIZE_LUT[_b] = _b
for _lo, _up in zip(b"acgtn", b"ACGTN"):
    _NORMALIZE_LUT[_lo] = _up

_COMPLEMENT_LUT = np.arange(256, dtype=np.uint8)
for _x, _y in zip(b"ACGT", b"TGCA"):
    _COMPLEMENT_LUT[_x] = _y


def normalize(seq: bytes | np.ndarray) -> np.ndarray:
    """Upper-case and map invalid symbols to 'N' (builder.cpp:60-104)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return _NORMALIZE_LUT[arr]


def transform(seq: bytes | np.ndarray) -> np.ndarray:
    """normalize + append '-' + revcomp + reverse all (builder.cpp:183-201).

    Returns the transformed text as a uint8 byte array (no terminator).
    """
    fwd = normalize(seq)
    revcmpl = _COMPLEMENT_LUT[fwd[::-1]]
    full = np.concatenate([fwd, np.frombuffer(b"-", dtype=np.uint8), revcmpl])
    return full[::-1].copy()


def encode(text: np.ndarray) -> np.ndarray:
    """Map text bytes to dense int8 codes.  Raises on bytes outside the
    mining alphabet (the deprecated SOLiD '0123.' path is not supported)."""
    codes = CHAR_TO_CODE[text]
    if codes.min(initial=0) < 0:
        bad = np.unique(text[codes < 0])
        raise ValueError(f"bytes outside mining alphabet: {bad.tobytes()!r}")
    return codes.astype(np.int8)


def decode(codes: np.ndarray) -> bytes:
    return CODE_TO_CHAR[np.asarray(codes, dtype=np.int64)].tobytes()
