"""Rank over a small-alphabet BWT: the host occ tables and the fused rank
on the device (kernel 1, csrc/rank.cu).

Counterpart of dsm_tpu/ops/rank.py.  The host half is the port's copy of
its storage layout and NumPy oracles:

  * `OccTable`: `blocks` (nblocks, BLOCK) int8 BWT codes, PAD-padded, and
    `occ` (nblocks + 1, SIGMA) int32 per-symbol counts at block starts, so
    `occ(c, i) = occ[i // BLOCK, c] + #(blocks[i // BLOCK, : i % BLOCK] == c)`
    and `LF(c, i) = C[c] + occ(c, i)` (FMIndex.h:84-90);
  * `fused_rows`: one uint32 row per block fusing the sampled counts with
    THERMOMETER BITPLANES of the codes,
        row[0:8]  = cum8[b]: cum8[j] = #{i < b*BLOCK : code[i] <= j}
        row[8:28] = planes j=1..5, 4 words each: bit k of word w is
                    (code[b*BLOCK + 32*w + k] <= j), LSB-first
    so one 128-byte row and 5 (AND + popcount over 4 words) give the
    cumulative <=-counts cum(1..5, i), from which the per-symbol occ of
    every extension base (A=cum2-cum1, C=cum3-cum2, G=cum4-cum3,
    T=i-cum5) and the lexicographic prefix sums of the bidirectional
    interval synchronisation fall out (the symbol codes are in ASCII
    order, index/alphabet.py, which is what makes <=-counts enough);
  * `occ_prefix_np`, `occ_cum_np`: the NumPy oracles.

The device half is the counterpart of `occ_cumT` / `occ_cum8T`.  Its table
is the ROW-major (R, ROWW) `fused_rows` table (stored as int32 bit
patterns: torch has no general uint32 arithmetic); dsm_tpu's transposed
(32, R) layout is not carried over.

`occ_cum8(rows, pos, soff)` -> (8, Q) int32 with rows
[C4A+occA, C4C+occC, C4G+occG, pos-c5(+C4T), c1, c2, c3, c5] at the text
positions `pos` of the samples whose table rows start at `soff`: rows 0:4
are the four child interval bounds, rows 4:8 the lexicographic prefix
sums.  The JAX form takes (blk, rem, pos) with blk = (pos >> 7) + soff and
rem = pos & 127; the kernel derives both itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.alphabet import PAD, SIGMA
from . import _build

BLOCK = 128        # BWT codes per block: one table row
LOG2_BLOCK = 7
ROWW = 32          # fused uint32 row width: 8 cum + 5 planes x 4 words (+pad)
_NPLANES = 5       # thermometer levels j = 1..5 (j=6 is the identity: pos)


@dataclass
class OccTable:
    """Sampled occurrence counts + padded code blocks for one BWT."""

    n: int
    blocks: np.ndarray  # (nblocks, BLOCK) int8
    occ: np.ndarray     # (nblocks + 1, SIGMA) int32
    counts: np.ndarray  # (SIGMA,) int64 — total per-symbol counts
    C: np.ndarray       # (SIGMA + 1,) int64 — chars with smaller code

    @classmethod
    def build(cls, bwt: np.ndarray) -> "OccTable":
        n = int(bwt.shape[0])
        nblocks = -(-n // BLOCK) if n else 0
        padded = np.full(nblocks * BLOCK, PAD, dtype=np.int8)
        padded[:n] = bwt
        blocks = padded.reshape(nblocks, BLOCK)
        onehot = blocks[:, :, None] == np.arange(SIGMA, dtype=np.int8)
        per_block = onehot.sum(axis=1, dtype=np.int64)
        occ = np.zeros((nblocks + 1, SIGMA), dtype=np.int64)
        np.cumsum(per_block, axis=0, out=occ[1:])
        counts = occ[-1].copy()
        if n:
            counts[PAD] -= nblocks * BLOCK - n  # padding is not text
            occ[-1, PAD] = counts[PAD]
        C = np.zeros(SIGMA + 1, dtype=np.int64)
        np.cumsum(counts, out=C[1:])
        if int(C[-1]) != n:
            raise AssertionError("occ table count mismatch")
        return cls(n=n, blocks=blocks, occ=occ.astype(np.int32), counts=counts, C=C)


def occ_prefix_np(table: OccTable, syms: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """NumPy oracle: count of syms[j] in L[: pos[j]] for each query j.

    pos is a prefix *length* in [0, n]; this equals the reference's
    inclusive `rank(c, i)` at i = pos-1, with rank(c, -1) == 0
    (BitRank.cpp:191-195 wraps i+1 to 0 for i == (ulong)-1).
    """
    syms = np.atleast_1d(np.asarray(syms))
    pos = np.atleast_1d(np.asarray(pos, dtype=np.int64))
    b, r = pos >> LOG2_BLOCK, pos & (BLOCK - 1)
    base = table.occ[b, syms].astype(np.int64)
    rows = table.blocks[b]  # (Q, BLOCK)
    lane = np.arange(BLOCK, dtype=np.int64)
    inblock = ((rows == syms[:, None]) & (lane[None, :] < r[:, None])).sum(axis=1)
    return base + inblock


def fused_rows(table: OccTable, c4=None) -> np.ndarray:
    """Build the fused cum8+bitplane mining rows for one BWT.

    -> (nblocks + 1, ROWW) uint32.  The final row carries the total cum8
    so positions with i % BLOCK == 0 at i == nblocks*BLOCK resolve without
    touching planes.  PAD codes (tail padding) satisfy no plane test.

    `c4` ((4,) ints: C[c] for c in A,C,G,T) BAKES the per-sample LF base
    constants into the stored cum columns: with K = (0, C4[A],
    C4[A]+C4[C], C4[A]+C4[C]+C4[G], -C4[T]) added to cum(1..5), the
    per-symbol occ differences come out as C4[c] + occ(c, i) — the child
    interval bound itself — so the mining engine never gathers or adds C4
    at runtime.  The lexicographic prefix sums (psum4) and the leftChar
    counts only ever consume DIFFERENCES of cum values at two positions
    of the same sample, where K cancels exactly; the rank kernel returns
    the shifted values as int32 bit patterns (negative K wraps mod 2^32).
    """
    nblocks = table.blocks.shape[0]
    rows = np.zeros((nblocks + 1, ROWW), dtype=np.uint32)
    codes = table.blocks  # (nblocks, BLOCK) int8, PAD-padded
    # per-block per-symbol counts -> cumulative <=-counts at block starts
    onehot = codes[:, :, None] == np.arange(SIGMA, dtype=np.int8)
    per_block = onehot.sum(axis=1, dtype=np.int64)  # (nblocks, SIGMA)
    if nblocks:
        # padding is PAD (code 7); keep cum8[:, 7] text-only like occ
        per_block[-1, PAD] -= int(nblocks * BLOCK - table.n)
    cum = np.zeros((nblocks + 1, SIGMA), dtype=np.int64)
    np.cumsum(np.cumsum(per_block, axis=1), axis=0, out=cum[1:])
    if c4 is not None:
        a, c, g, t = (int(v) for v in c4)
        K = np.array([0, 0, a, a + c, a + c + g, -t, 0, 0], dtype=np.int64)
        cum = (cum + K[None, :]) & 0xFFFFFFFF
    rows[:, :SIGMA] = cum.astype(np.uint32)
    # thermometer planes
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    for j in range(1, _NPLANES + 1):
        bits = (codes <= j).reshape(nblocks, 4, 32)
        words = (bits.astype(np.uint64) * weights).sum(axis=2)
        rows[:nblocks, SIGMA + (j - 1) * 4: SIGMA + j * 4] = words.astype(np.uint32)
    return rows


def occ_cum_np(table: OccTable, pos: np.ndarray) -> np.ndarray:
    """NumPy oracle of the cumulative counts: (..., 5) int64 cumulative
    <=-counts of codes 1..5 in L[: pos]."""
    pos = np.asarray(pos, dtype=np.int64)
    flat = table.blocks.reshape(-1)
    out = np.empty(pos.shape + (5,), dtype=np.int64)
    for j in range(1, 6):
        le = np.concatenate([[0], np.cumsum(flat <= j)])
        out[..., j - 1] = le[pos]
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of int64 `x`."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (uint32 arithmetic, reinterpreted)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def occ_cum8_plain(rows: torch.Tensor, pos: torch.Tensor,
                   soff: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the rank kernel (any device)."""
    p = pos.to(torch.int64)
    blk = (p >> LOG2_BLOCK) + soff.to(torch.int64)
    rem = p & (BLOCK - 1)
    g = rows[blk].to(torch.int64) & 0xFFFFFFFF            # (Q, ROWW)
    planes = g[:, 8:8 + 4 * _NPLANES].reshape(-1, _NPLANES, 4)
    word = torch.arange(4, device=rows.device)
    wi = (rem >> 5)[:, None]
    part = (torch.bitwise_left_shift(torch.ones_like(rem), rem & 31)
            - 1)[:, None]
    m = torch.where(word[None, :] < wi, 0xFFFFFFFF,
                    torch.where(word[None, :] == wi, part, 0))   # (Q, 4)
    cnt = _popcount32(planes & m[:, None, :]).sum(dim=2)         # (Q, 5)
    c = (g[:, 1:6] + cnt).T                                      # (5, Q)
    out = torch.stack([c[1] - c[0], c[2] - c[1], c[3] - c[2], p - c[4],
                       c[0], c[1], c[2], c[4]])
    return _wrap32(out)


def occ_cum8(rows: torch.Tensor, pos: torch.Tensor,
             soff: torch.Tensor) -> torch.Tensor:
    """(8, Q) int32 fused rank.  rows: (R, ROWW) int32 contiguous;
    pos, soff: (Q,) int32, any stride.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if rows.device.type == "cpu":
        return occ_cum8_plain(rows, pos, soff)
    if rows.device.type != "cuda":
        raise ValueError(f"occ_cum8: unsupported device {rows.device}")
    if (rows.dtype != torch.int32 or rows.dim() != 2
            or rows.shape[1] != ROWW or not rows.is_contiguous()):
        raise ValueError("occ_cum8: rows must be contiguous (R, 32) int32")
    for name, t in (("pos", pos), ("soff", soff)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != rows.device:
            raise ValueError(f"occ_cum8: {name} must be 1-D int32 on "
                             f"{rows.device}")
    q = pos.shape[0]
    if soff.shape[0] != q:
        raise ValueError("occ_cum8: pos and soff differ in length")
    out = torch.empty((8, q), dtype=torch.int32, device=rows.device)
    if q == 0:
        return out
    _build.launch("dsm_occ_cum8", "rank", rows.device, rows.data_ptr(),
                  pos.data_ptr(), pos.stride(0), soff.data_ptr(),
                  soff.stride(0), out.data_ptr(), q)
    return out
