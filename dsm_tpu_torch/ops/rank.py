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

The device half is the counterpart of `occ_cumT` / `occ_cum8T` and of the
expand step built on them (dsm_tpu/mining/engine_device.py:714-724).  Its
table is the ROW-major (R, ROWW) `fused_rows` table (stored as int32 bit
patterns: torch has no general uint32 arithmetic); dsm_tpu's transposed
(32, R) layout is not carried over.  One kernel body (csrc/rank.cu) has
four entries, all counted as launches of `rank` (the drain's leftChar
codes have their wrapper beside the output rows they read:
mining/engine.leftchar_rows):

  * `occ_cum8(rows, pos, soff)` -> (8, Q) int32 with rows
    [C4A+occA, C4C+occC, C4G+occG, pos-c5(+C4T), c1, c2, c3, c5] at the
    text positions `pos` of the samples whose table rows start at `soff`:
    rows 0:4 are the four child interval bounds, rows 4:8 the
    lexicographic prefix sums.  The JAX form takes (blk, rem, pos) with
    blk = (pos >> 7) + soff and rem = pos & 127; the kernel derives both;
  * `expand(frows, pairs, fmin, sym_mask)`: the level's expand step on the
    (P, 6) pair rows -> (olo, ohi, freq, keepc, cbits), both ends' ranks
    and the gate inputs in one launch;
  * `expand_tables(tables, pairs, fmin, sym_mask)`: the same over the
    tables of a process's shards (the sharded level's one pair list), each
    pair ranked in the table its sample id falls in, also in one launch.

`occ_cum(rows, blk, rem)` is dsm_tpu's `occ_cum` (:158), the (..., 5)
cumulative counts at table row `blk` and offset `rem`: the `occ_cum8`
entry with `blk` as the row offset, no kernel of its own.  The per-level
engines' dense expand (K12) is a fifth kernel of csrc/rank.cu, wrapped in
ops/level.py.  `occ_batch(blocks, occ, syms, pos)` (K15, csrc/occbatch.cu)
is dsm_tpu's `occ_batch` (:270): the rank of one symbol a query on the raw
int8 BWT blocks and the occ table, as `occ_prefix_np` counts it.
"""

from __future__ import annotations

import array
from dataclasses import dataclass

import numpy as np
import torch

from ..index.alphabet import PAD, SIGMA
from . import _build
from .children import PAIR_COLS, PC_HI, PC_LO, PC_SID, PC_SOFF

BLOCK = 128        # BWT codes per block: one table row
LOG2_BLOCK = 7
ROWW = 32          # fused uint32 row width: 8 cum + 5 planes x 4 words (+pad)
_NPLANES = 5       # thermometer levels j = 1..5 (j=6 is the identity: pos)
MAX_TABLES = 128   # csrc/rank.cu kMaxShards: the tables of expand_tables


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
    if table.blocks.shape[0] == 0:
        return base
    # pos = n with n a multiple of BLOCK points past the last block, with
    # r = 0: that block's row is read and counts nothing (dsm_tpu's copy
    # indexes past the blocks there and raises)
    rows = table.blocks[np.minimum(b, table.blocks.shape[0] - 1)]
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


def occ_cum8_pair_plain(rows: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, soff: torch.Tensor):
    """The plain rank at both ends of each query: (at lo, at hi)."""
    return occ_cum8_plain(rows, lo, soff), occ_cum8_plain(rows, hi, soff)


def expand_plain(frows: torch.Tensor, pairs: torch.Tensor, fmin: int,
                 sym_mask: int):
    """Plain PyTorch version of the expand step (any device): the rank at
    both interval ends of every pair row and the gate inputs, as
    dsm_tpu's level computes them (engine_device.py:714-724)."""
    lo, hi, soff = pairs[:, PC_LO], pairs[:, PC_HI], pairs[:, PC_SOFF]
    olo, ohi = occ_cum8_pair_plain(frows, lo, hi, soff)
    pa = hi > lo
    freq = torch.where(pa, hi - lo, 0)
    cact = pa[None, :] & (ohi[:4] - olo[:4] >= fmin)        # (4, P)
    symv = (sym_mask >> torch.arange(4, device=pairs.device)) & 1
    keepc = cact & (symv[:, None] != 0)
    c8 = cact.to(torch.uint8)
    cbits = c8[0] | (c8[1] << 1) | (c8[2] << 2) | (c8[3] << 3)
    return olo, ohi, freq, keepc, cbits


def _check_rows(rows: torch.Tensor, who: str) -> None:
    if rows.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {rows.device}")
    if (rows.dtype != torch.int32 or rows.dim() != 2
            or rows.shape[1] != ROWW or not rows.is_contiguous()):
        raise ValueError(f"{who}: rows must be contiguous (R, 32) int32")


def _check_queries(rows: torch.Tensor, who: str, **cols) -> int:
    """The query columns' common length; raises unless each is a 1-D
    int32 tensor on the table's device."""
    q = None
    for name, t in cols.items():
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != rows.device:
            raise ValueError(f"{who}: {name} must be 1-D int32 on "
                             f"{rows.device}")
        if q is not None and t.shape[0] != q:
            raise ValueError(f"{who}: {', '.join(cols)} differ in length")
        q = t.shape[0]
    return q


def occ_cum8(rows: torch.Tensor, pos: torch.Tensor,
             soff: torch.Tensor) -> torch.Tensor:
    """(8, Q) int32 fused rank.  rows: (R, ROWW) int32 contiguous;
    pos, soff: (Q,) int32, any stride.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if rows.device.type == "cpu":
        return occ_cum8_plain(rows, pos, soff)
    _check_rows(rows, "occ_cum8")
    q = _check_queries(rows, "occ_cum8", pos=pos, soff=soff)
    out = torch.empty((8, q), dtype=torch.int32, device=rows.device)
    if q == 0:
        return out
    _build.launch("dsm_occ_cum8", "rank", rows.device, rows.data_ptr(),
                  pos.data_ptr(), pos.stride(0), soff.data_ptr(),
                  soff.stride(0), out.data_ptr(), q)
    return out


def _cum5(o8: torch.Tensor) -> torch.Tensor:
    """(8, Q) rank rows -> (Q, 5) cum(1..5): rows 4, 5, 6 are cum 1..3,
    row 7 cum 5, and cum 4 is cum 3 plus row 2 (mod 2^32, as the tables'
    baked C4 wraps)."""
    c4 = _wrap32(o8[6].to(torch.int64) + o8[2].to(torch.int64))
    return torch.stack([o8[4], o8[5], o8[6], c4, o8[7]], dim=-1)


def occ_cum_plain(rows: torch.Tensor, blk: torch.Tensor,
                  rem: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of occ_cum (any device)."""
    b, r = blk.reshape(-1), rem.reshape(-1)
    return _cum5(occ_cum8_plain(rows, r, b)).reshape(*blk.shape, 5)


def occ_cum(rows: torch.Tensor, blk: torch.Tensor,
            rem: torch.Tensor) -> torch.Tensor:
    """(..., 5) int32 cum(j, pos) for j = 1..5 at pos = blk * BLOCK + rem:
    rows (R, ROWW) int32 contiguous (several tables stacked: the caller
    adds a table's row offset to `blk`); blk (...,) int32 table rows; rem
    (...,) int32 in [0, BLOCK).  CPU tensors take the plain version; CUDA
    tensors launch the rank kernel's `occ_cum8` entry, one launch."""
    if rows.device.type == "cpu":
        return occ_cum_plain(rows, blk, rem)
    b = blk.reshape(-1).to(torch.int32)
    r = rem.reshape(-1).to(torch.int32)
    return _cum5(occ_cum8(rows, r, b)).reshape(*blk.shape, 5)


def occ_batch_plain(blocks: torch.Tensor, occ: torch.Tensor,
                    syms: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of occ_batch (any device)."""
    p = pos.to(torch.int64)
    s = syms.to(torch.int64)
    b, r = p >> LOG2_BLOCK, p & (BLOCK - 1)
    base = occ[b, s]
    if blocks.shape[0] == 0:
        return base.to(torch.int32)
    # pos = n at a block boundary points past the last block, with r = 0
    rows = blocks[b.clamp(max=blocks.shape[0] - 1)].to(torch.int64)
    lane = torch.arange(BLOCK, device=blocks.device)
    match = (rows == s[:, None]) & (lane[None, :] < r[:, None])
    return (base + match.sum(dim=1)).to(torch.int32)


def occ_batch(blocks: torch.Tensor, occ: torch.Tensor, syms: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """(Q,) int32: the count of syms[i] in L[: pos[i]] from the raw blocks
    (nblocks, BLOCK) int8 and the occ table (nblocks + 1, SIGMA) int32 of
    an `OccTable`; syms, pos (Q,) integers, 0 <= pos <= n.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (K15), one launch:
    blocks and occ contiguous, blocks 4-byte aligned (read with 16-byte
    loads where it is 16-byte aligned), syms and pos made int32 contiguous
    where they are not.  The kernel counts a query past the middle of its
    block from the block's end (occ[b + 1] less the codes from pos on), so
    occ must be the blocks' cumulative counts, as an `OccTable`'s are."""
    if blocks.device.type == "cpu":
        return occ_batch_plain(blocks, occ, syms, pos)
    device = blocks.device
    if device.type != "cuda":
        raise ValueError(f"occ_batch: unsupported device {device}")
    if (blocks.dtype != torch.int8 or blocks.dim() != 2
            or blocks.shape[1] != BLOCK or not blocks.is_contiguous()
            or blocks.data_ptr() % 4):
        raise ValueError(f"occ_batch: blocks must be contiguous, 4-byte "
                         f"aligned (nb, {BLOCK}) int8")
    if (occ.dtype != torch.int32 or occ.dim() != 2
            or occ.shape[0] != blocks.shape[0] + 1 or not occ.is_contiguous()
            or occ.device != device):
        raise ValueError("occ_batch: occ must be contiguous (nb + 1, sigma) "
                         f"int32 on {device}")
    if syms.shape != pos.shape or syms.dim() != 1:
        raise ValueError("occ_batch: syms and pos must be (Q,) alike")
    syms = syms.to(device=device, dtype=torch.int32).contiguous()
    pos = pos.to(device=device, dtype=torch.int32).contiguous()
    out = torch.empty(pos.shape[0], dtype=torch.int32, device=device)
    if pos.shape[0]:
        _build.launch("dsm_occ_batch", "occ_batch", device, blocks.data_ptr(),
                      blocks.shape[0], occ.data_ptr(), occ.shape[1],
                      syms.data_ptr(), pos.data_ptr(), out.data_ptr(),
                      pos.shape[0])
    return out


def expand(frows: torch.Tensor, pairs: torch.Tensor, fmin: int,
           sym_mask: int):
    """The expand step of a level on the (P, 6) int32 pair rows (columns
    PC_*, ops/children.py) -> (olo, ohi (8, P) int32 ranks at lo and hi,
    freq (P,) int32 (hi - lo, 0 for an empty interval), keepc (4, P) bool
    (the child lanes with at least `fmin` occurrences of a non-empty
    interval and allowed by the bits of `sym_mask`), cbits (P,) uint8 (the
    active child lanes as bits, whatever `sym_mask` says)).  CPU tensors
    take the plain version; CUDA tensors launch the kernel, one launch,
    which wants `pairs` contiguous and 16-byte aligned."""
    if frows.device.type == "cpu":
        return expand_plain(frows, pairs, fmin, sym_mask)
    _check_rows(frows, "expand")
    if (pairs.dtype != torch.int32 or pairs.dim() != 2
            or pairs.shape[1] != PAIR_COLS or not pairs.is_contiguous()
            or pairs.device != frows.device or pairs.data_ptr() % 16):
        raise ValueError(f"expand: pairs must be contiguous, 16-byte aligned "
                         f"(P, {PAIR_COLS}) int32 on {frows.device}")
    p, device = pairs.shape[0], frows.device
    olo = torch.empty((8, p), dtype=torch.int32, device=device)
    ohi = torch.empty_like(olo)
    freq = torch.empty(p, dtype=torch.int32, device=device)
    keepc = torch.empty((4, p), dtype=torch.bool, device=device)
    cbits = torch.empty(p, dtype=torch.uint8, device=device)
    if p:
        _build.launch("dsm_expand", "rank", device, frows.data_ptr(),
                      pairs.data_ptr(), olo.data_ptr(), ohi.data_ptr(),
                      freq.data_ptr(), keepc.data_ptr(), cbits.data_ptr(), p,
                      int(fmin), int(sym_mask))
    return olo, ohi, freq, keepc, cbits


def _table_of_pair(bases, sid: torch.Tensor) -> torch.Tensor:
    """The table of each sample id: the last whose base is at or below it."""
    b = torch.tensor([int(x) for x in bases], dtype=torch.int32,
                     device=sid.device)
    return torch.searchsorted(b, sid.contiguous(), right=True) - 1


def expand_tables_plain(tables, pairs: torch.Tensor, fmin: int,
                        sym_mask: int):
    """Plain PyTorch version of the multi-table expand step (any device):
    `expand_plain` on each table's pairs, under a mask."""
    p, device = pairs.shape[0], pairs.device
    olo = torch.empty((8, p), dtype=torch.int32, device=device)
    ohi = torch.empty_like(olo)
    freq = torch.empty(p, dtype=torch.int32, device=device)
    keepc = torch.empty((4, p), dtype=torch.bool, device=device)
    cbits = torch.empty(p, dtype=torch.uint8, device=device)
    table = _table_of_pair([b for _r, b in tables], pairs[:, PC_SID])
    for k, (frows, _base) in enumerate(tables):
        mine = table == k
        lo, hi, f, kc, cb = expand_plain(frows, pairs[mine], fmin, sym_mask)
        olo[:, mine], ohi[:, mine], freq[mine] = lo, hi, f
        keepc[:, mine], cbits[mine] = kc, cb
    return olo, ohi, freq, keepc, cbits


def expand_tables(tables, pairs: torch.Tensor, fmin: int, sym_mask: int):
    """The expand step over the tables of a process's shards -> the
    outputs of `expand`.  tables: 1 to MAX_TABLES (frows, base), a shard's
    forward table and the process-local id of its first sample, the bases
    ascending; pairs: (P, 6) int32 rows whose PC_SID is a process-local
    sample id at or above the first base and whose PC_SOFF is the sample's
    row offset in its own table.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, one launch, which wants `pairs` contiguous
    and 16-byte aligned."""
    if pairs.device.type == "cpu":
        return expand_tables_plain(tables, pairs, fmin, sym_mask)
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"expand_tables: takes 1 to {MAX_TABLES} tables "
                         f"(got {len(tables)})")
    device = pairs.device
    entries = []
    for frows, base in tables:
        _check_rows(frows, "expand_tables")
        if frows.device != device:
            raise ValueError(f"expand_tables: a table is not on {device}")
        if entries and int(base) < entries[-1]:
            raise ValueError("expand_tables: the tables' bases must ascend")
        entries += (frows.data_ptr(), int(base))
    if (pairs.dtype != torch.int32 or pairs.dim() != 2
            or pairs.shape[1] != PAIR_COLS or not pairs.is_contiguous()
            or pairs.data_ptr() % 16):
        raise ValueError(f"expand_tables: pairs must be contiguous, 16-byte "
                         f"aligned (P, {PAIR_COLS}) int32 on {device}")
    p = pairs.shape[0]
    olo = torch.empty((8, p), dtype=torch.int32, device=device)
    ohi = torch.empty_like(olo)
    freq = torch.empty(p, dtype=torch.int32, device=device)
    keepc = torch.empty((4, p), dtype=torch.bool, device=device)
    cbits = torch.empty(p, dtype=torch.uint8, device=device)
    if p:
        table = array.array("q", entries)
        _build.launch("dsm_expand_tables", "rank", device,
                      table.buffer_info()[0], len(tables), pairs.data_ptr(),
                      olo.data_ptr(), ohi.data_ptr(), freq.data_ptr(),
                      keepc.data_ptr(), cbits.data_ptr(), p, int(fmin),
                      int(sym_mask))
    return olo, ohi, freq, keepc, cbits
