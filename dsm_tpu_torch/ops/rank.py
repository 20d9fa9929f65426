"""Fused rank over the baked-C4 occ tables (kernel 1, csrc/rank.cu).

Counterpart of dsm_tpu/ops/rank.py `occ_cumT` / `occ_cum8T`.  The table
is the ROW-major (R, ROWW) fused table of `dsm_tpu.ops.rank.fused_rows`
(stored as int32 bit patterns: torch has no general uint32 arithmetic);
the TPU's transposed (32, R) layout is not carried over.

`occ_cum8(rows, pos, soff)` -> (8, Q) int32 with rows
[C4A+occA, C4C+occC, C4G+occG, pos-c5(+C4T), c1, c2, c3, c5] at the text
positions `pos` of the samples whose table rows start at `soff`: rows 0:4
are the four child interval bounds, rows 4:8 the lexicographic prefix
sums.  The JAX form takes (blk, rem, pos) with blk = (pos >> 7) + soff and
rem = pos & 127; the kernel derives both itself.
"""

from __future__ import annotations

import torch

from dsm_tpu.ops.rank import BLOCK, LOG2_BLOCK, ROWW

from . import _build

_NPLANES = 5


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
