"""Order-preserving masked row compaction (kernel P1, csrc/compact.cu),
and the emit step of a trie level that runs on it (K4).

`compact_rows` is the counterpart of dsm_tpu/ops/pallas_compact.py
`compact_rows`, with the semantics of dsm_tpu/ops/compact.py
`compact_kidx_sort` followed by a row take: the rows of `values` (N, C)
whose mask is set move, in order, to the front of a (width, C) output.
Any N is accepted.  Rows past the live count are zero, rows past `width`
are dropped.  The count (of set mask entries, whatever `width` is) comes
back as a 0-dim int64 tensor on the values' device (reading it
synchronises; the episode already knows it from its per-level count
readback).

`stage_rows` is the emit block of dsm_tpu/mining/engine_device.py
`_level_single` (`build_stage`: orows, `compact_kidx_sort`, take): the
(hi - lo, rlo, sid, nid, depth) rows of the marked pairs, in order.  On
the card it is a second entry of the same one-pass kernel that makes each
row from its pair row as it copies it, so no (P, 5) matrix is built.

`compact_kidx` (kernel K14) is dsm_tpu/ops/compact.py `compact_kidx` and
`compact_kidx_sort` (:33, :88), two implementations of one function there
(a select over packed words, and a sort): the indices of a mask's set
entries, in order, in front of a (width,) int32 output, and the count.
Here both names are the third entry of the same kernel, and
`compact_kidx_np` is the port's copy of the NumPy oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .limits import MAX_COMPACT_COLS, MAX_COMPACT_ROWS, refuse_past

TILE_ROWS = 4096   # csrc/compact.cu kTile
# pair-row columns (ops/children.py PC_*) the emit rows are made of
_PC_LO, _PC_HI, _PC_RLO, _PC_SID, _PC_NID = 0, 1, 2, 3, 5
STAGE_COLS = 5


def compact_rows_plain(mask: torch.Tensor, values: torch.Tensor,
                       width: int):
    """Plain PyTorch version of the compaction kernel (any device)."""
    idx = torch.nonzero(mask, as_tuple=True)[0][:width]
    out = torch.zeros((width, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out[:idx.shape[0]] = values[idx]
    return out, mask.sum(dtype=torch.int64)


def stage_rows_plain(pair_out: torch.Tensor, pairs: torch.Tensor,
                     depth: int, width: int, out: torch.Tensor | None = None):
    """Plain PyTorch version of the emit entry (any device): the (P, 5)
    rows stacked, then compacted (into `out` where it is given)."""
    orows = torch.stack(
        [pairs[:, _PC_HI] - pairs[:, _PC_LO], pairs[:, _PC_RLO],
         pairs[:, _PC_SID], pairs[:, _PC_NID],
         torch.full((pairs.shape[0],), depth, dtype=torch.int32,
                    device=pairs.device)], dim=1)
    rows, count = compact_rows_plain(pair_out, orows, width)
    if out is None:
        return rows, count
    out.copy_(rows)
    return out, count


def _refuse(name: str, rows: torch.Tensor) -> None:
    """The sizes the kernel's 32-bit counts hold (ops/limits.py)."""
    refuse_past(name, "rows", rows.shape[0], MAX_COMPACT_ROWS,
                "32-bit look-back totals")
    if rows.dim() == 2:
        refuse_past(name, "columns", rows.shape[1], MAX_COMPACT_COLS,
                    "a tile's words counted in an int")


def _check(name: str, mask: torch.Tensor, rows: torch.Tensor) -> None:
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rows.device}")
    if (rows.dtype != torch.int32 or rows.dim() != 2
            or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be contiguous (N, C) int32")
    if (mask.dtype != torch.bool or mask.shape != (rows.shape[0],)
            or not mask.is_contiguous() or mask.device != rows.device):
        raise ValueError(f"{name}: mask must be contiguous (N,) bool on the "
                         f"rows' device")


def _launch(entry: str, mask: torch.Tensor, rows: torch.Tensor, arg: int,
            cols: int, width: int, out: torch.Tensor | None = None):
    """One launch of the compaction kernel through `entry`; `arg` is the
    entry's own scalar (the row width, or the depth).  The mask may start
    at any byte (a slice): the kernel then reads it byte by byte.  `out`,
    where it is given, is a contiguous (width, cols) int32 tensor on the
    rows' device at any 4-byte alignment (a run of rows of a larger
    buffer)."""
    device, n = rows.device, rows.shape[0]
    if out is None:
        out = torch.empty((width, cols), dtype=torch.int32, device=device)
    elif (out.dtype != torch.int32 or out.shape != (width, cols)
          or not out.is_contiguous() or out.device != device):
        raise ValueError(f"{entry}: out must be contiguous ({width}, {cols}) "
                         f"int32 on {device}")
    if n == 0:
        return (out.zero_(),
                torch.zeros((), dtype=torch.int64, device=device))
    count = torch.empty((), dtype=torch.int64, device=device)
    scratch = torch.empty(-(-n // TILE_ROWS) + 1, dtype=torch.int64,
                          device=device)
    _build.launch(entry, "compact", device, mask.data_ptr(), rows.data_ptr(),
                  n, arg, out.data_ptr(), width, scratch.data_ptr(),
                  count.data_ptr())
    return out, count


def compact_rows(mask: torch.Tensor, values: torch.Tensor, width: int):
    """-> (out (width, C) int32, count).  mask: (N,) bool; values:
    (N, C) int32 contiguous.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _refuse("compact_rows", values)
    if values.device.type == "cpu":
        return compact_rows_plain(mask, values, width)
    _check("compact_rows", mask, values)
    return _launch("dsm_compact_rows", mask, values, values.shape[1],
                   values.shape[1], width)


def stage_rows(pair_out: torch.Tensor, pairs: torch.Tensor, depth: int,
               width: int, out: torch.Tensor | None = None):
    """-> (out (width, 5) int32, count): the (hi - lo, rlo, sid, nid,
    depth) rows of the pairs that `pair_out` marks, in order.  pair_out:
    (P,) bool; pairs: (P, 6) int32 contiguous pair rows; out: where the
    rows go (a contiguous (width, 5) int32 run of rows of a staging
    buffer), or None for a new tensor.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _refuse("stage_rows", pairs)
    if pairs.device.type == "cpu":
        return stage_rows_plain(pair_out, pairs, depth, width, out)
    _check("stage_rows", pair_out, pairs)
    if pairs.shape[1] != 6:
        raise ValueError("stage_rows: pairs must be (P, 6) pair rows")
    return _launch("dsm_stage_rows", pair_out, pairs, depth, STAGE_COLS,
                   width, out)


def compact_kidx_np(mask: np.ndarray, width: int):
    """NumPy oracle for compact_kidx (exact on the first `count` slots)."""
    idx = np.flatnonzero(mask)
    out = np.zeros(width, dtype=np.int32)
    k = min(len(idx), width)
    out[:k] = idx[:k]
    return out, len(idx)


def compact_kidx_plain(mask: torch.Tensor, width: int):
    """Plain PyTorch version of the index entry (any device)."""
    idx = torch.nonzero(mask, as_tuple=True)[0][:width]
    out = torch.zeros(width, dtype=torch.int32, device=mask.device)
    out[:idx.shape[0]] = idx.to(torch.int32)
    return out, mask.sum(dtype=torch.int64)


def compact_kidx(mask: torch.Tensor, width: int):
    """Indices of the set entries of `mask`, compacted to the front ->
    (kidx (width,) int32, count): kidx[j] is the index of the j-th set
    entry for j < count, and 0 past it (dsm_tpu leaves in-range garbage
    there); count is the number of set entries, whatever width is, a 0-dim
    int64 tensor on the mask's device.  mask: (N,) bool contiguous, any N
    (dsm_tpu's select form wants a multiple of 32); width <= N.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    n = mask.shape[0]
    if not 0 <= width <= n:
        raise ValueError(f"compact_kidx: width {width} is not in [0, {n}]")
    refuse_past("compact_kidx", "rows", n, MAX_COMPACT_ROWS,
                "32-bit look-back totals")
    if mask.device.type == "cpu":
        return compact_kidx_plain(mask, width)
    if mask.device.type != "cuda":
        raise ValueError(f"compact_kidx: unsupported device {mask.device}")
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("compact_kidx: mask must be contiguous (N,) bool")
    device = mask.device
    out = torch.empty(width, dtype=torch.int32, device=device)
    if n == 0:
        return out, torch.zeros((), dtype=torch.int64, device=device)
    count = torch.empty((), dtype=torch.int64, device=device)
    scratch = torch.empty(-(-n // TILE_ROWS) + 1, dtype=torch.int64,
                          device=device)
    _build.launch("dsm_compact_kidx", "compact_kidx", device, mask.data_ptr(),
                  n, out.data_ptr(), width, scratch.data_ptr(),
                  count.data_ptr())
    return out, count


def compact_kidx_sort(mask: torch.Tensor, width: int):
    """dsm_tpu's sort form of compact_kidx: the same function, here the
    same kernel."""
    return compact_kidx(mask, width)
