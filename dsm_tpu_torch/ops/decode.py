"""Ancestor-walk path decode (kernel K6, csrc/decode.cu).

Counterpart of dsm_tpu/mining/engine_device.py `_jitted_decode`: each
requested node row walks the device-resident parent-pointer history of
the current segment (one int32 per node, parent_row*4 + symbol; level k
of the segment starts at lvl_off[k]) down to the segment base.

`decode(hist, lvl_off, rows, jrel, maxj)` -> (base (m,) int32, syms
(m, maxj) uint8): row i starts at relative level jrel[i] (its depth minus
the segment's base depth, 0 <= jrel[i] <= maxj); base[i] is its ancestor
at the segment base and syms[i, :jrel[i]] the symbol codes (0..3, indexes
of EXT_CHARS) of the levels it walked, zero past jrel[i].  The TPU form's
DECODE_K row chunks and 128-column padding are not carried over.
"""

from __future__ import annotations

import torch

from . import _build
from .limits import INT32_MAX, MAX_DECODE_LEVELS, refuse_past


def decode_plain(hist: torch.Tensor, lvl_off: torch.Tensor,
                 rows: torch.Tensor, jrel: torch.Tensor, maxj: int):
    """Plain PyTorch version of the decode kernel (any device)."""
    m = rows.shape[0]
    r = rows.to(torch.int64)
    jt = jrel.to(torch.int64)
    off = lvl_off.to(torch.int64)
    syms = torch.zeros((m, maxj), dtype=torch.uint8, device=rows.device)
    for lev in range(maxj, 0, -1):
        take = jt >= lev
        e = hist[torch.where(take, r + off[lev - 1], 0)]
        syms[:, lev - 1] = torch.where(take, e & 3, 0).to(torch.uint8)
        r = torch.where(take, (e >> 2).to(torch.int64), r)
    return r.to(torch.int32), syms


def decode(hist: torch.Tensor, lvl_off: torch.Tensor, rows: torch.Tensor,
           jrel: torch.Tensor, maxj: int):
    """hist: (H,) int32; lvl_off: (>= maxj,) int32; rows, jrel: (m,) int32,
    all contiguous on one device.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    refuse_past("decode", "levels", maxj, MAX_DECODE_LEVELS,
                "a tile's symbols counted in an int")
    refuse_past("decode", "history entries", hist.shape[0], INT32_MAX,
                "int32 level offsets")
    if rows.device.type == "cpu":
        return decode_plain(hist, lvl_off, rows, jrel, maxj)
    if rows.device.type != "cuda":
        raise ValueError(f"decode: unsupported device {rows.device}")
    for name, t in (("hist", hist), ("lvl_off", lvl_off), ("rows", rows),
                    ("jrel", jrel)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != rows.device):
            raise ValueError(f"decode: {name} must be contiguous 1-D int32 "
                             f"on {rows.device}")
    m = rows.shape[0]
    if jrel.shape[0] != m or lvl_off.shape[0] < maxj:
        raise ValueError("decode: rows and jrel differ in length, or "
                         "lvl_off has fewer than maxj levels")
    base = torch.empty(m, dtype=torch.int32, device=rows.device)
    syms = torch.empty((m, maxj), dtype=torch.uint8, device=rows.device)
    if m == 0:
        return base, syms
    _build.launch("dsm_decode", "decode", rows.device, hist.data_ptr(),
                  lvl_off.data_ptr(), rows.data_ptr(), jrel.data_ptr(), m,
                  maxj, base.data_ptr(), syms.data_ptr())
    return base, syms
