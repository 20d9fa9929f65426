"""Order-preserving masked row compaction (kernel 2, csrc/compact.cu).

Counterpart of dsm_tpu/ops/pallas_compact.py `compact_rows`, with the
semantics of dsm_tpu/ops/compact.py `compact_kidx_sort` followed by a row
take: the rows of `values` (N, C) whose mask is set move, in order, to
the front of a (width, C) output.  Any N is accepted.  Rows past the
live count are zero.  The count comes back as a 0-dim int64 tensor on
the values' device (reading it synchronises; the episode already knows
it from its per-level count readback).
"""

from __future__ import annotations

import torch

from . import _build

ROWS_PER_BLOCK = 1024   # csrc/compact.cu kRows


def compact_rows_plain(mask: torch.Tensor, values: torch.Tensor,
                       width: int):
    """Plain PyTorch version of the compaction kernel (any device)."""
    idx = torch.nonzero(mask, as_tuple=True)[0][:width]
    out = torch.zeros((width, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out[:idx.shape[0]] = values[idx]
    return out, mask.sum(dtype=torch.int64)


def compact_rows(mask: torch.Tensor, values: torch.Tensor, width: int):
    """-> (out (width, C) int32, count).  mask: (N,) bool; values:
    (N, C) int32 contiguous.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if values.device.type == "cpu":
        return compact_rows_plain(mask, values, width)
    if values.device.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {values.device}")
    if (values.dtype != torch.int32 or values.dim() != 2
            or not values.is_contiguous()):
        raise ValueError("compact_rows: values must be contiguous (N, C) "
                         "int32")
    n, c = values.shape
    if (mask.dtype != torch.bool or mask.shape != (n,)
            or not mask.is_contiguous() or mask.device != values.device):
        raise ValueError("compact_rows: mask must be contiguous (N,) bool "
                         "on the values' device")
    out = torch.zeros((width, c), dtype=torch.int32, device=values.device)
    count = torch.zeros((), dtype=torch.int64, device=values.device)
    if n == 0:
        return out, count
    nblocks = -(-n // ROWS_PER_BLOCK)
    block_count = torch.empty(nblocks, dtype=torch.int32,
                              device=values.device)
    block_off = torch.empty(nblocks, dtype=torch.int64, device=values.device)
    _build.launch("dsm_compact_rows", "compact", values.device,
                  mask.data_ptr(), values.data_ptr(), n, c, out.data_ptr(),
                  width, block_count.data_ptr(), block_off.data_ptr(),
                  count.data_ptr())
    return out, count
