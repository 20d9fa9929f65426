"""The gather of a sharded drain (kernel K10, csrc/gatherpack.cu).

Counterpart of dsm_tpu/parallel/engine_episode.py `_jitted_gather_counts`,
`_jitted_gather_rows` and `_jitted_lc_sharded`'s gather (:205-267) with
the host loops that cut every shard's padded slice to its count and made
its local sample ids global (:350-364, :443-447).

`gather_pack(blocks, bases, sid_col, lcs=None)`: blocks, a list of (m_k, C)
int32 row blocks on one device (the shards' staged output rows or live pair
rows; m_k may be 0); bases, each block's first global sample id; lcs, each
block's (m_k,) int8 leftChar codes, or None.  -> (rows (sum m_k, C) int32
in block order with column `sid_col` + the block's base, lc (sum m_k,)
int8 or None).

The kernel takes its block table in the launch's parameters: one launch
for up to MAX_BLOCKS non-empty blocks (a drain hands it one, the
process's staged rows; an all-gather one a process), one a group of
MAX_BLOCKS above that; empty blocks are left out of the table.  The
blocks' rows need only their dtype's 4-byte alignment and the codes none.
"""

from __future__ import annotations

import array

import torch

from . import _build
from .limits import MAX_GATHER_COLS, refuse_past

MAX_BLOCKS = 128   # csrc/gatherpack.cu kMaxBlocks: the blocks of one launch


def gather_pack_plain(blocks, bases, sid_col: int, lcs=None):
    """Plain PyTorch version of the gather kernel (any device)."""
    rows = torch.cat(list(blocks))
    add = torch.cat([torch.full((b.shape[0],), base, dtype=torch.int32,
                                device=b.device)
                     for b, base in zip(blocks, bases)])
    rows[:, sid_col] += add
    return rows, None if lcs is None else torch.cat(list(lcs))


def gather_pack(blocks, bases, sid_col: int, lcs=None):
    """See the module's docstring.  At least one block.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    device = blocks[0].device
    refuse_past("gather_pack", "columns", blocks[0].shape[1],
                MAX_GATHER_COLS, "a tile's words counted in an int")
    if device.type == "cpu":
        return gather_pack_plain(blocks, bases, sid_col, lcs)
    if device.type != "cuda":
        raise ValueError(f"gather_pack: unsupported device {device}")
    C = blocks[0].shape[1]
    if len(bases) != len(blocks) or (lcs is not None
                                     and len(lcs) != len(blocks)):
        raise ValueError("gather_pack: one base (and one code vector) a "
                         "block")
    if not 0 <= sid_col < C:
        raise ValueError(f"gather_pack: no column {sid_col} in {C}")
    # the launch's block table: (rows, codes, first output row, m, base) a
    # non-empty block, as one flat int64 array (the Python loop over the
    # blocks is what this wrapper costs on the host)
    table, n_tot, i32, i8 = [], 0, torch.int32, torch.int8
    for k, b in enumerate(blocks):
        shape = b.shape
        if (len(shape) != 2 or shape[1] != C or b.dtype is not i32
                or not b.is_contiguous() or b.device != device):
            raise ValueError(f"gather_pack: block {k} must be contiguous "
                             f"(m, {C}) int32 on {device}")
        m = shape[0]
        lc_ptr = 0
        if lcs is not None:
            lc = lcs[k]
            if (lc.dtype is not i8 or lc.shape != shape[:1]
                    or not lc.is_contiguous() or lc.device != device):
                raise ValueError(f"gather_pack: codes {k} must be contiguous "
                                 f"({m},) int8 on {device}")
            lc_ptr = lc.data_ptr()
        if m:
            table += (b.data_ptr(), lc_ptr, n_tot, m, int(bases[k]))
        n_tot += m
    rows = torch.empty((n_tot, C), dtype=torch.int32, device=device)
    lc_out = None if lcs is None else torch.empty(n_tot, dtype=torch.int8,
                                                  device=device)
    table = array.array("q", table)
    address = table.buffer_info()[0]
    nblk = len(table) // 5
    for g in range(0, nblk, MAX_BLOCKS):
        _build.launch("dsm_gather_pack", "gather_pack", device,
                      address + 40 * g, min(MAX_BLOCKS, nblk - g), C, sid_col,
                      rows.data_ptr(),
                      0 if lc_out is None else lc_out.data_ptr())
    return rows, lc_out
