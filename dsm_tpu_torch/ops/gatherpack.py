"""The gather of a sharded drain (kernel K10, csrc/gatherpack.cu).

Counterpart of dsm_tpu/parallel/engine_episode.py `_jitted_gather_counts`,
`_jitted_gather_rows` and `_jitted_lc_sharded`'s gather (:205-267) with
the host loops that cut every shard's padded slice to its count and made
its local sample ids global (:350-364, :443-447).

`gather_pack(blocks, bases, sid_col, lcs=None)`: blocks, a list of (m_k, C)
int32 row blocks on one device (a shard's staged output rows or live pair
rows; m_k may be 0); bases, each block's first global sample id; lcs, each
block's (m_k,) int8 leftChar codes, or None.  -> (rows (sum m_k, C) int32
in block order with column `sid_col` + the block's base, lc (sum m_k,)
int8 or None).
"""

from __future__ import annotations

import torch

from . import _build


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
    table, n_tot = [], 0
    for k, b in enumerate(blocks):
        if (b.dtype != torch.int32 or b.dim() != 2 or b.shape[1] != C
                or not b.is_contiguous() or b.device != device):
            raise ValueError(f"gather_pack: block {k} must be contiguous "
                             f"(m, {C}) int32 on {device}")
        lc_ptr = 0
        if lcs is not None:
            lc = lcs[k]
            if (lc.dtype != torch.int8 or lc.shape != b.shape[:1]
                    or not lc.is_contiguous() or lc.device != device):
                raise ValueError(f"gather_pack: codes {k} must be contiguous "
                                 f"({b.shape[0]},) int8 on {device}")
            lc_ptr = lc.data_ptr()
        table.append([b.data_ptr(), lc_ptr, n_tot, int(bases[k])])
        n_tot += b.shape[0]
    rows = torch.empty((n_tot, C), dtype=torch.int32, device=device)
    lc_out = None if lcs is None else torch.empty(n_tot, dtype=torch.int8,
                                                  device=device)
    if n_tot == 0:
        return rows, lc_out
    table_t = torch.tensor(table, dtype=torch.int64, device=device)
    _build.launch("dsm_gather_pack", "gather_pack", device,
                  table_t.data_ptr(), len(blocks), n_tot, C, sid_col,
                  rows.data_ptr(), 0 if lc_out is None else lc_out.data_ptr())
    return rows, lc_out
