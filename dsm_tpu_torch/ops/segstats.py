"""Per-node segment statistics and output gates (kernel 3,
csrc/segstats.cu).

Counterpart of the stats block of dsm_tpu/mining/engine_device.py
`_level_single` (segment broadcasts over cumsum/cummax/cummin and the
int32 fixed-point entropy windows `_nln_windows_w`).  A node's pairs are
contiguous, [nb[n], nb[n+1]), so the statistics are one segmented
reduction, taken here in int64 and float64.

`segstats(nb, freq, cact, gates)` -> (flags (U,) int32, ent (U,) float64,
pair_out (P,) bool):
  * flags bit 0: present (the node counts in total_paths), bit 1: its
    entropy counts for the min/max diagnostics, bit 2: gated for output,
    bits 4-7: the child symbols that exist (A, C, G, T);
  * ent: the node's entropy, (f+1)log(f+1)/log(2) summed in ascending
    pair order, as engine_np.node_entropy;
  * pair_out: bit 2 of the pair's node, per pair.
The entropy gate keeps the TPU's margin (ENT_MARGIN): it is a prefilter,
and the host drain re-gates in f64 with the reference's expressions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build

LOG2 = float(np.log(2.0))
F_PRESENT, F_STAT, F_GATED = 1, 2, 4
EXISTS_SHIFT = 4


class Gates(NamedTuple):
    """The level's gate parameters (metaserver.cpp:403-417)."""

    depth: int
    s_total: int
    mindepth: int
    pmin: int
    pmax: int
    use_egate: bool
    sym_mask: int      # bit c: child symbol c may be expanded
    emin_lo: float     # emin - ENT_MARGIN
    emax_hi: float     # emax + ENT_MARGIN


def segstats_plain(nb: torch.Tensor, freq: torch.Tensor, cact: torch.Tensor,
                   g: Gates):
    """Plain PyTorch version of the segstats kernel (any device)."""
    dev = freq.device
    U = nb.shape[0] - 1
    P = freq.shape[0]
    node = torch.repeat_interleave(
        torch.arange(U, device=dev), (nb[1:] - nb[:-1]).to(torch.int64),
        output_size=P)
    pa = freq > 0
    nact = torch.zeros(U, dtype=torch.int64, device=dev).index_add_(
        0, node, pa.to(torch.int64))
    sumf = torch.zeros(U, dtype=torch.int64, device=dev).index_add_(
        0, node, torch.where(pa, freq, 0).to(torch.int64))
    f1 = freq.to(torch.float64) + 1.0
    term = torch.where(pa, (f1 * torch.log(f1)) / LOG2, 0.0)
    sumnln = torch.zeros(U, dtype=torch.float64, device=dev).index_add_(
        0, node, term)
    sym = torch.arange(4, device=dev)
    bits = (cact.to(torch.int64)[:, None] >> sym) & 1           # (P, 4)
    cnt4 = torch.zeros((U, 4), dtype=torch.int64, device=dev).index_add_(
        0, node, bits)
    ex = (cnt4 > 0) & (((g.sym_mask >> sym) & 1) > 0)[None, :]
    single_full = (ex.sum(1) == 1) & ((cnt4 * ex).sum(1) == nact)
    sum_n = (g.s_total + sumf).to(torch.float64)
    ent = torch.log(sum_n) / LOG2 - sumnln / sum_n
    present = (nact > 0) & (g.depth >= 1)
    egate = ((ent >= g.emin_lo) & (ent <= g.emax_hi)) if g.use_egate \
        else torch.ones_like(present)
    gated = (present & (g.depth >= g.mindepth) & (nact >= g.pmin)
             & ((g.pmax == 0) | (nact <= g.pmax)) & egate & ~single_full)
    stat = present & ~((nact == 1) & (g.pmin > 1))
    exbits = (ex.to(torch.int64) << sym).sum(1)
    flags = (present.to(torch.int64) * F_PRESENT
             | stat.to(torch.int64) * F_STAT
             | gated.to(torch.int64) * F_GATED | (exbits << EXISTS_SHIFT))
    return flags.to(torch.int32), ent, gated[node]


def segstats(nb: torch.Tensor, freq: torch.Tensor, cact: torch.Tensor,
             g: Gates):
    """nb: (U+1,) int32 node -> first pair (nb[U] = P); freq: (P,) int32,
    0 for inactive pairs; cact: (P,) uint8, bit c set if child symbol c is
    active for the pair.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if freq.device.type == "cpu":
        return segstats_plain(nb, freq, cact, g)
    if freq.device.type != "cuda":
        raise ValueError(f"segstats: unsupported device {freq.device}")
    for name, t, dt in (("nb", nb, torch.int32), ("freq", freq, torch.int32),
                        ("cact", cact, torch.uint8)):
        if (t.dtype != dt or t.dim() != 1 or not t.is_contiguous()
                or t.device != freq.device):
            raise ValueError(f"segstats: {name} must be contiguous 1-D {dt} "
                             f"on {freq.device}")
    if cact.shape != freq.shape:
        raise ValueError("segstats: freq and cact differ in length")
    U = nb.shape[0] - 1
    flags = torch.empty(U, dtype=torch.int32, device=freq.device)
    ent = torch.empty(U, dtype=torch.float64, device=freq.device)
    pair_out = torch.zeros(freq.shape[0], dtype=torch.bool,
                           device=freq.device)
    if U <= 0:
        return flags, ent, pair_out
    _build.launch("dsm_segstats", "segstats", freq.device, nb.data_ptr(),
                  freq.data_ptr(), cact.data_ptr(), U, g.depth, g.s_total,
                  g.mindepth, g.pmin, g.pmax, int(g.use_egate), g.sym_mask,
                  g.emin_lo, g.emax_hi, flags.data_ptr(), ent.data_ptr(),
                  pair_out.data_ptr())
    return flags, ent, pair_out
