"""The stats step of a trie level: per-node segment statistics, output
gates and the level's sums (kernel K2, csrc/segstats.cu).

Counterpart of the stats block of dsm_tpu/mining/engine_device.py
`_level_single` (segment broadcasts over cumsum/cummax/cummin, the int32
fixed-point entropy windows `_nln_windows_w`, and the level's
total_paths, ent_min/ent_max, child_total and pair_count).  A node's
pairs are contiguous, [nb[n], nb[n+1]), so the statistics are one
segmented reduction, taken here in int64 and float64.

`segstats(nb, freq, cact, gates)` -> (flags (U,) int32, ent (U,) float64,
pair_out (P,) bool, sums (6,) float64):
  * flags bit 0: present (the node counts in total_paths), bit 1: its
    entropy counts for the min/max diagnostics, bit 2: gated for output,
    bits 4-7: the child symbols that exist (A, C, G, T);
  * ent: the node's entropy, (f+1)log(f+1)/log(2) summed in ascending
    pair order, as engine_np.node_entropy (the kernel sums a node of more
    than 64 pairs by a warp, in another fixed order: within ENT_TOL);
  * pair_out: bit 2 of the pair's node, per pair;
  * sums, indexed by the S_* constants: the kept lanes (child symbols of
    `cact` allowed by sym_mask, over pairs), the children (existing child
    symbols, over nodes), the pairs of gated nodes, the present nodes, and
    the least and largest entropy of the nodes with bit 1 (+inf and -inf
    where there is none).  The counts are exact in float64, so a level
    reads all six back at once.
The entropy gate keeps the TPU's margin (ENT_MARGIN): it is a prefilter,
and the host drain re-gates in f64 with the reference's expressions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .limits import MAX_PAIRS, refuse_past

LOG2 = float(np.log(2.0))
F_PRESENT, F_STAT, F_GATED = 1, 2, 4
EXISTS_SHIFT = 4
# the entries of `sums`
S_KEPT, S_CHILDREN, S_GATED, S_PRESENT, S_ENT_MIN, S_ENT_MAX = range(6)
# the kernel's running state (a ticket and the level's sums), 7 uint64 a
# (device, stream), made zero once: the last block of a launch zeroes it
# for the next launch on that stream, which spares a memset (a device
# activity) a level; launches on two streams never share one
_STATES: dict = {}


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
    pair_out = gated[node]
    inf = torch.full((1,), np.inf, dtype=torch.float64, device=dev)
    allowed = ((g.sym_mask >> sym) & 1)[None, :]
    sums = torch.stack([
        (bits & allowed).sum().to(torch.float64),
        ex.sum().to(torch.float64),
        pair_out.sum().to(torch.float64),
        present.sum().to(torch.float64),
        torch.cat([torch.where(stat, ent, np.inf), inf]).min(),
        torch.cat([torch.where(stat, ent, -np.inf), -inf]).max()])
    return flags.to(torch.int32), ent, pair_out, sums


def segstats(nb: torch.Tensor, freq: torch.Tensor, cact: torch.Tensor,
             g: Gates):
    """nb: (U+1,) int32 node -> first pair (nb[U] = P); freq: (P,) int32,
    0 for inactive pairs; cact: (P,) uint8, bit c set if child symbol c is
    active for the pair.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, once."""
    refuse_past("segstats", "pairs", freq.shape[0], MAX_PAIRS,
                "int32 pair positions")
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
    U, P, device = nb.shape[0] - 1, freq.shape[0], freq.device
    if U <= 0:
        if P:
            raise ValueError("segstats: pairs without a node")
        empty = torch.empty(0, device=device)
        return (empty.to(torch.int32), empty.to(torch.float64),
                empty.to(torch.bool),
                torch.tensor([0, 0, 0, 0, np.inf, -np.inf],
                             dtype=torch.float64, device=device))
    flags = torch.empty(U, dtype=torch.int32, device=device)
    ent = torch.empty(U, dtype=torch.float64, device=device)
    pair_out = torch.empty(P, dtype=torch.bool, device=device)
    sums = torch.empty(6, dtype=torch.float64, device=device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(device).cuda_stream)
    state = _STATES.get(key)
    if state is None:
        state = _STATES[key] = torch.zeros(7, dtype=torch.int64,
                                           device=device)
    _build.launch("dsm_segstats", "segstats", device, nb.data_ptr(),
                  freq.data_ptr(), cact.data_ptr(), U, P, g.depth, g.s_total,
                  g.mindepth, g.pmin, g.pmax, int(g.use_egate),
                  g.sym_mask, g.emin_lo, g.emax_hi, flags.data_ptr(),
                  ent.data_ptr(), pair_out.data_ptr(), state.data_ptr(),
                  sums.data_ptr())
    return flags, ent, pair_out, sums
