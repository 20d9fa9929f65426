"""Per-node statistics and gates of a sample-sharded trie level (kernels
K9a and K9b, csrc/shardstats.cu).

Counterpart of the stats, merge and numbering blocks of
dsm_tpu/mining/engine_device.py `_level_sharded` (:421-489).  A shard
holds only its samples' pairs, so a node's statistics are summed over the
shards before anything is derived from them:

`shard_partials(nb, freq, cbits)` -> (U, 3) int64, one partial row a node
from this shard's pairs [nb[u], nb[u+1]) (zeros where it has none):
  * [0] the sum of the active pairs' frequencies;
  * [1] the sum of trunc((f+1)*log2(f+1) * 2^NLN_FP): fixed point, so that
    the sum over shards and processes is the same integer in any order (a
    term is under 2^53, and MAX_SAMPLES = 512 of them fit an int64);
  * [2] five FIELD_BITS-wide fields: the active readers, then the pairs
    with an active child under A, C, G, T (a node owns at most 512 pairs
    over all shards, so summed fields do not carry).

`node_gates(parts, gates, hist)`: parts (n, U, 3) int64, the n rows of a
node added here (the shards of this process; where there are several
processes `torch.distributed.all_reduce` has summed them before).  ->
(flags (U,) int32, ent (U,) float64, kid0 (U,) int32, counts (2,) int64):
  * flags: as ops/segstats (bit 0 present, bit 1 stat, bit 2 gated, bits
    4-7 the existing child symbols), with the GLOBAL sample count as
    `gates.s_total`, and the node's active readers from bit NACT_SHIFT up;
  * ent: log2(s_total + sum f) - sum (f+1)log2(f+1) / (s_total + sum f)
    from the fixed-point sum: within 2^-NLN_FP a pair of segstats', inside
    ENT_MARGIN of the gate (the drain re-gates in exact f64);
  * kid0: the node's first child id; children are numbered in (node,
    symbol) order over the existing ones;
  * hist[:children] gets the history entries node*4 + symbol in child
    order (entries past len(hist) are dropped: the level is then redone
    after the history is pulled);
  * counts: the number of children, the number of present nodes.
"""

from __future__ import annotations

import torch

from . import _build
from .segstats import (EXISTS_SHIFT, F_GATED, F_PRESENT, F_STAT, LOG2,
                       Gates)

NLN_FP = 17        # csrc/shardstats.cu kNlnFp
FIELD_BITS = 12    # kFieldBits
PART_COLS = 3
NACT_SHIFT = 8     # flags: the active readers from this bit up
FLAG_BITS = (1 << NACT_SHIFT) - 1   # the bits ops/segstats also writes
THREADS = 256      # csrc/scan.cuh kScanThreads: nodes per block


def _node_of_pair(nb: torch.Tensor, P: int) -> torch.Tensor:
    U = nb.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(U, device=nb.device), (nb[1:] - nb[:-1]).to(torch.int64),
        output_size=P)


def shard_partials_plain(nb: torch.Tensor, freq: torch.Tensor,
                         cbits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the partials kernel (any device)."""
    dev = freq.device
    U = nb.shape[0] - 1
    node = _node_of_pair(nb, freq.shape[0])
    pa = freq > 0
    f1 = freq.to(torch.float64) + 1.0
    term = (((f1 * torch.log(f1)) / LOG2) * float(1 << NLN_FP)).to(
        torch.int64)
    sym = torch.arange(4, device=dev)
    fields = pa.to(torch.int64) + (
        ((cbits.to(torch.int64)[:, None] >> sym) & 1)
        << (FIELD_BITS * (sym + 1))).sum(1)
    cols = torch.stack([torch.where(pa, freq, 0).to(torch.int64),
                        torch.where(pa, term, 0), fields], dim=1)
    return torch.zeros((U, PART_COLS), dtype=torch.int64,
                       device=dev).index_add_(0, node, cols)


def shard_partials(nb: torch.Tensor, freq: torch.Tensor,
                   cbits: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Write this shard's partial rows into `out` ((U, 3) int64, e.g. one
    slice of the (n, U, 3) tensor node_gates reads) and return it.  nb:
    (U+1,) int32; freq: (P,) int32, 0 for inactive pairs; cbits: (P,)
    uint8, bit c set if child symbol c is active for the pair.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    U = nb.shape[0] - 1
    if freq.device.type == "cpu":
        out.copy_(shard_partials_plain(nb, freq, cbits))
        return out
    if freq.device.type != "cuda":
        raise ValueError(f"shard_partials: unsupported device {freq.device}")
    for name, t, dt, shape in (
            ("nb", nb, torch.int32, (U + 1,)),
            ("freq", freq, torch.int32, freq.shape[:1]),
            ("cbits", cbits, torch.uint8, freq.shape[:1]),
            ("out", out, torch.int64, (U, PART_COLS))):
        if (t.dtype != dt or t.shape != shape or not t.is_contiguous()
                or t.device != freq.device):
            raise ValueError(f"shard_partials: {name} must be contiguous "
                             f"{dt} of shape {tuple(shape)} on {freq.device}")
    if U > 0:
        _build.launch("dsm_shard_partials", "shard_partials", freq.device,
                      nb.data_ptr(), freq.data_ptr(), cbits.data_ptr(), U,
                      out.data_ptr())
    return out


def node_gates_plain(parts: torch.Tensor, g: Gates, hist: torch.Tensor):
    """Plain PyTorch version of the gates kernel (any device)."""
    dev = parts.device
    tot = parts.sum(dim=0)                                   # (U, 3)
    sumf, nln, fields = tot[:, 0], tot[:, 1], tot[:, 2]
    mask = (1 << FIELD_BITS) - 1
    nact = fields & mask
    sym = torch.arange(4, device=dev)
    cnt4 = (fields[:, None] >> (FIELD_BITS * (sym + 1))) & mask   # (U, 4)
    ex = (cnt4 > 0) & (((g.sym_mask >> sym) & 1) > 0)[None, :]
    single_full = (ex.sum(1) == 1) & ((cnt4 * ex).sum(1) == nact)
    sum_n = (g.s_total + sumf).to(torch.float64)
    sumnln = nln.to(torch.float64) / float(1 << NLN_FP)
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
             | gated.to(torch.int64) * F_GATED | (exbits << EXISTS_SHIFT)
             | (nact << NACT_SHIFT))
    nchild = ex.sum(1)
    kid0 = torch.cumsum(nchild, 0) - nchild
    # the flat index of an existing (node, symbol) IS its entry node*4+symbol
    entries = torch.nonzero(ex.reshape(-1), as_tuple=True)[0]
    room = min(entries.shape[0], hist.shape[0])
    hist[:room] = entries[:room].to(torch.int32)
    counts = torch.stack([nchild.sum(), present.sum()]).to(torch.int64)
    return flags.to(torch.int32), ent, kid0.to(torch.int32), counts


def node_gates(parts: torch.Tensor, g: Gates, hist: torch.Tensor):
    """parts: (n, U, 3) int64 contiguous partial rows; hist: 1-D int32, the
    free tail of the history buffer.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if parts.device.type == "cpu":
        return node_gates_plain(parts, g, hist)
    device = parts.device
    if device.type != "cuda":
        raise ValueError(f"node_gates: unsupported device {device}")
    if (parts.dtype != torch.int64 or parts.dim() != 3
            or parts.shape[0] < 1 or parts.shape[2] != PART_COLS
            or not parts.is_contiguous()):
        raise ValueError("node_gates: parts must be contiguous (n, U, 3) "
                         "int64 with n >= 1")
    if (hist.dtype != torch.int32 or hist.dim() != 1
            or not hist.is_contiguous() or hist.device != device):
        raise ValueError(f"node_gates: hist must be contiguous 1-D int32 on "
                         f"{device}")
    n, U, _ = parts.shape
    flags = torch.empty(U, dtype=torch.int32, device=device)
    ent = torch.empty(U, dtype=torch.float64, device=device)
    kid0 = torch.empty(U, dtype=torch.int32, device=device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    if U <= 0:
        return flags, ent, kid0, counts
    scratch = torch.empty(2 * -(-U // THREADS), dtype=torch.int64,
                          device=device)
    _build.launch("dsm_node_gates", "node_gates", device, parts.data_ptr(),
                  n, U, g.depth, g.s_total, g.mindepth, g.pmin, g.pmax,
                  int(g.use_egate), g.sym_mask, g.emin_lo, g.emax_hi,
                  flags.data_ptr(), ent.data_ptr(), kid0.data_ptr(),
                  scratch.data_ptr(), hist.data_ptr(), hist.shape[0],
                  counts.data_ptr())
    return flags, ent, kid0, counts
