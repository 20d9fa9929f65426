"""Per-node statistics and gates of a sample-sharded trie level (kernels
K9a and K9b, csrc/shardstats.cu).

Counterpart of the stats, merge and numbering blocks of
dsm_tpu/mining/engine_device.py `_level_sharded` (:421-489).  A process
holds only its shards' samples' pairs (in one list, whatever its shards),
so a node's statistics are summed over the processes before anything is
derived from them.  What a level reads back once, after both kernels, is
its values `vals` ((N_VALS,) float64, `level_values`; counts far below
2^53 are exact in float64): the children, the present nodes, the entropy
range, the staged rows after the emit, the process's kept lanes and its
gated pairs.

`shard_partials(nb, freq, cbits, sym_mask, out, kept)` writes `out`, (U, 3)
int64, one partial row a node from the process's pairs [nb[u], nb[u+1])
(zeros where it has none):
  * [0] the sum of the active pairs' frequencies;
  * [1] the sum of trunc((f+1)*log2(f+1) * 2^NLN_FP): fixed point, so that
    the sum over processes is the same integer in any order (a term is
    under 2^53, and MAX_SAMPLES = 512 of them fit an int64);
  * [2] five FIELD_BITS-wide fields: the active readers, then the pairs
    with an active child under A, C, G, T (a node owns at most 512 pairs
    over all processes, so summed fields do not carry);
and `kept` ((1,) float64, `vals[V_KEPT:V_KEPT + 1]`): the kept lanes,
popcount(cbits & sym_mask) over the pairs.

`node_gates(part, gates, hist, nb, P, ocount, vals)`: part (U, 3) int64,
the rows of a node (where there are several processes
`torch.distributed.all_reduce` has summed them before); nb, P: the
process's (U+1,) node starts and pair count; ocount: its rows staged
before this level.  -> (flags (U,) int32, ent (U,) float64, kid0 (U,)
int32, pair_out (P,) bool), and hist and vals written:
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
  * pair_out: the gate of each pair (its node's bit 2);
  * vals: the children, the present nodes, the least and largest entropy
    of the nodes with F_STAT (+inf and -inf where there is none), the
    gated pairs and the staged rows after the emit, ocount + gated pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .limits import MAX_NODES, MAX_PAIRS, refuse_past
from .segstats import (EXISTS_SHIFT, F_GATED, F_PRESENT, F_STAT, LOG2,
                       Gates)

NLN_FP = 17        # csrc/shardstats.cu kNlnFp
FIELD_BITS = 12    # kFieldBits
PART_COLS = 3
NACT_SHIFT = 8     # flags: the active readers from this bit up
FLAG_BITS = (1 << NACT_SHIFT) - 1   # the bits ops/segstats also writes
# the shards of a process: the level's expand (ops/rank.expand_tables) and
# the drain's leftChar carry their tables in one launch's parameters
MAX_SHARDS = 128
# the level's values (`vals`)
(V_CHILDREN, V_PRESENT, V_ENT_MIN, V_ENT_MAX, V_STAGED, V_KEPT,
 V_GATED) = range(7)
N_VALS = 7
# the kernels' running state, a (device, stream): 2 words of K9a, 7 of K9b
# (csrc/shardstats.cu), and K9b's look-back words, one a tile.
# Made zero; the last block of each launch zeroes what it used for the
# next launch on that stream, which spares a memset a launch; launches on
# two streams never share one
_STATE_WORDS = 2 + 7
_STATES: dict = {}


def level_values(device) -> torch.Tensor:
    """An uninitialised `vals` for a level."""
    return torch.empty(N_VALS, dtype=torch.float64, device=device)


def kept_slot(vals: torch.Tensor) -> torch.Tensor:
    """The kept-lanes slot of `vals`, the `kept` of shard_partials."""
    return vals[V_KEPT:V_KEPT + 1]


def _running_state(device, tiles: int):
    """(state, look-back words) of the current stream of `device`, with
    room for `tiles` look-back words."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(device).cuda_stream)
    state, status = _STATES.get(key, (None, None))
    if state is None:
        state = torch.zeros(_STATE_WORDS, dtype=torch.int64, device=device)
    if status is None or status.shape[0] < tiles:
        status = torch.zeros(1 << max(tiles - 1, 1).bit_length(),
                             dtype=torch.int64, device=device)
    _STATES[key] = state, status
    return state, status


def _node_of_pair(nb: torch.Tensor, P: int) -> torch.Tensor:
    U = nb.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(U, device=nb.device), (nb[1:] - nb[:-1]).to(torch.int64),
        output_size=P)


def shard_partials_plain(nb: torch.Tensor, freq: torch.Tensor,
                         cbits: torch.Tensor, sym_mask: int):
    """Plain PyTorch version of the partials kernel (any device) -> (the
    (U, 3) int64 rows, the kept lanes as a (1,) float64)."""
    dev = freq.device
    U = nb.shape[0] - 1
    node = _node_of_pair(nb, freq.shape[0])
    pa = freq > 0
    f1 = freq.to(torch.float64) + 1.0
    term = (((f1 * torch.log(f1)) / LOG2) * float(1 << NLN_FP)).to(
        torch.int64)
    sym = torch.arange(4, device=dev)
    bits = (cbits.to(torch.int64)[:, None] >> sym) & 1             # (P, 4)
    fields = pa.to(torch.int64) + (bits << (FIELD_BITS * (sym + 1))).sum(1)
    cols = torch.stack([torch.where(pa, freq, 0).to(torch.int64),
                        torch.where(pa, term, 0), fields], dim=1)
    part = torch.zeros((U, PART_COLS), dtype=torch.int64,
                       device=dev).index_add_(0, node, cols)
    kept = (bits & ((sym_mask >> sym) & 1)).sum().to(torch.float64)
    return part, kept.reshape(1)


def shard_partials(nb: torch.Tensor, freq: torch.Tensor,
                   cbits: torch.Tensor, sym_mask: int, out: torch.Tensor,
                   kept: torch.Tensor) -> torch.Tensor:
    """Write the process's partial rows into `out` ((U, 3) int64, what
    node_gates reads) and its kept lanes into `kept` ((1,) float64,
    `kept_slot` of the level's values); return `out`.
    nb: (U+1,) int32; freq: (P,) int32, 0 for inactive pairs; cbits: (P,)
    uint8, bit c set if child symbol c is active for the pair.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, once."""
    U, P = nb.shape[0] - 1, freq.shape[0]
    refuse_past("shard_partials", "pairs", P, MAX_PAIRS,
                "int32 pair positions")
    if freq.device.type == "cpu":
        part, k = shard_partials_plain(nb, freq, cbits, sym_mask)
        out.copy_(part)
        kept.copy_(k)
        return out
    device = freq.device
    if device.type != "cuda":
        raise ValueError(f"shard_partials: unsupported device {device}")
    for name, t, dt, shape in (
            ("nb", nb, torch.int32, (U + 1,)),
            ("freq", freq, torch.int32, (P,)),
            ("cbits", cbits, torch.uint8, (P,)),
            ("out", out, torch.int64, (U, PART_COLS)),
            ("kept", kept, torch.float64, (1,))):
        if (t.dtype != dt or t.shape != shape or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"shard_partials: {name} must be contiguous "
                             f"{dt} of shape {tuple(shape)} on {device}")
    if U <= 0:
        kept.zero_()
        return out
    state, _ = _running_state(device, 0)
    _build.launch("dsm_shard_partials", "shard_partials", device,
                  nb.data_ptr(), freq.data_ptr(), cbits.data_ptr(), U, P,
                  sym_mask, out.data_ptr(), state.data_ptr(), kept.data_ptr())
    return out


def node_gates_plain(part: torch.Tensor, g: Gates, hist: torch.Tensor,
                     nb: torch.Tensor, P: int, ocount: int,
                     vals: torch.Tensor):
    """Plain PyTorch version of the gates kernel (any device)."""
    dev = part.device
    sumf, nln, fields = part[:, 0], part[:, 1], part[:, 2]
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
    pair_out = gated[_node_of_pair(nb, P)]
    inf = torch.full((1,), np.inf, dtype=torch.float64, device=dev)
    vals[V_CHILDREN] = nchild.sum()
    vals[V_PRESENT] = present.sum()
    vals[V_ENT_MIN] = torch.cat([torch.where(stat, ent, np.inf), inf]).min()
    vals[V_ENT_MAX] = torch.cat([torch.where(stat, ent, -np.inf), -inf]).max()
    vals[V_GATED] = pair_out.sum()
    vals[V_STAGED] = vals[V_GATED] + ocount
    return flags.to(torch.int32), ent, kid0.to(torch.int32), pair_out


def node_gates(part: torch.Tensor, g: Gates, hist: torch.Tensor,
               nb: torch.Tensor, P: int, ocount: int, vals: torch.Tensor):
    """part: (U, 3) int64 contiguous partial rows; hist: 1-D int32, the
    free tail of the history buffer; nb: the process's (U+1,) int32 node
    starts; P: its pair count (nb[U]); ocount: its staged rows; vals: the
    level's values (its kept slot already written).  CPU tensors take the
    plain version; CUDA tensors launch the kernel, once."""
    refuse_past("node_gates", "nodes", part.shape[0], MAX_NODES,
                "int32 history entries parent * 4 + symbol")
    if part.device.type == "cpu":
        return node_gates_plain(part, g, hist, nb, P, ocount, vals)
    device = part.device
    if device.type != "cuda":
        raise ValueError(f"node_gates: unsupported device {device}")
    U = part.shape[0]
    for name, t, dt, shape in (
            ("part", part, torch.int64, (U, PART_COLS)),
            ("hist", hist, torch.int32, hist.shape[:1]),
            ("nb", nb, torch.int32, (U + 1,)),
            ("vals", vals, torch.float64, (N_VALS,))):
        if (t.dtype != dt or t.shape != shape or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"node_gates: {name} must be contiguous {dt} "
                             f"of shape {tuple(shape)} on {device}")
    flags = torch.empty(U, dtype=torch.int32, device=device)
    ent = torch.empty(U, dtype=torch.float64, device=device)
    kid0 = torch.empty(U, dtype=torch.int32, device=device)
    pair_out = torch.empty(P, dtype=torch.bool, device=device)
    if U <= 0:
        vals[:V_KEPT] = torch.tensor([0, 0, np.inf, -np.inf, ocount],
                                     dtype=torch.float64)
        vals[V_GATED] = 0
        return flags, ent, kid0, pair_out
    state, status = _running_state(
        device, _build.lib().dsm_node_gates_workspace(U))
    _build.launch("dsm_node_gates", "node_gates", device, part.data_ptr(),
                  U, g.depth, g.s_total, g.mindepth, g.pmin, g.pmax,
                  int(g.use_egate), g.sym_mask, g.emin_lo, g.emax_hi,
                  flags.data_ptr(), ent.data_ptr(), kid0.data_ptr(),
                  hist.data_ptr(), hist.shape[0], nb.data_ptr(),
                  pair_out.data_ptr(), int(ocount), state.data_ptr(),
                  status.data_ptr(), status.shape[0], vals.data_ptr())
    return flags, ent, kid0, pair_out
