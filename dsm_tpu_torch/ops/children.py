"""The children step of a trie level (kernel K3, csrc/children.cu).

Counterpart of the children block of dsm_tpu/mining/engine_device.py
`_level_single` (the hv-keyed `lax.sort` of the kept (pair, symbol)
lanes, the boundary cumsum that numbers the children, and the second
sort that writes the history entries and the next node starts).

Pair rows are (P, 6) int32 with columns PC_* below, sorted by node with
each node's pairs contiguous, [nb[u], nb[u+1]).  Lane (c, p) of the
(4, P) `keep` mask says that pair p has a child interval under symbol c.
`children(...)` writes the kept lanes in (node, symbol, pair) order, the
JAX sort order:

  * newp (pair_count, 6): (olo[c], ohi[c], rlo + ohi[4+c] - olo[4+c],
    sid, soff, child id) per kept lane; child ids number the (node,
    symbol) groups in that order;
  * nb_next (child_total + 1,): each child's first row, then pair_count;
  * hist[:child_total]: each child's history entry node*4 + symbol.

The kernel finds a pair's node in its PC_NID column (nb[node] <= p <
nb[node + 1], as every level leaves it) and stops the launch with a fault
if a node holds more than 512 pairs (MAX_SAMPLES), the most a tile of its
shared memory is sized for.

pair_count and child_total are the level's counts (the number of kept
lanes and of (node, symbol) groups with one), which the level has already
read back to size the outputs.

`children_ids(...)` (kernel K9c) is the same step for one process's pair
list of a sample-sharded level (dsm_tpu/mining/engine_device.py
`_level_sharded`, :474-507).  A child exists when any process keeps a lane
of it, so the ids come from outside, from the level's global numbering
(ops/shardstats `node_gates`: the exists bits of `flags`, and `kid0`, each
node's first child id): nb_next has child_total + 1 entries on every process, a child
of which this process keeps no lane has an empty segment, and no history
entry is written (written by `node_gates`).
"""

from __future__ import annotations

import torch

from . import _build
from .limits import MAX_NODES, MAX_PAIRS, refuse_past
from .compact import compact_rows_plain
from .segstats import EXISTS_SHIFT

# pair-row columns ((P, 6) int32); the JAX rows (PROW, 8) swap PC_SOFF and
# PC_NID (mining/engine_device.JAX_PAIR_COLS maps them)
PC_LO, PC_HI, PC_RLO, PC_SID, PC_SOFF, PC_NID = range(6)
PAIR_COLS = 6
TILE_PAIRS = 1024   # csrc/children.cu kTilePairs


def _lanes_plain(nb: torch.Tensor, pairs: torch.Tensor, olo: torch.Tensor,
                 ohi: torch.Tensor, keep: torch.Tensor, pair_count: int,
                 last: torch.Tensor) -> torch.Tensor:
    """The kept lanes' rows in (node, symbol, pair) order, with `last`
    ((4, P) int32) as their sixth column: each node's lanes permuted from
    (pair, c) to (c, pair) order, so lane (p, c) of a node whose pairs
    start at s and number w lands at 4s + c*w + (p - s), then compacted."""
    device = pairs.device
    P = pairs.shape[0]
    rlo, sid, soff, nid = (pairs[:, PC_RLO], pairs[:, PC_SID],
                           pairs[:, PC_SOFF], pairs[:, PC_NID])
    nid64 = nid.to(torch.int64)
    nb64 = nb.to(torch.int64)
    first = nb64[nid64]
    width = nb64[nid64 + 1] - first
    sym64 = torch.arange(4, device=device)[:, None]
    dst = (4 * first + sym64 * width
           + (torch.arange(P, device=device) - first)).reshape(-1)
    cand = torch.stack(
        [olo[:4], ohi[:4], rlo + (ohi[4:] - olo[4:]), sid.expand(4, P),
         soff.expand(4, P), last], dim=2).reshape(4 * P, PAIR_COLS)
    vals = torch.empty_like(cand)
    vals[dst] = cand
    mask = torch.empty(4 * P, dtype=torch.bool, device=device)
    mask[dst] = keep.reshape(-1)
    return compact_rows_plain(mask, vals, pair_count)[0]


def children_plain(nb: torch.Tensor, pairs: torch.Tensor, olo: torch.Tensor,
                   ohi: torch.Tensor, keep: torch.Tensor, pair_count: int,
                   child_total: int, hist: torch.Tensor):
    """Plain PyTorch version of the children kernel (any device): the
    ordered lanes (_lanes_plain) carry hv = node*4 + symbol; a second
    compaction of the (node, symbol) boundaries gives nb_next and the
    history entries."""
    device = pairs.device
    sym = torch.arange(4, dtype=torch.int32, device=device)[:, None]
    newp = _lanes_plain(nb, pairs, olo, ohi, keep, pair_count,
                        pairs[:, PC_NID] * 4 + sym)
    hv = newp[:, PC_NID]
    bdry = torch.ones(pair_count, dtype=torch.bool, device=device)
    bdry[1:] = hv[1:] != hv[:-1]
    bsrc = torch.stack(
        [torch.arange(pair_count, dtype=torch.int32, device=device), hv],
        dim=1)
    heads, _ = compact_rows_plain(bdry, bsrc, child_total)
    newp[:, PC_NID] = (torch.cumsum(bdry, 0) - 1).to(torch.int32)
    nb_next = torch.empty(child_total + 1, dtype=torch.int32, device=device)
    nb_next[:child_total] = heads[:, 0]
    nb_next[child_total] = pair_count
    hist[:child_total] = heads[:, 1]
    return newp, nb_next


def children_ids_plain(nb: torch.Tensor, pairs: torch.Tensor,
                       olo: torch.Tensor, ohi: torch.Tensor,
                       keep: torch.Tensor, flags: torch.Tensor,
                       kid0: torch.Tensor, pair_count: int,
                       child_total: int):
    """Plain PyTorch version of the outside-ids children kernel (any
    device): lane (c, p) goes to child kid0[node] + (the node's existing
    symbols below c); nb_next is the scan of the kept lanes a (node,
    symbol), read at the existing ones."""
    device = pairs.device
    U = nb.shape[0] - 1
    sym = torch.arange(4, device=device)
    ex = ((flags.to(torch.int64)[:, None] >> (EXISTS_SHIFT + sym)) & 1)
    below = torch.cumsum(ex, 1) - ex                            # (U, 4)
    nid64 = pairs[:, PC_NID].to(torch.int64)
    last = (kid0.to(torch.int64)[nid64][None, :] + below[nid64].T).to(
        torch.int32)                                            # (4, P)
    newp = _lanes_plain(nb, pairs, olo, ohi, keep, pair_count, last)
    lanes = torch.zeros((U, 4), dtype=torch.int64, device=device).index_add_(
        0, nid64, keep.T.to(torch.int64)).reshape(-1)
    starts = torch.cumsum(lanes, 0) - lanes
    nb_next = torch.empty(child_total + 1, dtype=torch.int32, device=device)
    nb_next[:child_total] = starts[ex.reshape(-1) > 0].to(torch.int32)
    nb_next[child_total] = pair_count
    return newp, nb_next


def _refuse_counts(who: str, pair_count: int, child_total: int) -> None:
    """The next level's sizes that its int32 formats hold (ops/limits.py)."""
    refuse_past(who, "kept lanes", pair_count, MAX_PAIRS,
                "int32 node starts")
    refuse_past(who, "children", child_total, MAX_PAIRS, "int32 child ids")


def _scratch(P: int, device) -> torch.Tensor:
    """The kernel's look-back words: two a tile of TILE_PAIRS pairs and the
    tile counter (the kernel clears them)."""
    return torch.empty(2 * max(1, -(-P // TILE_PAIRS)) + 1,
                       dtype=torch.int64, device=device)


def children(nb: torch.Tensor, pairs: torch.Tensor, olo: torch.Tensor,
             ohi: torch.Tensor, keep: torch.Tensor, pair_count: int,
             child_total: int, hist: torch.Tensor):
    """-> (newp (pair_count, 6) int32, nb_next (child_total + 1,) int32),
    and hist[:child_total] written.  nb: (U+1,) int32; pairs: (P, 6)
    int32; olo, ohi: (8, P) int32 rank outputs at lo and hi; keep: (4, P)
    bool; hist: 1-D int32 with room for child_total entries; all
    contiguous on one device.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    refuse_past("children", "nodes", nb.shape[0] - 1, MAX_NODES,
                "int32 history entries parent * 4 + symbol")
    _refuse_counts("children", pair_count, child_total)
    if pairs.device.type == "cpu":
        return children_plain(nb, pairs, olo, ohi, keep, pair_count,
                              child_total, hist)
    device = pairs.device
    if device.type != "cuda":
        raise ValueError(f"children: unsupported device {device}")
    P = pairs.shape[0]
    U = nb.shape[0] - 1
    for name, t, dt, shape in (
            ("nb", nb, torch.int32, (U + 1,)),
            ("pairs", pairs, torch.int32, (P, PAIR_COLS)),
            ("olo", olo, torch.int32, (8, P)),
            ("ohi", ohi, torch.int32, (8, P)),
            ("keep", keep, torch.bool, (4, P)),
            ("hist", hist, torch.int32, hist.shape[:1])):
        if (t.dtype != dt or t.shape != shape or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"children: {name} must be contiguous {dt} of "
                             f"shape {tuple(shape)} on {device}")
    if hist.shape[0] < child_total:
        raise ValueError(f"children: hist holds {hist.shape[0]} entries, "
                         f"fewer than the {child_total} children")
    newp = torch.empty((pair_count, PAIR_COLS), dtype=torch.int32,
                       device=device)
    nb_next = torch.empty(child_total + 1, dtype=torch.int32, device=device)
    if U <= 0:
        nb_next.zero_()
        return newp, nb_next
    scratch = _scratch(P, device)       # held until the launch is enqueued
    _build.launch("dsm_children", "children", device, nb.data_ptr(),
                  pairs.data_ptr(), olo.data_ptr(), ohi.data_ptr(),
                  keep.data_ptr(), U, P, pair_count, child_total,
                  scratch.data_ptr(), newp.data_ptr(),
                  nb_next.data_ptr(), hist.data_ptr())
    return newp, nb_next


def children_ids(nb: torch.Tensor, pairs: torch.Tensor, olo: torch.Tensor,
                 ohi: torch.Tensor, keep: torch.Tensor, flags: torch.Tensor,
                 kid0: torch.Tensor, pair_count: int, child_total: int):
    """-> (newp (pair_count, 6) int32, nb_next (child_total + 1,) int32)
    of one process, with the child ids given by `flags` and `kid0` ((U,)
    int32, from ops/shardstats.node_gates); the other arguments as in
    `children`.  Every lane of `keep` must lie on an existing symbol of
    its node.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _refuse_counts("children_ids", pair_count, child_total)
    if pairs.device.type == "cpu":
        return children_ids_plain(nb, pairs, olo, ohi, keep, flags, kid0,
                                  pair_count, child_total)
    device = pairs.device
    if device.type != "cuda":
        raise ValueError(f"children_ids: unsupported device {device}")
    P = pairs.shape[0]
    U = nb.shape[0] - 1
    for name, t, dt, shape in (
            ("nb", nb, torch.int32, (U + 1,)),
            ("pairs", pairs, torch.int32, (P, PAIR_COLS)),
            ("olo", olo, torch.int32, (8, P)),
            ("ohi", ohi, torch.int32, (8, P)),
            ("keep", keep, torch.bool, (4, P)),
            ("flags", flags, torch.int32, (U,)),
            ("kid0", kid0, torch.int32, (U,))):
        if (t.dtype != dt or t.shape != shape or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"children_ids: {name} must be contiguous {dt} "
                             f"of shape {tuple(shape)} on {device}")
    newp = torch.empty((pair_count, PAIR_COLS), dtype=torch.int32,
                       device=device)
    nb_next = torch.empty(child_total + 1, dtype=torch.int32, device=device)
    if U <= 0:
        nb_next.zero_()
        return newp, nb_next
    scratch = _scratch(P, device)       # held until the launch is enqueued
    _build.launch("dsm_children_ids", "children_ids", device, nb.data_ptr(),
                  pairs.data_ptr(), olo.data_ptr(), ohi.data_ptr(),
                  keep.data_ptr(), U, P, flags.data_ptr(), kid0.data_ptr(),
                  pair_count, child_total, scratch.data_ptr(),
                  newp.data_ptr(), nb_next.data_ptr())
    return newp, nb_next
