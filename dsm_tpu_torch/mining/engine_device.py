"""The device-resident mining episode in PyTorch: a level loop over a
sparse (node, sample) pair list, with a host drain at each exit.

Counterpart of dsm_tpu/mining/engine_device.py `mine_device`, with the
same semantics (differentially tested against it and against
engine_np.mine_np) and the same exits: DONE, TAIL (hand the narrow deep
frontier to the host wavefront), DRAIN (output rows past `out_reserve`)
and HISTFULL (the parent-pointer history buffer is full: drain, pull the
finished levels to the host, reset, redo the level).  At DRAIN and
HISTFULL exits the run saves a snapshot (`checkpoint=`, dsm_tpu's file
format, mining/checkpoint.py); at those and at TAIL it polls the steering
callback (`halt=`).

PyTorch runs eagerly, so the TPU's compiled while-loop machinery is gone:
no bucket ladder or `lax.switch`, no refit/burst redo, no emit chunking,
no (soff, sid) operand packing and no int32 fixed-point entropy windows.
Each level reads ONE small count tensor back to the host and allocates
its outputs to the exact sizes.  Per level:

  * expand:   the rank kernel (ops/rank.occ_cum8) at lo and at hi of
              every pair gives the four child intervals and the children's
              reverse starts;
  * stats:    the segstats kernel (ops/segstats) walks each node's
              contiguous pairs: entropy, gates, existing children;
  * emit:     the compaction kernel (ops/compact) keeps the gated pairs'
              (freq, rlo, sid, nid, depth) rows in the output staging list;
  * children: the children kernel (ops/children) writes the kept (pair,
              symbol) lanes in (node, symbol, pair) order, the order of
              the JAX hv-keyed sort, with the child ids, the next level's
              node starts `nb` and history entries (parent*4 + symbol).

Paths are decoded by the decode kernel (ops/decode), an ancestor walk
down the current history segment on the device; PathHistory holds the
pulled segments and a resumed snapshot's frontier.

Pair rows are (P, 6) int32 with columns PC_* (ops/children.py).  The JAX
(PROW, 8) rows swap PC_SOFF and PC_NID: JAX_PAIR_COLS maps them.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..ops.children import (PAIR_COLS, PC_HI, PC_LO, PC_NID, PC_RLO,
                            PC_SID, PC_SOFF, children)
from ..ops.compact import compact_rows
from ..ops.decode import decode
from ..ops.rank import occ_cum8
from ..ops.segstats import (EXISTS_SHIFT, F_PRESENT, F_STAT, Gates,
                            segstats)
from ..utils.device import resolve_device
from . import checkpoint as ckpt
from .config import MiningConfig
from .engine import (MAX_SAMPLES, OUT_RESERVE, TAIL_WIDTH, DeviceIndexes,
                     leftchar_codes_pairs)
from .engine_np import (MinedOutput, _Level, mine_from_level,
                        node_entropy)
from .gnulazy import LazyGnuOrder

# the exits of a level, numbered as in dsm_tpu (whose FLAG_GROW, 3, has no
# counterpart: the port's buffers take each level's exact sizes)
FLAG_RUN, FLAG_DONE, FLAG_DRAIN, FLAG_HISTFULL, FLAG_TAIL = 0, 1, 2, 4, 5
# TAIL_WIDTH (engine.py) takes effect from this depth on
TAIL_MIN_DEPTH = 12
# slack of the segstats kernel's entropy gate; the drain re-gates each
# candidate with node_entropy's exact expression
ENT_MARGIN = 1e-2
# the dsm_tpu pair-row column of each of the port's PC_* columns: its
# PC_LO, PC_HI, PC_RLO, PC_SID, PC_SOFF, PC_NID (dsm_tpu's rows hold the
# node id in column 4 and the table offset in column 5)
JAX_PAIR_COLS = [0, 1, 2, 3, 5, 4]
# output-row columns ((k, 5) int32), as in dsm_tpu
OC_FREQ, OC_RLO, OC_SID, OC_ROW, OC_DEPTH = range(5)
OUT_COLS = 5
# EXT_CHARS byte -> symbol code; 255 for a byte outside EXT_CHARS
_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[np.frombuffer(EXT_CHARS, dtype=np.uint8)] = np.arange(len(EXT_CHARS))
_EXT = np.frombuffer(EXT_CHARS, dtype=np.uint8)


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def _hist_cap(dev: DeviceIndexes) -> int:
    """Device history sizing, dsm_tpu's rule: one int32 per union-trie
    node.  Tries are typically a small multiple of the text length; 8x
    covers everything measured, and overflow degrades to a (pulled)
    FLAG_HISTFULL segment, never to an error.  The clamp spends up to
    1 GiB of device memory (DSM_HIST_CAP overrides)."""
    env = os.environ.get("DSM_HIST_CAP")
    if env:
        return int(env)
    want = 8 * _next_pow2(int(dev.ns.sum()) + 1)
    return max(1 << 20, min(want, 1 << 28))


class PathHistory:
    """The pulled parent-pointer history segments on the host
    (`_history_codes` walks them; dsm_tpu's class of the same name also
    decodes).

    Only FLAG_HISTFULL exits pull history off the device; in the common
    case this holds nothing and decoding happens on device.  Level d's
    entries (one int32 per node: parent_row*4 + sym, in node-id order)
    map rows at depth d to (parent row at d-1, symbol); segments
    accumulate keyed by absolute depth.  base_paths seeds rows at
    base_depth (checkpoint resume)."""

    def __init__(self, base_depth: int = 0,
                 base_paths: list[bytes] | None = None) -> None:
        self.base_depth = base_depth
        self.base = base_paths if base_paths is not None else [b""]
        self.levels: dict[int, np.ndarray] = {}

    def add_segment(self, d0: int, packed: np.ndarray,
                    lens: np.ndarray) -> None:
        """Levels d0+1 .. d0+len(lens) from one pulled device segment."""
        off = 0
        for k, ln in enumerate(np.asarray(lens, dtype=np.int64).tolist()):
            self.levels[d0 + k + 1] = packed[off:off + ln]
            off += ln


@dataclass(frozen=True)
class _Scalars:
    """The run's mining knobs, as host values."""

    fmin: int
    pmin: int
    pmax: int
    emin: float
    emax: float
    mindepth: int
    maxdepth: int
    tail_width: int
    out_reserve: int
    prefix_codes: tuple = ()

    @classmethod
    def build(cls, cfg: MiningConfig, tail_width: int = TAIL_WIDTH,
              out_reserve: int = OUT_RESERVE, prefix_codes: tuple = ()):
        return cls(fmin=cfg.fmin, pmin=cfg.pmin, pmax=cfg.pmax,
                   emin=cfg.emin, emax=cfg.emax, mindepth=cfg.mindepth,
                   maxdepth=cfg.maxdepth, tail_width=tail_width,
                   out_reserve=out_reserve, prefix_codes=tuple(prefix_codes))

    def sym_mask(self, depth: int) -> int:
        """Child symbols expanded at `depth` (bit c for A, C, G, T)."""
        if depth >= self.maxdepth:
            return 0
        if depth < len(self.prefix_codes):
            return 1 << self.prefix_codes[depth]
        return 0b1111

    def gates(self, depth: int, s_total: int) -> Gates:
        return Gates(depth=depth, s_total=s_total, mindepth=self.mindepth,
                     pmin=self.pmin, pmax=self.pmax, use_egate=self.emax > 0,
                     sym_mask=self.sym_mask(depth),
                     emin_lo=self.emin - ENT_MARGIN,
                     emax_hi=self.emax + ENT_MARGIN)


@dataclass
class EpisodeState:
    """One episode on the device.

    pairs (P, 6) int32: the live pair list, sorted by node id with each
    node's pairs contiguous and in ascending sample order.  nb (U+1,)
    int32: node -> first pair, nb[U] = P.  hist (hist_cap,) int32: the
    current segment's parent-pointer history (parent_row*4 + symbol, one
    entry per node), level k of the segment starting at lvl_off[k].
    out: staged (k, 5) output-candidate rows awaiting a drain."""

    pairs: torch.Tensor
    nb: torch.Tensor
    depth: int
    hist: torch.Tensor
    hist_len: int = 0
    lvl_off: list = field(default_factory=list)
    out: list = field(default_factory=list)
    ocount: int = 0
    total_paths: int = 0
    ent_min: torch.Tensor | None = None
    ent_max: torch.Tensor | None = None

    @property
    def npairs(self) -> int:
        return self.pairs.shape[0]

    @property
    def nnodes(self) -> int:
        return self.nb.shape[0] - 1


def _seed_episode(dev: DeviceIndexes, hist_cap: int) -> EpisodeState:
    """The root: one node holding one pair per sample, [0, n_s)."""
    S, device = dev.S, dev.device
    pairs = torch.zeros((S, PAIR_COLS), dtype=torch.int32, device=device)
    pairs[:, PC_HI] = torch.as_tensor(dev.ns, dtype=torch.int32,
                                      device=device)
    pairs[:, PC_SID] = torch.arange(S, dtype=torch.int32, device=device)
    pairs[:, PC_SOFF] = dev.soff
    f64 = dict(dtype=torch.float64, device=device)
    return EpisodeState(
        pairs=pairs,
        nb=torch.tensor([0, S], dtype=torch.int32, device=device),
        depth=0,
        hist=torch.zeros(hist_cap, dtype=torch.int32, device=device),
        ent_min=torch.tensor(np.inf, **f64),
        ent_max=torch.tensor(-np.inf, **f64))


def _level(dev: DeviceIndexes, sc: _Scalars, st: EpisodeState,
           eskip: int = 0) -> int:
    """Run one trie level on `st` in place; returns the exit flag.
    FLAG_HISTFULL leaves `st` untouched (the level is redone after the
    history segment is pulled).  `eskip` > 0 redoes the level of a
    dsm_tpu snapshot taken in the middle of a chunked emission: the gated
    pairs of its nodes whose cumulative gated count ends at or below
    `eskip` were drained before the snapshot and are not staged again
    (dsm_tpu engine_device.py:850-855)."""
    pr = st.pairs
    P, depth, device = st.npairs, st.depth, pr.device
    lo, hi, rlo = pr[:, PC_LO], pr[:, PC_HI], pr[:, PC_RLO]
    sid, soff, nid = pr[:, PC_SID], pr[:, PC_SOFF], pr[:, PC_NID]
    g = sc.gates(depth, dev.S)

    # ---- expand: rank at both interval ends ----------------------------
    olo = occ_cum8(dev.frows, lo, soff)                     # (8, P)
    ohi = occ_cum8(dev.frows, hi, soff)
    pa = hi > lo
    freq = torch.where(pa, hi - lo, 0)
    cact = pa[None, :] & (ohi[:4] - olo[:4] >= sc.fmin)    # (4, P)
    symv = torch.tensor([(g.sym_mask >> c) & 1 for c in range(4)],
                        dtype=torch.bool, device=device)
    keepc = cact & symv[:, None]
    c8 = cact.to(torch.uint8)
    cbits = c8[0] | (c8[1] << 1) | (c8[2] << 2) | (c8[3] << 3)

    # ---- stats + gates: one thread per node ----------------------------
    flags, ent, pair_out = segstats(st.nb, freq, cbits, g)
    if eskip:
        cg = torch.cumsum(pair_out, 0)
        cg_end = cg[st.nb.to(torch.int64)[nid.to(torch.int64) + 1] - 1]
        pair_out = pair_out & (cg_end > eskip)
    exists = (flags >> EXISTS_SHIFT) & 0b1111
    nchild = ((exists & 1) + ((exists >> 1) & 1) + ((exists >> 2) & 1)
              + ((exists >> 3) & 1))
    present = (flags & F_PRESENT) != 0
    pair_count, child_total, n_gated, n_present = torch.stack(
        [keepc.sum(), nchild.sum(), pair_out.sum(), present.sum()]).tolist()

    hist_cap = st.hist.shape[0]
    if st.hist_len + child_total > hist_cap:
        if st.hist_len == 0:
            raise ValueError(
                f"one level has {child_total} children, more than the "
                f"history capacity {hist_cap} (DSM_HIST_CAP)")
        return FLAG_HISTFULL

    st.total_paths += n_present
    stat = (flags & F_STAT) != 0
    st.ent_min = torch.minimum(st.ent_min,
                               torch.where(stat, ent, np.inf).min())
    st.ent_max = torch.maximum(st.ent_max,
                               torch.where(stat, ent, -np.inf).max())

    # ---- emit: stage the gated pairs' rows -----------------------------
    if n_gated:
        orows = torch.stack(
            [hi - lo, rlo, sid, nid,
             torch.full((P,), depth, dtype=torch.int32, device=device)],
            dim=1)
        staged, _ = compact_rows(pair_out, orows, n_gated)
        st.out.append(staged)
        st.ocount += n_gated

    # ---- children: (node, symbol, pair)-ordered rows, ids, history ------
    newp, nb_next = children(st.nb, pr, olo, ohi, keepc, pair_count,
                             child_total, st.hist[st.hist_len:])

    st.lvl_off.append(st.hist_len)
    st.hist_len += child_total
    st.pairs, st.nb, st.depth = newp, nb_next, depth + 1
    if child_total == 0:
        return FLAG_DONE
    if child_total <= sc.tail_width and depth + 1 >= TAIL_MIN_DEPTH:
        return FLAG_TAIL
    if st.ocount > sc.out_reserve:
        return FLAG_DRAIN
    return FLAG_RUN


def _history_codes(ph: PathHistory, depth: int,
                   rows: np.ndarray) -> np.ndarray:
    """The paths of `rows` at `depth` (dsm_tpu's PathHistory.decode) as an
    (m, depth) uint8 matrix of symbol codes: the pulled segments walked down to the base, then the
    base paths (a resumed snapshot's frontier)."""
    r = np.asarray(rows, dtype=np.int64)
    codes = np.empty((r.shape[0], depth), dtype=np.uint8)
    for d in range(depth, ph.base_depth, -1):
        e = ph.levels[d][r]
        codes[:, d - 1] = e & 3
        r = e >> 2
    if ph.base_depth:
        base = b"".join([ph.base[i] for i in r.tolist()])
        codes[:, :ph.base_depth] = _CODE[
            np.frombuffer(base, dtype=np.uint8)].reshape(-1, ph.base_depth)
    return codes


def _path_codes(st: EpisodeState, ph: PathHistory, seg_depth0: int,
                rows: np.ndarray, depths: np.ndarray) -> np.ndarray:
    """(m, max depth) uint8 symbol codes of the paths of node `rows` at
    absolute `depths` (each >= seg_depth0), zero past each row's depth:
    the decode kernel walks the current segment on the device down to its
    base, _history_codes the rest."""
    rows = np.asarray(rows, dtype=np.int64)
    jrel = np.asarray(depths, dtype=np.int64) - seg_depth0
    maxj = int(jrel.max(initial=0))
    if maxj == 0:
        return _history_codes(ph, seg_depth0, rows)
    device = st.hist.device
    base, syms = decode(
        st.hist, torch.tensor(st.lvl_off[:maxj], dtype=torch.int32,
                              device=device),
        torch.as_tensor(rows.astype(np.int32), device=device),
        torch.as_tensor(jrel.astype(np.int32), device=device), maxj)
    return np.concatenate([_history_codes(ph, seg_depth0, base.cpu().numpy()),
                           syms.cpu().numpy()], axis=1)


def _decode_rows(st: EpisodeState, ph: PathHistory, seg_depth0: int,
                 rows: np.ndarray, depths: np.ndarray) -> list[bytes]:
    """Paths of node `rows` at absolute `depths`, as bytes."""
    depths = np.asarray(depths, dtype=np.int64)
    codes = _path_codes(st, ph, seg_depth0, rows, depths)
    return [_EXT[codes[i, :d]].tobytes() for i, d in enumerate(depths)]


def _frontier_codes(st: EpisodeState, ph: PathHistory,
                    seg_depth0: int) -> np.ndarray:
    """(nnodes, depth) symbol codes of the live frontier's paths."""
    n = st.nnodes
    return _path_codes(st, ph, seg_depth0, np.arange(n),
                       np.full(n, st.depth))


def _match_prefixes(codes: np.ndarray, prefixes) -> np.ndarray:
    """Rows of an (n, depth) path-code matrix whose path starts with one
    of the byte strings `prefixes`, as bytes.startswith decides it: a
    prefix longer than the paths, or with a byte outside EXT_CHARS,
    matches nothing; an empty one matches every row."""
    n, depth = codes.shape
    hit = np.zeros(n, dtype=bool)
    for pre in prefixes:
        pc = _CODE[np.frombuffer(pre, dtype=np.uint8)]
        if pc.size > depth or (pc == 255).any():
            continue
        hit |= (codes[:, :pc.size] == pc).all(axis=1)
    return hit


def _apply_halt(st: EpisodeState, ph: PathHistory, seg_depth0: int,
                prefixes) -> int:
    """Prune the live frontier under `prefixes` (dsm_tpu
    engine_device._apply_halt, the reference's halt side channel as a
    pruning mask): the nodes whose path starts with one of them get their
    pairs' intervals emptied in place (hi := lo), so segstats counts them
    as no reader and they have no children.  The halted nodes' own lines
    were emitted when their level committed.  -> halted node count."""
    if not prefixes or st.nnodes == 0 or st.npairs == 0:
        return 0
    kill = _match_prefixes(_frontier_codes(st, ph, seg_depth0), prefixes)
    if not kill.any():
        return 0
    pr = st.pairs
    hit = torch.as_tensor(kill, device=pr.device)[pr[:, PC_NID].to(
        torch.int64)]
    pr[:, PC_HI] = torch.where(hit, pr[:, PC_LO], pr[:, PC_HI])
    return int(kill.sum())


def _snapshot_state(st: EpisodeState) -> dict:
    """The drained episode in dsm_tpu's snapshot layout (checkpoint
    _STATE_KEYS): its int32 and float32 scalars, and the live pair rows as
    (m, 8) int32 in its column order with the two pad columns zero.
    Snapshots of the port never stop inside a level: eskip is 0."""
    pairs = np.zeros((st.npairs, 8), dtype=np.int32)
    pairs[:, JAX_PAIR_COLS] = st.pairs.cpu().numpy()
    return dict(pairs=pairs, nvalid=np.int32(st.nnodes),
                depth=np.int32(st.depth),
                total_paths=np.int32(st.total_paths),
                ent_min=np.float32(float(st.ent_min)),
                ent_max=np.float32(float(st.ent_max)), eskip=np.int32(0))


def _resume(path: str, cfg: MiningConfig, prefix: bytes, dev: DeviceIndexes,
            hist_cap: int):
    """A snapshot of either package -> (EpisodeState, MinedOutput,
    PathHistory seeded with the frontier's paths, eskip), as dsm_tpu's
    mine_device resumes (engine_device.py:1365-1397).  Raises ValueError
    when the snapshot was written for another config, prefix or input."""
    host, out, base_paths = ckpt.load_checkpoint(path, cfg, prefix, dev.ns)
    pairs = np.ascontiguousarray(
        np.asarray(host["pairs"], dtype=np.int32)[:, JAX_PAIR_COLS])
    # the snapshot may come from another sample layout: this run's offsets
    pairs[:, PC_SOFF] = dev.soff.cpu().numpy()[pairs[:, PC_SID]]
    n = int(host["nvalid"])
    nb = np.concatenate([[0], np.cumsum(np.bincount(pairs[:, PC_NID],
                                                    minlength=n))])
    depth = int(host["depth"])
    device = dev.device
    f64 = dict(dtype=torch.float64, device=device)
    st = EpisodeState(
        pairs=torch.as_tensor(pairs, device=device),
        nb=torch.as_tensor(nb.astype(np.int32), device=device), depth=depth,
        hist=torch.zeros(hist_cap, dtype=torch.int32, device=device),
        total_paths=int(host["total_paths"]),
        ent_min=torch.tensor(float(host["ent_min"]), **f64),
        ent_max=torch.tensor(float(host["ent_max"]), **f64))
    ph = PathHistory(base_depth=depth, base_paths=base_paths)
    return st, out, ph, int(host.get("eskip", 0))


def _pull_segment(ph: PathHistory, seg_depth0: int, st: EpisodeState) -> None:
    """FLAG_HISTFULL: move the finished levels' history to the host
    decoder and reset the device segment.  Outputs that reference the
    segment must be drained first."""
    n = st.hist_len
    if st.lvl_off:
        offs = np.asarray(st.lvl_off, dtype=np.int64)
        # a copy: on the CPU .cpu() would alias the buffer reused below
        packed = st.hist[:n].to("cpu", copy=True).numpy()
        ph.add_segment(seg_depth0, packed, np.diff(np.append(offs, n)))
    st.hist_len = 0
    st.lvl_off = []


def _drain(out: MinedOutput, cfg: MiningConfig, d: int, st: EpisodeState,
           ph: PathHistory, seg_depth0: int, dev: DeviceIndexes,
           tracker=None) -> None:
    """Pull the staged output candidates, apply the deferred
    left-branching gate (leftChar codes on the device for just these
    pairs), re-gate the entropy window in exact f64 per node, decode the
    paths and append the lines (dsm_tpu engine_device._drain)."""
    n = st.ocount
    if n == 0:
        return
    orows = torch.cat(st.out)
    st.out, st.ocount = [], 0
    lc_dev = leftchar_codes_pairs(
        dev.rrows, dev.soff[orows[:, OC_SID].to(torch.int64)],
        orows[:, OC_RLO], orows[:, OC_FREQ])
    orows_h = orows.cpu().numpy()
    lc = lc_dev.cpu().numpy()
    freq = orows_h[:, OC_FREQ]
    sid = orows_h[:, OC_SID]
    rows = orows_h[:, OC_ROW]
    depths = orows_h[:, OC_DEPTH]

    # group pairs by (depth, node row) preserving first-seen order
    key = depths.astype(np.int64) << 32 | rows.astype(np.int64)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    grp = rank[inv]
    m = uniq.size
    fmat = np.zeros((m, d), dtype=np.int64)
    fmat[grp, sid] = freq
    lcmat = np.full((m, d), -1, dtype=np.int64)
    lcmat[grp, sid] = lc
    gdep = depths[first[order]]
    grow = rows[first[order]]

    ent = node_entropy(fmat, d)
    if cfg.emax > 0:
        ok = (ent >= cfg.emin) & (ent <= cfg.emax)
    else:
        ok = np.ones(m, dtype=bool)
    active = fmat > 0
    # left-branching gate (metaserver.cpp:418-419): a concrete base
    # shared by every active reader rejects the node
    lc_min = np.where(active, lcmat, 99).min(axis=1)
    lc_max = np.where(active, lcmat, -1).max(axis=1)
    lc_agg = np.where(lc_min == lc_max, lc_max, 1)  # 1 == LC_N
    ok &= lc_agg < 2
    keep = np.flatnonzero(ok)
    paths = _decode_rows(st, ph, seg_depth0, grow[keep], gdep[keep])
    for j, i in enumerate(keep):
        act = np.flatnonzero(active[i])
        if act.size == 0:
            continue   # unreachable: staged nodes have an active reader
        if tracker is None:
            order_i, ent_val = act, float(ent[i])
        else:
            order_i = tracker.order_for(paths[j])
            ent_val = tracker.entropy_for(paths[j], fmat[i], d)
        out.total_output += 1
        out.freq_histogram[act.size - 1] += 1
        occs = [(int(r), int(fmat[i, r])) for r in order_i]
        out.total_occs += len(occs)
        out.lines.append((paths[j], ent_val, occs))


def _pull_dense_frontier(st: EpisodeState):
    """The live pair list on the host: (nnodes, lo, hi, rlo, sid, nid)."""
    prs = st.pairs.cpu().numpy()
    return (st.nnodes, prs[:, PC_LO], prs[:, PC_HI], prs[:, PC_RLO],
            prs[:, PC_SID], prs[:, PC_NID])


def _handoff_tail(indexes, cfg, prefix, out, st: EpisodeState,
                  ph: PathHistory, seg_depth0: int, tracker=None) -> None:
    """FLAG_TAIL: densify the narrow frontier and finish on the host
    (engine_np.mine_from_level), where a thin level costs microseconds."""
    n, lo, hi, rlo, sid, nid = _pull_dense_frontier(st)
    S = len(indexes)
    lo_d = np.zeros((n, S), dtype=np.int64)
    hi_d = np.zeros((n, S), dtype=np.int64)
    rlo_d = np.zeros((n, S), dtype=np.int64)
    lo_d[nid, sid] = lo
    hi_d[nid, sid] = hi
    rlo_d[nid, sid] = rlo
    paths = _decode_rows(st, ph, seg_depth0, np.arange(n),
                         np.full(n, st.depth))
    level = _Level(paths=paths, lo=lo_d, hi=hi_d, rlo=rlo_d)
    mine_from_level(indexes, cfg, level, st.depth, out, prefix=prefix,
                    tracker=tracker)


def mine_device(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    prefix: bytes = b"",
    dev: DeviceIndexes | None = None,
    tail_width: int = TAIL_WIDTH,
    out_reserve: int = OUT_RESERVE,
    reader_order: str = "ascending",
    device="cuda",
    profile: dict | None = None,
    checkpoint: str | None = None,
    halt=None,
) -> MinedOutput:
    """Mine with the device-resident level loop, handing narrow deep
    frontiers to the host wavefront.  Output lines and counters equal
    engine_np.mine_np's; the smallest/largest-entropy diagnostics of the
    device part are f64 sums in pair order.

    reader_order='gnu' emits byte-exactly like the reference server: the
    reader orders of the sparse emitted paths are reconstructed post hoc
    (mining/gnulazy.py).  `dev` (tables already on a device)
    fixes the device.  The history buffer takes dsm_tpu's sizing rule
    (_hist_cap; env DSM_HIST_CAP overrides).  A dict passed as
    `profile` receives host wall seconds per phase (levels, drain, tail,
    halt polls, saves), the level and save counts and the tail's start
    depth.

    `checkpoint`: a snapshot file in dsm_tpu's format (mining/checkpoint.py),
    written at every DRAIN and HISTFULL exit, resumed from when it exists
    (it may come from dsm_tpu; another config, prefix or input is refused)
    and removed when the run ends.  `halt`: a steering callback
    `halt(depth, out) -> list of path prefixes`, polled at every DRAIN,
    HISTFULL and TAIL exit after the drain and before the save: the
    frontier's subtrees under the returned prefixes are not explored from
    the next level on (_apply_halt).  As in dsm_tpu, `out_reserve` (the
    staged rows that make a DRAIN exit; lower means finer snapshots) is
    clamped to OUT_RESERVE, so both engines drain, poll and save at the
    same levels."""
    cfg.validate()
    device = resolve_device(device)
    if dev is None:
        dev = DeviceIndexes.build(indexes, device)
    elif dev.device != device:
        raise ValueError(f"tables live on {dev.device}, not on {device}")
    if dev.S > MAX_SAMPLES:
        raise ValueError(f"mine_device supports at most {MAX_SAMPLES} "
                         f"samples (got {dev.S})")
    d = dev.S
    tracker = None
    if reader_order == "gnu":
        tracker = LazyGnuOrder(indexes, cfg.fmin, d,
                               server_prefix_len=max(1, len(prefix)))
    elif reader_order != "ascending":
        raise ValueError(f"unknown reader_order {reader_order!r}")
    sc = _Scalars.build(cfg, tail_width=tail_width,
                        out_reserve=min(out_reserve, OUT_RESERVE),
                        prefix_codes=tuple(EXT_CHARS.index(b)
                                           for b in prefix))
    debug = os.environ.get("DSM_DEBUG") == "1"
    prof = profile if profile is not None else {}
    for k in ("level_s", "drain_s", "tail_s", "halt_s", "save_s"):
        prof[k] = 0.0
    prof["levels"] = 0
    prof["saves"] = 0
    prof["tail_depth"] = None

    hist_cap = _hist_cap(dev)
    eskip = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        st, out, ph, eskip = _resume(checkpoint, cfg, prefix, dev, hist_cap)
        if debug:
            print(f"mine_device: resumed depth={st.depth} "
                  f"nnodes={st.nnodes} eskip={eskip}", file=sys.stderr)
    else:
        st = _seed_episode(dev, hist_cap)
        out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
        ph = PathHistory()
    seg_depth0 = st.depth

    def drain() -> None:
        t = time.perf_counter()
        _drain(out, cfg, d, st, ph, seg_depth0, dev, tracker)
        prof["drain_s"] += time.perf_counter() - t

    def poll_halt() -> None:
        if halt is None:
            return
        t = time.perf_counter()
        n = _apply_halt(st, ph, seg_depth0, halt(st.depth, out))
        prof["halt_s"] += time.perf_counter() - t
        if debug and n:
            print(f"mine_device: halt prunes {n} nodes at depth {st.depth}",
                  file=sys.stderr)

    def save() -> None:
        if checkpoint is None:
            return
        t = time.perf_counter()
        ckpt.save_checkpoint(checkpoint, _snapshot_state(st), out, cfg,
                             prefix, dev.ns,
                             _frontier_codes(st, ph, seg_depth0))
        prof["save_s"] += time.perf_counter() - t
        prof["saves"] += 1

    def finish() -> MinedOutput:
        if checkpoint is not None and os.path.exists(checkpoint):
            os.unlink(checkpoint)
        out.sort_postorder()
        return out

    while True:
        t0 = time.perf_counter()
        flag = _level(dev, sc, st, eskip)
        eskip = 0   # a resumed level commits: its history segment is empty
        prof["level_s"] += time.perf_counter() - t0
        prof["levels"] += 1
        if debug and flag != FLAG_RUN:
            print(f"mine_device: flag={flag} depth={st.depth} "
                  f"nnodes={st.nnodes} npairs={st.npairs} "
                  f"ocount={st.ocount}", file=sys.stderr, flush=True)
        if flag == FLAG_RUN:
            continue
        drain()
        if flag == FLAG_DONE:
            break
        poll_halt()
        if flag == FLAG_TAIL:
            # fold the device-side stats in before the host tail adds its own
            out.total_paths += st.total_paths
            em, eM = float(st.ent_min), float(st.ent_max)
            if np.isfinite(em):
                out.smallest_entropy = min(out.smallest_entropy, em)
            if np.isfinite(eM):
                out.largest_entropy = max(out.largest_entropy, eM)
            t = time.perf_counter()
            prof["tail_depth"] = st.depth
            _handoff_tail(indexes, cfg, prefix, out, st, ph, seg_depth0,
                          tracker=tracker)
            prof["tail_s"] += time.perf_counter() - t
            return finish()
        if flag == FLAG_HISTFULL:
            # outputs reference the current segment: they were decoded by
            # the drain; now pull the finished levels and reset the segment
            _pull_segment(ph, seg_depth0, st)
            seg_depth0 = st.depth
        save()

    out.total_paths = st.total_paths
    em, eM = float(st.ent_min), float(st.ent_max)
    out.smallest_entropy = em if np.isfinite(em) else 1000.0
    out.largest_entropy = eM if np.isfinite(eM) else -1000.0
    return finish()
