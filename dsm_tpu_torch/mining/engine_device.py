"""The device-resident mining episode in PyTorch: a level loop over a
sparse (node, sample) pair list, with a host drain at each exit.

Counterpart of dsm_tpu/mining/engine_device.py `mine_device`, with the
same semantics (differentially tested against it and against
engine_np.mine_np) and the same exits: DONE, TAIL (hand the narrow deep
frontier to the host wavefront), DRAIN (output rows past `out_reserve`)
and HISTFULL (the parent-pointer history buffer is full: drain, pull the
finished levels to the host, reset, redo the level).

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
  * children: each node's candidate lanes are permuted from (pair, c) to
              (c, pair) order, so lane (p, c) of a node whose pairs start
              at s and number m lands at 4s + c*m + (p - s), and the
              compaction kernel keeps the active ones: this is the
              (node, symbol, pair) order of the JAX hv-keyed sort.  A
              second compaction of the (node, symbol) boundaries gives the
              next level's node starts `nb` and history entries
              (parent*4 + symbol); child ids are the boundary cumsum.

Pair rows are (P, 6) int32 with columns PC_* below.  The column order
differs from the JAX (PROW, 8) rows (convert.py maps them): the
compacted children carry (node*4 + symbol) in the last column, which the
child id then overwrites in place.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dsm_tpu.index.alphabet import EXT_CHARS
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_device import (ENT_MARGIN, FLAG_DONE, FLAG_DRAIN,
                                          FLAG_HISTFULL, FLAG_RUN, FLAG_TAIL,
                                          OC_DEPTH, OC_FREQ, OC_RLO, OC_ROW,
                                          OC_SID, OUT_RESERVE,
                                          TAIL_MIN_DEPTH, TAIL_WIDTH,
                                          PathHistory, _hist_cap)
from dsm_tpu.mining.engine_np import MinedOutput, node_entropy

from ..ops.compact import compact_rows
from ..ops.rank import occ_cum8
from ..ops.segstats import (EXISTS_SHIFT, F_PRESENT, F_STAT, Gates,
                            segstats)
from ..utils.device import resolve_device
from .engine import MAX_SAMPLES, DeviceIndexes, leftchar_codes_pairs

# pair-row columns ((P, 6) int32)
PC_LO, PC_HI, PC_RLO, PC_SID, PC_SOFF, PC_NID = range(6)
PAIR_COLS = 6
# output-row columns ((k, 5) int32): OC_FREQ, OC_RLO, OC_SID, OC_ROW,
# OC_DEPTH, as in dsm_tpu
OUT_COLS = 5


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


def _level(dev: DeviceIndexes, sc: _Scalars, st: EpisodeState) -> int:
    """Run one trie level on `st` in place; returns the exit flag.
    FLAG_HISTFULL leaves `st` untouched (the level is redone after the
    history segment is pulled)."""
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

    # ---- children: (node, symbol, pair)-ordered compaction -------------
    if child_total:
        nid64 = nid.to(torch.int64)
        nb64 = st.nb.to(torch.int64)
        first = nb64[nid64]
        width = nb64[nid64 + 1] - first
        sym64 = torch.arange(4, device=device)[:, None]
        dst = (4 * first + sym64 * width
               + (torch.arange(P, device=device) - first)).reshape(-1)
        sym32 = sym64.to(torch.int32)
        cand = torch.stack(
            [olo[:4], ohi[:4], rlo + (ohi[4:] - olo[4:]),
             sid.expand(4, P), soff.expand(4, P), nid * 4 + sym32],
            dim=2).reshape(4 * P, PAIR_COLS)
        vals = torch.empty_like(cand)
        vals[dst] = cand
        mask = torch.empty(4 * P, dtype=torch.bool, device=device)
        mask[dst] = keepc.reshape(-1)
        newp, _ = compact_rows(mask, vals, pair_count)
        hv = newp[:, PC_NID]
        bdry = torch.ones(pair_count, dtype=torch.bool, device=device)
        bdry[1:] = hv[1:] != hv[:-1]
        bsrc = torch.stack(
            [torch.arange(pair_count, dtype=torch.int32, device=device), hv],
            dim=1)
        heads, _ = compact_rows(bdry, bsrc, child_total)
        newp[:, PC_NID] = (torch.cumsum(bdry, 0) - 1).to(torch.int32)
        nb_next = torch.empty(child_total + 1, dtype=torch.int32,
                              device=device)
        nb_next[:child_total] = heads[:, 0]
        nb_next[child_total] = pair_count
        st.hist[st.hist_len:st.hist_len + child_total] = heads[:, 1]
    else:
        newp = pr.new_zeros((0, PAIR_COLS))
        nb_next = pr.new_zeros(1)

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


def _decode_rows(st: EpisodeState, ph: PathHistory, seg_depth0: int,
                 rows: np.ndarray, depths: np.ndarray) -> list[bytes]:
    """Paths of node `rows` at absolute `depths`: an ancestor walk on the
    device down to the current segment's base, then PathHistory for the
    pulled segments."""
    rows = np.asarray(rows, dtype=np.int64)
    depths = np.asarray(depths, dtype=np.int64)
    m = rows.shape[0]
    if m == 0:
        return []
    jrel = depths - seg_depth0
    maxj = int(jrel.max(initial=0))
    if maxj == 0:
        return ph.decode(seg_depth0, rows)
    device = st.hist.device
    r = torch.as_tensor(rows, device=device)
    jt = torch.as_tensor(jrel, device=device)
    syms = torch.zeros((m, maxj), dtype=torch.int32, device=device)
    for lev in range(maxj, 0, -1):
        take = jt >= lev
        e = st.hist[torch.where(take, r + st.lvl_off[lev - 1], 0)]
        syms[:, lev - 1] = torch.where(take, e & 3, 0)
        r = torch.where(take, (e >> 2).to(torch.int64), r)
    bases = ph.decode(seg_depth0, r.cpu().numpy())
    syms_h = syms.to(torch.uint8).cpu().numpy()
    ext = np.frombuffer(EXT_CHARS, dtype=np.uint8)
    return [bases[i] + ext[syms_h[i, :jrel[i]]].tobytes() for i in range(m)]


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
    from dsm_tpu.mining.engine_np import _Level, mine_from_level

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
) -> MinedOutput:
    """Mine with the device-resident level loop, handing narrow deep
    frontiers to the host wavefront.  Output lines and counters equal
    engine_np.mine_np's; the smallest/largest-entropy diagnostics of the
    device part are f64 sums in pair order.

    reader_order='gnu' emits byte-exactly like the reference server: the
    reader orders of the sparse emitted paths are reconstructed post hoc
    (dsm_tpu/mining/gnulazy.py).  `dev` (tables already on a device)
    fixes the device.  The history buffer takes dsm_tpu's sizing rule
    (engine_device._hist_cap; env DSM_HIST_CAP overrides).  A dict passed as
    `profile` receives host wall seconds per phase (levels, drain, tail),
    the level count and the tail's start depth."""
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
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    tracker = None
    if reader_order == "gnu":
        from dsm_tpu.mining.gnulazy import LazyGnuOrder

        tracker = LazyGnuOrder(indexes, cfg.fmin, d,
                               server_prefix_len=max(1, len(prefix)))
    elif reader_order != "ascending":
        raise ValueError(f"unknown reader_order {reader_order!r}")
    sc = _Scalars.build(cfg, tail_width=tail_width, out_reserve=out_reserve,
                        prefix_codes=tuple(EXT_CHARS.index(b)
                                           for b in prefix))
    debug = os.environ.get("DSM_DEBUG") == "1"
    prof = profile if profile is not None else {}
    for k in ("level_s", "drain_s", "tail_s"):
        prof[k] = 0.0
    prof["levels"] = 0
    prof["tail_depth"] = None

    st = _seed_episode(dev, _hist_cap(dev))
    ph = PathHistory()
    seg_depth0 = 0

    def drain() -> None:
        t = time.perf_counter()
        _drain(out, cfg, d, st, ph, seg_depth0, dev, tracker)
        prof["drain_s"] += time.perf_counter() - t

    while True:
        t0 = time.perf_counter()
        flag = _level(dev, sc, st)
        prof["level_s"] += time.perf_counter() - t0
        prof["levels"] += 1
        if debug and flag != FLAG_RUN:
            print(f"mine_device: flag={flag} depth={st.depth} "
                  f"nnodes={st.nnodes} npairs={st.npairs} "
                  f"ocount={st.ocount}", file=sys.stderr, flush=True)
        if flag == FLAG_RUN:
            continue
        if flag == FLAG_DONE:
            drain()
            break
        if flag == FLAG_TAIL:
            drain()
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
            out.sort_postorder()
            return out
        if flag == FLAG_DRAIN:
            drain()
        elif flag == FLAG_HISTFULL:
            # outputs reference the current segment: decode them first,
            # then pull the finished levels and reset the device segment
            drain()
            _pull_segment(ph, seg_depth0, st)
            seg_depth0 = st.depth

    out.total_paths = st.total_paths
    em, eM = float(st.ent_min), float(st.ent_max)
    out.smallest_entropy = em if np.isfinite(em) else 1000.0
    out.largest_entropy = eM if np.isfinite(eM) else -1000.0
    out.sort_postorder()
    return out
