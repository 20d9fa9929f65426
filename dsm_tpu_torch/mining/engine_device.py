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

  * expand:   the rank kernel's expand entry (ops/rank.expand), one
              launch: the ranks at lo and at hi of every pair (the four
              child intervals and the children's reverse starts) and the
              gate inputs freq, keepc and cbits;
  * stats:    the segstats kernel (ops/segstats) reduces each node's
              contiguous pairs: entropy, gates, existing children, and
              the level's sums (kept lanes, children, gated pairs,
              present nodes, entropy range), read back at once;
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
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..ops.children import (PAIR_COLS, PC_HI, PC_LO, PC_NID, PC_RLO,
                            PC_SID, PC_SOFF, children)
from ..ops.compact import stage_rows
from ..ops.decode import decode
from ..ops.limits import INT32_MAX
from ..ops.rank import expand
from ..ops.segstats import (S_ENT_MAX, S_ENT_MIN, S_GATED, Gates,
                            segstats)
from ..utils.device import resolve_device
from ..utils.trace import count, span, timed
from . import checkpoint as ckpt
from .config import MiningConfig
# the output-row columns OC_* and OUT_COLS live in engine.py, beside the
# leftChar entry that reads them, and are imported from here too
from .engine import (MAX_SAMPLES, OC_DEPTH, OC_FREQ, OC_RLO,  # noqa: F401
                     OC_ROW, OC_SID, OUT_COLS, OUT_RESERVE, TAIL_WIDTH,
                     DeviceIndexes, hbm_budget, leftchar_rows)
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
    out: staged (k, 5) output-candidate rows awaiting a drain.
    ent_min, ent_max: the entropy range of the levels run so far."""

    pairs: torch.Tensor
    nb: torch.Tensor
    depth: int
    hist: torch.Tensor
    hist_len: int = 0
    lvl_off: list = field(default_factory=list)
    out: list = field(default_factory=list)
    ocount: int = 0
    total_paths: int = 0
    ent_min: float = np.inf
    ent_max: float = -np.inf

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
    return EpisodeState(
        pairs=pairs,
        nb=torch.tensor([0, S], dtype=torch.int32, device=device),
        depth=0,
        hist=torch.zeros(hist_cap, dtype=torch.int32, device=device))


def _expand(frows: torch.Tensor, pr: torch.Tensor, fmin: int,
            sym_mask: int):
    """The expand step of a level on the pair rows `pr`: one launch of the
    rank kernel's expand entry, both interval ends and the gate inputs.
    -> (olo, ohi (8, P) int32 rank outputs, freq (P,) int32, 0 for an
    empty interval, keepc (4, P) bool, the child lanes that are active and
    allowed by `sym_mask`, cbits (P,) uint8, the active child symbols as
    bits)."""
    return expand(frows, pr, fmin, sym_mask)


def _level(dev: DeviceIndexes, sc: _Scalars, st: EpisodeState,
           eskip: int = 0, prof: dict | None = None) -> int:
    """Run one trie level on `st` in place; returns the exit flag.
    FLAG_HISTFULL leaves `st` untouched (the level is redone after the
    history segment is pulled).  `eskip` > 0 redoes the level of a
    dsm_tpu snapshot taken in the middle of a chunked emission: the gated
    pairs of its nodes whose cumulative gated count ends at or below
    `eskip` were drained before the snapshot and are not staged again
    (dsm_tpu engine_device.py:850-855).  `prof` takes `level_wait_s`, the
    wait at the level's one readback."""
    pr, depth = st.pairs, st.depth
    g = sc.gates(depth, dev.S)

    # ---- expand: rank at both interval ends, gate inputs ---------------
    olo, ohi, freq, keepc, cbits = _expand(dev.frows, pr, sc.fmin,
                                           g.sym_mask)

    # ---- stats + gates and the level's sums: one launch, one readback --
    _flags, _ent, pair_out, sums = segstats(st.nb, freq, cbits, g)
    if eskip:
        cg = torch.cumsum(pair_out, 0)
        nid = pr[:, PC_NID].to(torch.int64)
        cg_end = cg[st.nb.to(torch.int64)[nid + 1] - 1]
        pair_out = pair_out & (cg_end > eskip)
        sums[S_GATED] = pair_out.sum()
    sums = timed(prof, "level_wait_s", sums.tolist)
    pair_count, child_total, n_gated, n_present = map(int, sums[:S_ENT_MIN])

    hist_cap = st.hist.shape[0]
    if st.hist_len + child_total > hist_cap:
        if st.hist_len == 0:
            raise ValueError(
                f"one level has {child_total} children, more than the "
                f"history capacity {hist_cap} (DSM_HIST_CAP)")
        return FLAG_HISTFULL

    st.total_paths += n_present
    st.ent_min = min(st.ent_min, sums[S_ENT_MIN])
    st.ent_max = max(st.ent_max, sums[S_ENT_MAX])

    # ---- emit: stage the gated pairs' rows -----------------------------
    if n_gated:
        st.out.append(_stage(pr, pair_out, n_gated, depth))
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


def _stage(pr: torch.Tensor, pair_out: torch.Tensor, n_gated: int,
           depth: int) -> torch.Tensor:
    """The emit step: the (freq, rlo, sid, nid, depth) output rows of the
    `n_gated` pairs of `pr` that `pair_out` marks, compacted in order."""
    return stage_rows(pair_out, pr, depth, n_gated)[0]


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


def _snapshot_state(st, out: MinedOutput,
                    live: np.ndarray) -> tuple[dict, MinedOutput]:
    """The drained episode in dsm_tpu's snapshot layout (checkpoint
    _STATE_KEYS): its int32 and float32 scalars, and the live pair rows
    `live` ((m, 6), the port's columns, global sample ids, in (node,
    sample) order) as (m, 8) int32 in its column order with the two pad
    columns zero; -> (those arrays, the MinedOutput to write beside them).
    Snapshots of the port never stop inside a level: eskip is 0.

    The format keeps total_paths as int32 (dsm_tpu counts in int32 on the
    device).  A count past INT32_MAX keeps INT32_MAX there and the rest in
    the output's total_paths (an int64 counter), which is 0 in every
    snapshot of either package: both fold the device's count into the
    output only when the episode ends.  `_load_snapshot` adds the two, so
    the port resumes the exact count; below INT32_MAX the file is what it
    was, and dsm_tpu reads it as its own."""
    pairs = np.zeros((live.shape[0], 8), dtype=np.int32)
    pairs[:, JAX_PAIR_COLS] = live
    held = min(st.total_paths, INT32_MAX)
    if held != st.total_paths:
        out = replace(out,
                      total_paths=out.total_paths + st.total_paths - held)
    return dict(pairs=pairs, nvalid=np.int32(st.nnodes),
                depth=np.int32(st.depth), total_paths=np.int32(held),
                ent_min=np.float32(float(st.ent_min)),
                ent_max=np.float32(float(st.ent_max)),
                eskip=np.int32(0)), out


def _load_snapshot(path: str, cfg: MiningConfig, prefix: bytes, ns):
    """A snapshot of either package -> (its state arrays, the live pair
    rows as (m, 6) int32 in the port's columns with global sample ids, in
    (node, sample) order, MinedOutput, the frontier's paths).  The state's
    total_paths is the episode's whole count (an int), the output's is 0
    (`_snapshot_state`).  Raises ValueError when it was written for
    another config, prefix or input."""
    host, out, base_paths = ckpt.load_checkpoint(path, cfg, prefix, ns)
    host["total_paths"] = int(host["total_paths"]) + out.total_paths
    out.total_paths = 0
    pairs = np.ascontiguousarray(
        np.asarray(host["pairs"], dtype=np.int32)[:, JAX_PAIR_COLS])
    return host, pairs, out, base_paths


def _node_starts(nid: np.ndarray, n: int) -> np.ndarray:
    """nb (n + 1,) int32 of a pair list sorted by node id `nid`."""
    return np.concatenate([[0], np.cumsum(np.bincount(nid, minlength=n))]
                          ).astype(np.int32)


def _resume(path: str, cfg: MiningConfig, prefix: bytes, dev: DeviceIndexes,
            hist_cap: int):
    """A snapshot of either package -> (EpisodeState, MinedOutput,
    PathHistory seeded with the frontier's paths, eskip), as dsm_tpu's
    mine_device resumes (engine_device.py:1365-1397)."""
    host, pairs, out, base_paths = _load_snapshot(path, cfg, prefix, dev.ns)
    # the snapshot may come from another sample layout: this run's offsets
    pairs[:, PC_SOFF] = dev.soff.cpu().numpy()[pairs[:, PC_SID]]
    n = int(host["nvalid"])
    nb = _node_starts(pairs[:, PC_NID], n)
    depth = int(host["depth"])
    device = dev.device
    st = EpisodeState(
        pairs=torch.as_tensor(pairs, device=device),
        nb=torch.as_tensor(nb, device=device), depth=depth,
        hist=torch.zeros(hist_cap, dtype=torch.int32, device=device),
        total_paths=int(host["total_paths"]),
        ent_min=float(host["ent_min"]), ent_max=float(host["ent_max"]))
    ph = PathHistory(base_depth=depth, base_paths=base_paths)
    return st, out, ph, int(host.get("eskip", 0))


def _pull_segment(ph: PathHistory, seg_depth0: int, st: EpisodeState,
                  prof: dict | None = None) -> None:
    """FLAG_HISTFULL: move the finished levels' history to the host
    decoder and reset the device segment.  Outputs that reference the
    segment must be drained first.  `prof` takes the copy's seconds
    (`pull_copy_s`) and bytes (`pull_bytes`)."""
    n = st.hist_len
    if st.lvl_off:
        offs = np.asarray(st.lvl_off, dtype=np.int64)
        # a copy: on the CPU .cpu() would alias the buffer reused below
        with span(prof, "pull_copy_s"):
            packed = st.hist[:n].to("cpu", copy=True).numpy()
        count(prof, "pull_bytes", 4 * n)
        ph.add_segment(seg_depth0, packed, np.diff(np.append(offs, n)))
    st.hist_len = 0
    st.lvl_off = []


def _drain(out: MinedOutput, cfg: MiningConfig, d: int, st: EpisodeState,
           ph: PathHistory, seg_depth0: int, dev: DeviceIndexes,
           tracker=None, prof: dict | None = None) -> bool:
    """Pull the staged output candidates, apply the deferred
    left-branching gate (leftChar codes on the device for just these
    pairs), re-gate the entropy window in exact f64 per node, decode the
    paths and append the lines (dsm_tpu engine_device._drain).  `prof`
    takes the rows pulled (`drain_rows`) and the host half's seconds
    (`emit_s`).  -> whether rows were staged."""
    n = st.ocount
    if n == 0:
        return False
    orows = torch.cat(st.out)
    st.out, st.ocount = [], 0
    lc_dev = leftchar_rows([(dev.rrows, dev.soff, 0)], orows)
    orows_h, lc = orows.cpu().numpy(), lc_dev.cpu().numpy()
    count(prof, "drain_rows", n)
    with span(prof, "emit_s"):
        _emit_drained(out, cfg, d, st, ph, seg_depth0, orows_h, lc, tracker)
    return True


def _emit_drained(out: MinedOutput, cfg: MiningConfig, d: int, st,
                  ph: PathHistory, seg_depth0: int, orows_h: np.ndarray,
                  lc: np.ndarray, tracker=None) -> None:
    """The host half of a drain: the pulled output rows `orows_h` ((n, 5),
    global sample ids) and their leftChar codes `lc`, grouped by node,
    re-gated and emitted.  `st` is the episode whose history the rows'
    paths are decoded from."""
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


def _handoff_tail(indexes, cfg, prefix, out, st, live: np.ndarray,
                  ph: PathHistory, seg_depth0: int, tracker=None,
                  prof: dict | None = None) -> None:
    """FLAG_TAIL: densify the narrow frontier (`live`: its pair rows on
    the host, global sample ids) and finish on the host
    (engine_np.mine_from_level), where a thin level costs microseconds.
    `prof` takes the wavefront's seconds (`wavefront_s`) and levels
    (`tail_levels`)."""
    n, S = st.nnodes, len(indexes)
    nid, sid = live[:, PC_NID], live[:, PC_SID]
    lo_d = np.zeros((n, S), dtype=np.int64)
    hi_d = np.zeros((n, S), dtype=np.int64)
    rlo_d = np.zeros((n, S), dtype=np.int64)
    lo_d[nid, sid] = live[:, PC_LO]
    hi_d[nid, sid] = live[:, PC_HI]
    rlo_d[nid, sid] = live[:, PC_RLO]
    paths = _decode_rows(st, ph, seg_depth0, np.arange(n),
                         np.full(n, st.depth))
    level = _Level(paths=paths, lo=lo_d, hi=hi_d, rlo=rlo_d)
    with span(prof, "wavefront_s"):
        mine_from_level(indexes, cfg, level, st.depth, out, prefix=prefix,
                        tracker=tracker, profile=prof)


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
    `profile` receives (utils/trace.py; a `_s` key is host wall seconds):
    level_s (the level loop; a level redone after HISTFULL counts again,
    in each key of a level), of it level_wait_s (the wait at each level's
    one readback), levels and pairs (summed over the levels run);
    drain_s (every exit's drain), of it emit_s (the host half: the
    re-gate, the path decode, the lines), drains (those that found staged
    rows) and drain_rows; pull_s (the HISTFULL exits' pulls), of it
    pull_copy_s (the copy to the host), pull_bytes, histfull and
    pulled_levels; tail_s (the live pairs' pull, the handoff and the host
    wavefront), of it wavefront_s (engine_np.mine_from_level) and
    tail_levels (the levels it ran), and tail_depth (None without a
    tail); save_s and saves.

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
    device = resolve_device(device)
    # before the tables: the sample count's refusal comes before an upload
    tracker, sc, prof = _episode_setup(indexes, cfg, prefix, tail_width,
                                       out_reserve, reader_order, profile)
    if dev is None:
        dev = DeviceIndexes.build(indexes, device)
    elif dev.device != device:
        raise ValueError(f"tables live on {dev.device}, not on {device}")
    _check_episode_fits(indexes, cfg, prefix, device)
    d = dev.S
    hist_cap = _hist_cap(dev)
    eskip = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        st, out, ph, eskip = _resume(checkpoint, cfg, prefix, dev, hist_cap)
    else:
        st = _seed_episode(dev, hist_cap)
        out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
        ph = PathHistory()
    return _run_episode(
        "mine_device", indexes, cfg, prefix, dev.ns, st, out, ph, eskip,
        tracker, prof, checkpoint, halt=halt,
        level=lambda eskip: _level(dev, sc, st, eskip, prof),
        drain=lambda seg_depth0: _drain(out, cfg, d, st, ph, seg_depth0, dev,
                                        tracker, prof),
        live_pairs=lambda: st.pairs.cpu().numpy())


def _check_episode_fits(indexes, cfg: MiningConfig, prefix: bytes,
                        device) -> None:
    """Refuse, before the first level, an episode that the device cannot
    hold beside its resident tables: `bigindex.episode_bytes` (the bound
    `mine --engine auto` plans with) over `hbm_budget`, which the tables
    already take from."""
    from .bigindex import episode_bytes

    need = episode_bytes(indexes, cfg.fmin, prefix)
    budget = hbm_budget(device)
    if need > budget:
        raise ValueError(
            f"an episode over these {len(indexes)} samples"
            f"{f' under prefix {prefix!r}' if prefix else ''} may hold "
            f"{need:,} device bytes beside its tables, more than the "
            f"budget of {budget:,} (DSM_HBM_BYTES overrides): partition the "
            "trie by prefix (one mine_torch(prefix=...) run an enforced "
            "prefix, their outputs concatenated in prefix order; mine "
            "--num-hosts), shard the samples (mine --engine "
            "sharded-episode), or let `mine --engine auto` plan it")


def _episode_setup(indexes, cfg: MiningConfig, prefix: bytes,
                   tail_width: int, out_reserve: int, reader_order: str,
                   profile: dict | None):
    """What both episode engines make of their arguments: -> (the gnu
    reader-order tracker or None, the run's _Scalars, the profile dict
    with its keys set to zero)."""
    cfg.validate()
    d = len(indexes)
    if d > MAX_SAMPLES:
        raise ValueError(
            f"at most {MAX_SAMPLES} samples per mining episode (got {d}; "
            "the reference caps a server at 273 readers too, "
            "metaserver.cpp:19): the children step (K3, and K9c of a "
            "sharded level) stages a node's pairs in a shared-memory tile "
            "of 512 pairs, and a sharded level sums a node's active readers "
            "and child counts over its shards in 12-bit fields")
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
    prof = profile if profile is not None else {}
    for k in ("level_s", "level_wait_s", "drain_s", "emit_s", "tail_s",
              "wavefront_s", "save_s", "pull_s", "pull_copy_s"):
        prof[k] = 0.0
    prof.update(levels=0, pairs=0, drains=0, drain_rows=0, saves=0,
                histfull=0, pulled_levels=0, pull_bytes=0, tail_levels=0,
                tail_depth=None)
    return tracker, sc, prof


def _run_episode(name: str, indexes, cfg: MiningConfig, prefix: bytes, ns,
                 st, out: MinedOutput, ph: PathHistory, eskip: int, tracker,
                 prof: dict, checkpoint: str | None, *, level, drain,
                 live_pairs, halt=None, writes: bool = True) -> MinedOutput:
    """The episode loop and its exits, shared by the single-device and
    the sharded engine (`name` in the DSM_DEBUG lines).  `st` holds the
    history, depth, node count and counters (EpisodeState or
    parallel/engine_episode.ShardedEpisodeState).  level(eskip) runs one
    level on it and returns the exit flag; drain(seg_depth0) emits the
    staged rows into `out` and returns whether it found any; live_pairs()
    pulls the live pair rows to the host ((m, 6), global sample ids,
    (node, sample) order) for a snapshot or the tail handoff.  `writes`:
    this process writes and removes the snapshot file (one process of a
    group does; all of them call live_pairs, which is a collective
    there)."""
    debug = os.environ.get("DSM_DEBUG") == "1"
    seg_depth0 = st.depth
    if debug and seg_depth0:
        print(f"{name}: resumed depth={st.depth} nnodes={st.nnodes} "
              f"eskip={eskip}", file=sys.stderr)

    def poll_halt() -> None:
        if halt is None:
            return
        n = _apply_halt(st, ph, seg_depth0, halt(st.depth, out))
        if debug and n:
            print(f"{name}: halt prunes {n} nodes at depth {st.depth}",
                  file=sys.stderr)

    def save() -> None:
        if checkpoint is None:
            return
        with span(prof, "save_s"):
            live = live_pairs()
            if writes:
                state, held = _snapshot_state(st, out, live)
                ckpt.save_checkpoint(checkpoint, state, held, cfg, prefix,
                                     ns, _frontier_codes(st, ph, seg_depth0))
        prof["saves"] += 1

    def finish() -> MinedOutput:
        if checkpoint is not None and writes and os.path.exists(checkpoint):
            os.unlink(checkpoint)
        out.sort_postorder()
        return out

    while True:
        prof["pairs"] += st.pairs.shape[0]
        flag = timed(prof, "level_s", level, eskip)
        eskip = 0   # a resumed level commits: its history segment is empty
        prof["levels"] += 1
        if debug and flag != FLAG_RUN:
            print(f"{name}: flag={flag} depth={st.depth} nnodes={st.nnodes}",
                  file=sys.stderr, flush=True)
        if flag == FLAG_RUN:
            continue
        with span(prof, "drain_s"):
            prof["drains"] += bool(drain(seg_depth0))
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
            prof["tail_depth"] = st.depth
            with span(prof, "tail_s"):
                _handoff_tail(indexes, cfg, prefix, out, st, live_pairs(),
                              ph, seg_depth0, tracker=tracker, prof=prof)
            return finish()
        if flag == FLAG_HISTFULL:
            # outputs reference the current segment: they were decoded by
            # the drain; now pull the finished levels and reset the segment
            prof["histfull"] += 1
            prof["pulled_levels"] += len(st.lvl_off)
            with span(prof, "pull_s"):
                _pull_segment(ph, seg_depth0, st, prof)
            seg_depth0 = st.depth
        save()

    out.total_paths = st.total_paths
    em, eM = float(st.ent_min), float(st.ent_max)
    out.smallest_entropy = em if np.isfinite(em) else 1000.0
    out.largest_entropy = eM if np.isfinite(eM) else -1000.0
    return finish()
