"""What carries over from the JAX package to the port: indexes, configs,
tables and state.

The mining run has no weights; its inputs are the FM-indexes and the
config, on the device the stacked fused occ tables, and its carried state
is the episode (pair list, node starts, history, staged outputs,
counters).  Nothing here imports dsm_tpu: the functions read the
attributes of the objects they are given.

  * `fmindex_from_jax(idx)`: a dsm_tpu FMIndex -> the port's FMIndex
    (both directions, SA samples, metadata; the arrays are shared, not
    copied);
  * `config_from_jax(cfg)`: a dsm_tpu MiningConfig -> the port's;
  * `tables_from_device_indexes(jdev, device)`: a dsm_tpu DeviceIndexes
    (its host arrays) -> the port's DeviceIndexes on `device`;
  * `episode_state_from_numpy(state, device)`: a JAX episode state
    (`jax.device_get` of `_seed_episode` / `_level_single` output) -> the
    port's EpisodeState;
  * `episode_state_to_numpy(st)`: the port's state -> the JAX names and
    column layouts, cut to the live sizes (the JAX state is padded to its
    capacities; compare it after cutting it with `live_numpy`);
  * `sharded_tables_from_jax(jdev, mesh, d)`: a dsm_tpu ShardedIndexes
    (its host arrays) -> the port's ShardedIndexes of the d real samples;
  * `sharded_live_numpy(state, s_loc, d)`: the stacked JAX state of the sharded
    episode (`_seed_sharded_episode` / `_level_sharded` under shard_map)
    cut to its live sizes under GLOBAL sample ids (s_loc: dsm_tpu's
    samples a shard), the inert padding samples dropped;
  * `level_state_from_jax(lo, hi, rlo, valid, device, sym_mask=None)`: a
    dsm_tpu per-level state (`_seed_state`, `_level_step_impl`, or the
    (R, CAP, S) stacked state of its mesh engine) -> the port's (R, CAP, S)
    int32 tensors and (R, CAP) bool, and the (R, 4) bool symbol mask;
  * `sharded_state_from_numpy(state, s_loc, dev)` /
    `sharded_state_to_numpy(st, dev)`: that state <-> the port's
    ShardedEpisodeState (one pair list a process, whose shards need not be
    dsm_tpu's: the pairs are taken again by sample).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index.fmindex import FMIndex, SASamples
from .mining import engine_device as ted
from .mining.config import MiningConfig
from .mining.engine import DeviceIndexes
from .ops.rank import ROWW, OccTable
from .parallel import engine_episode as tee
from .parallel.engine_sharded import ShardedIndexes


def _occ_table(t) -> OccTable:
    return OccTable(n=int(t.n), blocks=t.blocks, occ=t.occ, counts=t.counts,
                    C=t.C)


def fmindex_from_jax(idx) -> FMIndex:
    """dsm_tpu.index.fmindex.FMIndex -> the port's FMIndex over the same
    arrays.  The reverse table comes along when the index has one, and is
    rebuilt lazily (as in dsm_tpu) when it has not."""
    s = idx.sa_samples
    samples = None if s is None else SASamples(
        rows=s.rows, vals=s.vals, text_starts=s.text_starts,
        endmarker_doc=s.endmarker_doc)
    return FMIndex(
        n=int(idx.n), table=_occ_table(idx.table),
        number_of_texts=int(idx.number_of_texts),
        max_text_length=int(idx.max_text_length),
        samplerate=int(idx.samplerate), names=list(idx.names),
        sa_samples=samples,
        _rtable=None if idx._rtable is None else _occ_table(idx._rtable))


def config_from_jax(cfg) -> MiningConfig:
    """dsm_tpu.mining.config.MiningConfig -> the port's, field by field."""
    return MiningConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(MiningConfig)})


def tables_from_device_indexes(jdev, device) -> DeviceIndexes:
    """dsm_tpu.mining.engine.DeviceIndexes -> the port's tables."""
    return DeviceIndexes.from_host(jdev.ns, jdev.fnp, jdev.rnp,
                                   np.asarray(jdev.soff), device)


def level_state_from_jax(lo, hi, rlo, valid, device, sym_mask=None):
    """A dsm_tpu per-level state, (CAP, S) or (R, CAP, S) arrays with the
    (CAP,) or (R, CAP) valid rows -> (lo, hi, rlo, valid) as the port's
    level step takes them ((R, CAP, S) int32, (R, CAP) bool, R = 1 for a
    single device's), with `sym_mask` ((4,) or (R, 4)) as (R, 4) bool after
    them where it is given."""
    lo = np.asarray(lo)
    rows = lo.shape[:-2] if lo.ndim == 3 else (1,)

    def up(a, dtype, shape):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(a).astype(dtype).reshape(shape)), device=device)

    S = lo.shape[-1]
    cap = lo.shape[-2]
    out = (up(lo, np.int32, (*rows, cap, S)), up(hi, np.int32, (*rows, cap, S)),
           up(rlo, np.int32, (*rows, cap, S)), up(valid, bool, (*rows, cap)))
    if sym_mask is None:
        return out
    return (*out, up(sym_mask, bool, (*rows, 4)))


def live_numpy(state: dict) -> dict:
    """A JAX episode state (numpy) cut to its live sizes, with the same
    keys as episode_state_to_numpy."""
    par = int(state["parity"])
    P, U = int(state["npairs"]), int(state["nnodes"])
    n_hist, nlev, oc = (int(state["hist_len"]), int(state["nlev"]),
                        int(state["ocount"]))
    return dict(
        pr=np.asarray(state["pr"])[par, :P, :6],
        nb=np.asarray(state["nb"])[par, :U + 1],
        npairs=P, nnodes=U, depth=int(state["depth"]),
        hist=np.asarray(state["hist"])[:n_hist], hist_len=n_hist,
        lvl_off=np.asarray(state["lvl_off"])[:nlev], nlev=nlev,
        out=np.asarray(state["out"])[:oc, :ted.OUT_COLS], ocount=oc,
        total_paths=int(state["total_paths"]),
        ent_min=float(state["ent_min"]), ent_max=float(state["ent_max"]))


def episode_state_from_numpy(state: dict, device) -> "ted.EpisodeState":
    """JAX episode state (dict of numpy) -> the port's EpisodeState on
    `device`, with a history buffer as long as the JAX one."""
    if int(state["eskip"]) != 0:
        raise ValueError("a state in the middle of a chunked emission "
                         "(eskip > 0) has no counterpart in the port")
    live = live_numpy(state)
    pairs = np.ascontiguousarray(live["pr"][:, ted.JAX_PAIR_COLS])
    hist = np.zeros(np.asarray(state["hist"]).shape[0], dtype=np.int32)
    hist[:live["hist_len"]] = live["hist"]

    def t(a, dtype=torch.int32):   # a copy: device_get arrays are read-only
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    out = live["out"]
    return ted.EpisodeState(
        pairs=t(pairs), nb=t(live["nb"]), depth=live["depth"],
        hist=t(hist), hist_len=live["hist_len"],
        lvl_off=[int(v) for v in live["lvl_off"]],
        out=[t(out)] if out.shape[0] else [], ocount=live["ocount"],
        total_paths=live["total_paths"],
        ent_min=live["ent_min"], ent_max=live["ent_max"])


def episode_state_to_numpy(st: "ted.EpisodeState") -> dict:
    """The port's state -> JAX key names and column layouts, live sizes."""
    pr = np.zeros((st.npairs, 6), dtype=np.int32)
    pr[:, ted.JAX_PAIR_COLS] = st.pairs.cpu().numpy()
    out = (torch.cat(st.out).cpu().numpy() if st.out
           else np.zeros((0, ted.OUT_COLS), dtype=np.int32))
    return dict(
        pr=pr, nb=st.nb.cpu().numpy(), npairs=st.npairs, nnodes=st.nnodes,
        depth=st.depth, hist=st.hist[:st.hist_len].cpu().numpy(),
        hist_len=st.hist_len, lvl_off=np.asarray(st.lvl_off, dtype=np.int32),
        nlev=len(st.lvl_off), out=out, ocount=st.ocount,
        total_paths=st.total_paths, ent_min=float(st.ent_min),
        ent_max=float(st.ent_max))


def sharded_tables_from_jax(jdev, mesh, d: int | None = None
                            ) -> ShardedIndexes:
    """dsm_tpu.parallel.engine_sharded.ShardedIndexes -> the port's, over
    its first `d` samples (the real ones; dsm_tpu pads the sample set with
    dummies).  dsm_tpu pads every sample's table to one row count: the
    padded tables are stacked as they are, with the row offsets to match."""
    d = int(jdev.S) if d is None else d
    n = mesh.n_shards
    nbp = int(jdev.fnp.shape[1])
    bounds = np.array([k * d // n for k in range(n + 1)], dtype=np.int64)
    shards = []
    for k in range(mesh.first_shard, mesh.first_shard + mesh.shards_per_rank):
        a, b = int(bounds[k]), int(bounds[k + 1])
        shards.append(DeviceIndexes.from_host(
            jdev.ns[a:b], jdev.fnp[a:b].reshape(-1, ROWW),
            jdev.rnp[a:b].reshape(-1, ROWW), np.arange(b - a) * nbp,
            mesh.device))
    return ShardedIndexes(S=d, ns=np.asarray(jdev.ns[:d], dtype=np.int64),
                          bounds=bounds, first=mesh.first_shard,
                          shards=shards, device=mesh.device)


def _canonical(rows: np.ndarray, nid_col: int, sid_col: int) -> np.ndarray:
    return rows[np.lexsort((rows[:, sid_col], rows[:, nid_col]))]


def sharded_live_numpy(state: dict, s_loc: int, d: int) -> dict:
    """A stacked JAX sharded-episode state (numpy) -> its live part: `pr`
    (m, 6) in the port's PC_* columns and `out` (k, 5), both under global
    sample ids (shard * s_loc + local) without the padding samples (ids >=
    d), in (node, sample) order; the replicated scalars and the live
    history."""
    par = int(state["parity"])
    npairs, ocount = np.asarray(state["npairs"]), np.asarray(state["ocount"])
    n_shards = npairs.shape[0]
    prs, outs = [], []
    for k in range(n_shards):
        pr = np.asarray(state["pr"])[k, par, :int(npairs[k]), :6][
            :, ted.JAX_PAIR_COLS].copy()
        pr[:, ted.PC_SID] += k * s_loc
        prs.append(pr[pr[:, ted.PC_SID] < d])
        o = np.asarray(state["out"])[k, :int(ocount[k]), :ted.OUT_COLS].copy()
        o[:, ted.OC_SID] += k * s_loc
        outs.append(o[o[:, ted.OC_SID] < d])
    n_hist, nlev = int(state["hist_len"]), int(state["nlev"])
    return dict(
        pr=_canonical(np.concatenate(prs), ted.PC_NID, ted.PC_SID),
        out=_canonical(np.concatenate(outs), ted.OC_ROW, ted.OC_SID),
        nnodes=int(state["nnodes"]), depth=int(state["depth"]),
        hist=np.asarray(state["hist"])[:n_hist], hist_len=n_hist,
        lvl_off=np.asarray(state["lvl_off"])[:nlev], nlev=nlev,
        total_paths=int(state["total_paths"]),
        ent_min=float(state["ent_min"]), ent_max=float(state["ent_max"]))


def sharded_state_from_numpy(state: dict, s_loc: int, dev: ShardedIndexes
                             ) -> "tee.ShardedEpisodeState":
    """A stacked JAX sharded-episode state (numpy; s_loc: dsm_tpu's
    samples a shard) -> the port's state of this process on `dev`, with a
    history buffer as long as the JAX one."""
    if int(state["eskip"]) != 0:
        raise ValueError("a state in the middle of a chunked emission "
                         "(eskip > 0) has no counterpart in the port")
    live = sharded_live_numpy(state, s_loc, dev.S)
    st = tee._fresh_state(
        *tee._local_pairs(live["pr"], live["nnodes"], dev), live["depth"],
        np.asarray(state["hist"]).shape[0], live["total_paths"],
        live["ent_min"], live["ent_max"])
    st.hist[:live["hist_len"]] = torch.tensor(live["hist"])
    st.hist_len = live["hist_len"]
    st.lvl_off = [int(v) for v in live["lvl_off"]]
    out, lo = live["out"], dev.base(0)
    own = out[(out[:, ted.OC_SID] >= lo)
              & (out[:, ted.OC_SID] < lo + dev.local_samples)].copy()
    own[:, ted.OC_SID] -= lo
    if own.shape[0]:
        st.out, st.ocount = torch.tensor(own, device=dev.device), \
            own.shape[0]
    return st


def sharded_state_to_numpy(st: "tee.ShardedEpisodeState",
                           dev: ShardedIndexes) -> dict:
    """The port's sharded state -> the keys of `sharded_live_numpy` (one
    process: its shards are all the shards)."""
    pr = st.pairs.cpu().numpy().copy()
    pr[:, ted.PC_SID] += dev.base(0)
    out = (st.out[:st.ocount].cpu().numpy().copy() if st.ocount
           else np.zeros((0, ted.OUT_COLS), dtype=np.int32))
    out[:, ted.OC_SID] += dev.base(0)
    return dict(
        pr=_canonical(pr, ted.PC_NID, ted.PC_SID),
        out=_canonical(out, ted.OC_ROW, ted.OC_SID),
        nnodes=st.nnodes, depth=st.depth,
        hist=st.hist[:st.hist_len].cpu().numpy(), hist_len=st.hist_len,
        lvl_off=np.asarray(st.lvl_off, dtype=np.int32),
        nlev=len(st.lvl_off), total_paths=st.total_paths,
        ent_min=float(st.ent_min), ent_max=float(st.ent_max))
