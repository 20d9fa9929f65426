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
    capacities; compare it after cutting it with `live_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index.fmindex import FMIndex, SASamples
from .mining import engine_device as ted
from .mining.config import MiningConfig
from .mining.engine import DeviceIndexes
from .ops.rank import OccTable


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
        ent_min=t(live["ent_min"], torch.float64),
        ent_max=t(live["ent_max"], torch.float64))


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
