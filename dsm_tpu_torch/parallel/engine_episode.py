"""The device-resident mining episode with the samples sharded: over the
shards one process holds on its device, and over the processes of a
`torch.distributed` group.

Counterpart of dsm_tpu/parallel/engine_episode.py `mine_device_sharded`
(the episode loop under `shard_map` over a ('samples',) mesh), with the
same semantics as the single-device episode (mining/engine_device) and
engine_np.mine_np, and the same exits: DONE, TAIL, DRAIN, HISTFULL.

Layout (parallel/mesh.SamplesMesh: world x shards_per_rank shards):

  * a shard: its samples' occ tables (parallel/engine_sharded), kept
    apart so that each keeps its own int32 row offsets;
  * a process, once, laid out as the single-device episode: ONE pair list
    of all its shards' samples, sorted by (node, sample), with
    PROCESS-LOCAL sample ids (global id = dev.base(0) + local) and each
    pair's PC_SOFF an offset into its own shard's table; `nb` of nnodes +
    1 entries (a node may own no pair on this process: an empty segment);
    one buffer of staged output rows that each level's emit appends to;
    the parent-pointer history, the level offsets, the depth, the node
    count, total_paths and the entropy range.  dsm_tpu keeps all of this a
    shard, one shard a device; the port's shards of one device share it,
    so a level's work and launches do not grow with them.

A level (`_level_sharded`, dsm_tpu mining/engine_device.py:350-597), one
launch of each kernel whatever the shards a process:
  1. the expand step over the process's shard tables (ops/rank
     .expand_tables: each pair ranked in its own shard's table): both
     interval ends, freq, active children;
  2. the partials kernel (ops/shardstats.shard_partials): one integer row
     a node, and the process's kept lanes into the level's values;
  3. the trie merge: where the mesh has a process group, ONE
     `all_reduce` of the rows a level (the library's collective, as
     `lax.psum` was XLA's);
  4. the gates kernel (ops/shardstats.node_gates): gates, existing
     children, global child ids, history entries, the pair gates and the
     level's values (children, present nodes, entropy range, gated pairs,
     the rows staged after the emit);
  5. in a group, a scalar max-reduce of the staged rows, then the ONE
     readback of the level's values;
  6. the emit through the compaction kernel, onto the end of the staged
     rows, and the outside-ids children kernel (ops/children.children_ids);
  7. the exit: HISTFULL, DONE and TAIL follow from reduced values; DRAIN
     when any process has more than `out_reserve` rows staged.
Everything derived from the reduced rows is a function of integer sums, so
every process gates, numbers and exits alike.

A drain (`_drain_sharded`, dsm_tpu :311-410) packs the staged rows into a
list with global sample ids (ops/gatherpack, one launch), takes the packed
rows' leftChar codes, each from its shard's own reverse table (the rank
kernel's leftChar entry, one launch), all-gathers rows and codes where
there are several processes (every process ends with the same rows and
emits the full output), and hands them to the single-device drain's host
half.  A process holds at most MAX_SHARDS (ops/shardstats) shards: the
level's expand and the drain's leftChar carry its shard tables in one
launch's parameters.  Snapshots hold global sample ids in (node, sample)
order, so they resume in the single-device engine, at another shard count
and in dsm_tpu, and theirs here.

No counterpart, because the port allocates every level to its size:
`_resize_sharded`, `_auto_cap_sharded`, the bucket ladder, FLAG_GROW,
refit/boost, the chunked emit, `_single_controller`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..index.fmindex import FMIndex
from ..mining.config import MiningConfig
from ..mining.engine import OUT_RESERVE, TAIL_WIDTH, leftchar_rows
from ..mining.engine_device import (FLAG_DONE, FLAG_DRAIN, FLAG_HISTFULL,
                                    FLAG_RUN, FLAG_TAIL, OC_SID, OUT_COLS,
                                    TAIL_MIN_DEPTH,
                                    PathHistory, _emit_drained,
                                    _episode_setup, _hist_cap,
                                    _load_snapshot, _node_starts,
                                    _run_episode, _Scalars)
from ..mining.engine_np import MinedOutput
from ..ops.children import (PAIR_COLS, PC_HI, PC_NID, PC_SID, PC_SOFF,
                            children_ids)
from ..ops.compact import stage_rows
from ..ops.gatherpack import gather_pack
from ..ops.rank import expand_tables
from ..ops.segstats import F_GATED
from ..ops.shardstats import (MAX_SHARDS, NACT_SHIFT, PART_COLS,
                              V_CHILDREN, V_ENT_MAX, V_ENT_MIN, V_GATED,
                              V_KEPT, V_PRESENT, V_STAGED, kept_slot,
                              level_values, node_gates, shard_partials)
from ..utils.trace import count, span, timed
from .engine_sharded import ShardedIndexes
from .mesh import SamplesMesh
from .multihost import global_samples_mesh, shards_from_env

STAGE_ROWS = 4096   # the least rows of the staging buffer


@dataclass
class ShardedEpisodeState:
    """One episode on a process, laid out as engine_device.EpisodeState
    (whose fields of the same names the decode and history helpers read):
    pairs (P, 6) int32 of all its shards' samples, sorted by (node,
    sample), with process-local sample ids; nb (nnodes + 1,) int32;
    out[:ocount]: the staged (k, 5) output rows (process-local sample ids)
    awaiting a drain, rows of one int32 buffer (None until a row is
    staged), so that a drain hands the gather one block."""

    pairs: torch.Tensor
    nb: torch.Tensor
    depth: int
    hist: torch.Tensor
    hist_len: int = 0
    lvl_off: list = field(default_factory=list)
    out: torch.Tensor | None = None
    ocount: int = 0
    total_paths: int = 0
    ent_min: float = np.inf
    ent_max: float = -np.inf

    @property
    def nnodes(self) -> int:
        return self.nb.shape[0] - 1


def _fresh_state(pairs: torch.Tensor, nb: torch.Tensor, depth: int,
                 hist_cap: int, total_paths: int = 0,
                 ent_min: float = np.inf, ent_max: float = -np.inf
                 ) -> ShardedEpisodeState:
    return ShardedEpisodeState(
        pairs=pairs, nb=nb, depth=depth,
        hist=torch.zeros(hist_cap, dtype=torch.int32, device=pairs.device),
        total_paths=total_paths, ent_min=float(ent_min),
        ent_max=float(ent_max))


def _seed_sharded_episode(dev: ShardedIndexes,
                          hist_cap: int) -> ShardedEpisodeState:
    """The root: one node holding one pair [0, n_s) for each of the
    process's samples (local ids 0.., global id = dev.base(0) + local)."""
    device, S = dev.device, dev.local_samples
    lo = dev.base(0)
    pairs = torch.zeros((S, PAIR_COLS), dtype=torch.int32, device=device)
    pairs[:, PC_HI] = torch.as_tensor(dev.ns[lo:lo + S], dtype=torch.int32,
                                      device=device)
    pairs[:, PC_SID] = torch.arange(S, dtype=torch.int32, device=device)
    pairs[:, PC_SOFF] = dev.local_soff()
    return _fresh_state(
        pairs, torch.tensor([0, S], dtype=torch.int32, device=device), 0,
        hist_cap)


def _level_sharded(dev: ShardedIndexes, sc: _Scalars,
                   st: ShardedEpisodeState, mesh: SamplesMesh,
                   eskip: int = 0, prof: dict | None = None) -> int:
    """Run one trie level on `st` in place; returns the exit flag, the
    same on every process.  FLAG_HISTFULL leaves `st` untouched.  `eskip`
    > 0 redoes the level of a dsm_tpu snapshot taken in the middle of a
    chunked emission: the nodes whose cumulative count of gated GLOBAL
    pairs ends at or below `eskip` were drained before the snapshot
    (dsm_tpu engine_device.py:515-519)."""
    depth, U, device = st.depth, st.nnodes, dev.device
    g = sc.gates(depth, dev.S)
    grouped = mesh.group is not None

    # ---- expand over the shard tables, the partial rows and kept lanes --
    olo, ohi, freq, keepc, cbits = expand_tables(
        dev.expand_tables(), st.pairs, sc.fmin, g.sym_mask)
    part = torch.empty((U, PART_COLS), dtype=torch.int64, device=device)
    vals = level_values(device)
    shard_partials(st.nb, freq, cbits, g.sym_mask, part, kept_slot(vals))

    # ---- the trie merge, then the gates -------------------------------
    if grouped:
        dist.all_reduce(part, group=mesh.group)
    flags, _ent, kid0, pair_out = node_gates(
        part, g, st.hist[st.hist_len:], st.nb, st.pairs.shape[0], st.ocount,
        vals)
    if eskip:
        gated = (flags & F_GATED) != 0
        gp = torch.where(gated, flags >> NACT_SHIFT, 0)
        gated = gated & (torch.cumsum(gp, 0) > eskip)
        pair_out = gated[st.pairs[:, PC_NID].to(torch.int64)]
        vals[V_GATED] = pair_out.sum()
        vals[V_STAGED] = vals[V_GATED] + st.ocount
    if grouped:
        dist.all_reduce(vals[V_STAGED:V_STAGED + 1], op=dist.ReduceOp.MAX,
                        group=mesh.group)
    vals = timed(prof, "level_wait_s", vals.tolist)
    child_total, n_present = int(vals[V_CHILDREN]), int(vals[V_PRESENT])

    room = st.hist.shape[0] - st.hist_len
    if child_total > room:
        if st.hist_len == 0:
            raise ValueError(
                f"one level has {child_total} children, more than the "
                f"history capacity {room} (DSM_HIST_CAP)")
        return FLAG_HISTFULL

    st.total_paths += n_present
    st.ent_min = min(st.ent_min, vals[V_ENT_MIN])
    st.ent_max = max(st.ent_max, vals[V_ENT_MAX])

    # ---- emit, children -----------------------------------------------
    n_gated = int(vals[V_GATED])
    if n_gated:
        _stage(st, pair_out, n_gated, depth)
    st.pairs, st.nb = children_ids(st.nb, st.pairs, olo, ohi, keepc, flags,
                                   kid0, int(vals[V_KEPT]), child_total)

    st.lvl_off.append(st.hist_len)
    st.hist_len += child_total
    st.depth = depth + 1
    if child_total == 0:
        return FLAG_DONE
    if child_total <= sc.tail_width and depth + 1 >= TAIL_MIN_DEPTH:
        return FLAG_TAIL
    if vals[V_STAGED] > sc.out_reserve:
        return FLAG_DRAIN
    return FLAG_RUN


def _all_gather_rows(rows: torch.Tensor, mesh: SamplesMesh) -> torch.Tensor:
    """Every process's (m_r, C) int32 rows, in rank order, on every
    process: the counts and the lists padded to the longest are
    all-gathered, and the gather kernel packs the count-bounded slices."""
    device, C = rows.device, rows.shape[1]
    count = torch.tensor([rows.shape[0]], dtype=torch.int64, device=device)
    counts = _all_gather(count, mesh).reshape(-1).tolist()
    padded = torch.zeros((max(max(counts), 1), C), dtype=torch.int32,
                         device=device)
    padded[:rows.shape[0]] = rows
    every = _all_gather(padded, mesh)
    return gather_pack([every[r, :m] for r, m in enumerate(counts)],
                       [0] * mesh.world, 0)[0]


def _all_gather(t: torch.Tensor, mesh: SamplesMesh) -> torch.Tensor:
    """(world, *t.shape): `t` of every process.  NCCL gathers into one
    tensor; gloo builds lack that and gather into a list."""
    if t.device.type == "cuda":
        out = torch.empty((mesh.world, *t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return out
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts)


def _stage(st: ShardedEpisodeState, pair_out: torch.Tensor, n_gated: int,
           depth: int) -> None:
    """The emit step: the (freq, rlo, sid, nid, depth) output rows of the
    `n_gated` pairs that `pair_out` marks, compacted in order onto the end
    of the staged rows.  The buffer doubles (one copy of the staged rows)
    when they do not fit."""
    need = st.ocount + n_gated
    if st.out is None or st.out.shape[0] < need:
        buf = torch.empty((max(2 * need, STAGE_ROWS), OUT_COLS),
                          dtype=torch.int32, device=st.pairs.device)
        if st.ocount:
            buf[:st.ocount] = st.out[:st.ocount]
        st.out = buf
    stage_rows(pair_out, st.pairs, depth, n_gated,
               st.out[st.ocount:need])
    st.ocount = need


def _drain_sharded(out: MinedOutput, cfg: MiningConfig, d: int,
                   st: ShardedEpisodeState, ph: PathHistory, seg_depth0: int,
                   dev: ShardedIndexes, mesh: SamplesMesh,
                   tracker=None, prof: dict | None = None) -> bool:
    """The staged rows under global sample ids and their leftChar codes
    (each from its shard's own reverse table), the same on every process;
    then the host half of the single-device drain
    (engine_device._emit_drained).  On the device that is two launches,
    whatever the shard count: the gather kernel packs the staged rows and
    adds the process's first sample id, and the rank kernel's leftChar
    entry codes them with the process's shard tables.  The episode keeps
    its buffer for the next levels.  -> whether this process had rows
    staged."""
    staged = st.ocount > 0
    if staged:
        rows = gather_pack([st.out[:st.ocount]], [dev.base(0)], OC_SID)[0]
        lc = leftchar_rows(dev.leftchar_tables(), rows)
        st.ocount = 0
    else:
        rows = torch.empty((0, OUT_COLS), dtype=torch.int32,
                           device=dev.device)
        lc = torch.empty(0, dtype=torch.int8, device=dev.device)
    if mesh.group is not None:
        # the codes ride as a sixth column through the one gather
        both = _all_gather_rows(
            torch.cat([rows, lc.to(torch.int32)[:, None]], dim=1), mesh)
        rows, lc = both[:, :OUT_COLS], both[:, OUT_COLS]
    if rows.shape[0]:
        rows_h, lc_h = rows.cpu().numpy(), lc.cpu().numpy()
        count(prof, "drain_rows", rows_h.shape[0])
        with span(prof, "emit_s"):
            _emit_drained(out, cfg, d, st, ph, seg_depth0, rows_h, lc_h,
                          tracker)
    return staged


def _gather_live_pairs(st: ShardedEpisodeState, dev: ShardedIndexes,
                       mesh: SamplesMesh) -> np.ndarray:
    """The live pair rows of every process on the host, (m, 6) int32 with
    global sample ids, in canonical (node, sample) order: what a snapshot
    stores and the tail handoff densifies."""
    rows = gather_pack([st.pairs], [dev.base(0)], PC_SID)[0]
    if mesh.group is not None:
        rows = _all_gather_rows(rows, mesh)
    rows = rows.cpu().numpy()
    return rows[np.lexsort((rows[:, PC_SID], rows[:, PC_NID]))]


def _local_pairs(pairs: np.ndarray, n_nodes: int, dev: ShardedIndexes):
    """Canonical pair rows ((m, 6), global sample ids, sorted by node then
    sample) -> this process's (pairs, nb) on its device: its samples' rows
    with process-local ids, and PC_SOFF recomputed for this run's tables
    (the snapshot may come from another shard count, the single-device
    engine or dsm_tpu)."""
    lo = dev.base(0)
    loc = pairs[(pairs[:, PC_SID] >= lo)
                & (pairs[:, PC_SID] < lo + dev.local_samples)].copy()
    loc[:, PC_SID] -= lo
    loc[:, PC_SOFF] = dev.local_soff().cpu().numpy()[loc[:, PC_SID]]
    return (torch.as_tensor(loc, device=dev.device),
            torch.as_tensor(_node_starts(loc[:, PC_NID], n_nodes),
                            device=dev.device))


def _resume_sharded(path: str, cfg: MiningConfig, prefix: bytes,
                    dev: ShardedIndexes, hist_cap: int):
    """A snapshot of either engine or package -> (ShardedEpisodeState,
    MinedOutput, PathHistory seeded with the frontier's paths, eskip)."""
    host, pairs, out, base_paths = _load_snapshot(path, cfg, prefix, dev.ns)
    n, depth = int(host["nvalid"]), int(host["depth"])
    st = _fresh_state(*_local_pairs(pairs, n, dev), depth, hist_cap,
                      int(host["total_paths"]), float(host["ent_min"]),
                      float(host["ent_max"]))
    return (st, out, PathHistory(base_depth=depth, base_paths=base_paths),
            int(host.get("eskip", 0)))


def _agree_on_snapshot(exists: bool, path: str | None,
                       mesh: SamplesMesh) -> None:
    """Raise on every process of the group unless all of them find the
    snapshot file `path` or none does: a process that resumed while
    another seeded a fresh episode would enter other collectives."""
    found = torch.tensor([int(exists)], dtype=torch.int64,
                         device=mesh.device)
    dist.all_reduce(found, group=mesh.group)
    n = int(found.item())
    if 0 < n < mesh.world:
        raise ValueError(
            f"the snapshot {path!r} exists on {n} of {mesh.world} processes: "
            "a group's snapshot must be on a path that every process sees")


def mine_device_sharded(
    indexes: list[FMIndex],
    cfg: MiningConfig,
    mesh: SamplesMesh | None = None,
    prefix: bytes = b"",
    tail_width: int = TAIL_WIDTH,
    out_reserve: int = OUT_RESERVE,
    checkpoint: str | None = None,
    reader_order: str = "ascending",
    device="cuda",
    profile: dict | None = None,
    dev: ShardedIndexes | None = None,
) -> MinedOutput:
    """Mine with the device-resident episode over a sharded sample set.
    Same output as engine_np.mine_np and engine_device.mine_device
    (`prefix`, `reader_order`, `tail_width`, `out_reserve` and `profile`
    as there; there is no `halt`, as in dsm_tpu).

    `mesh`: the samples axis (parallel/multihost.global_samples_mesh); by
    default every initialised process of `torch.distributed` (one process
    without a group) with DSM_SHARDS (default 1) shards each on `device`.
    Every process is given ALL the indexes, uploads its own shards'
    tables (or is given them as `dev`, built on the same mesh), takes the
    same exits and returns the full output.  A mesh with a process group,
    be it of one process, runs the collectives.

    `checkpoint`: a snapshot file in dsm_tpu's format, written at every
    DRAIN and HISTFULL exit (by rank 0; the other processes read it on
    resume, so the path is one all of them see), resumed from when it
    exists and removed when the run ends.  It holds global sample ids in
    (node, sample) order: it resumes in mine_device, at another shard
    count and in dsm_tpu, and theirs resume here.  In a group the
    processes first agree whether it exists, and every one of them raises
    when they do not."""
    if mesh is None:
        mesh = global_samples_mesh(shards_from_env(), device)
    resume = checkpoint is not None and os.path.exists(checkpoint)
    if mesh.group is not None:
        _agree_on_snapshot(resume, checkpoint, mesh)
    if mesh.shards_per_rank > MAX_SHARDS:
        raise ValueError(
            f"{mesh.shards_per_rank} shards a process: the sharded episode "
            f"takes at most {MAX_SHARDS} (the level's expand and the "
            "drain's leftChar carry the process's shard tables in one "
            "launch's parameters); use fewer shards a process (DSM_SHARDS) "
            "or more processes")
    tracker, sc, prof = _episode_setup(indexes, cfg, prefix, tail_width,
                                       out_reserve, reader_order, profile)
    if dev is None:
        dev = ShardedIndexes.build(indexes, mesh)
    elif (dev.device != mesh.device or dev.first != mesh.first_shard
          or len(dev.bounds) != mesh.n_shards + 1
          or len(dev.shards) != mesh.shards_per_rank):
        raise ValueError("the tables were built on another mesh")
    d = dev.S
    hist_cap = _hist_cap(dev)
    eskip = 0
    if resume:
        st, out, ph, eskip = _resume_sharded(checkpoint, cfg, prefix, dev,
                                             hist_cap)
    else:
        st = _seed_sharded_episode(dev, hist_cap)
        out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
        ph = PathHistory()
    return _run_episode(
        "mine_device_sharded", indexes, cfg, prefix, dev.ns, st, out, ph,
        eskip, tracker, prof, checkpoint, writes=mesh.rank == 0,
        level=lambda eskip: _level_sharded(dev, sc, st, mesh, eskip, prof),
        drain=lambda seg_depth0: _drain_sharded(out, cfg, d, st, ph,
                                                seg_depth0, dev, mesh,
                                                tracker, prof),
        live_pairs=lambda: _gather_live_pairs(st, dev, mesh))
