"""Capacity planning and the bounded-memory mining path of the port.

Counterpart of dsm_tpu/mining/bigindex.py: `table_rows`, `table_bytes`,
`episode_bytes`, `CapacityPlan`, `plan` and `mine_big` (`python -m
dsm_tpu_torch mine --engine auto [--hbm-budget N]`).  The resident cost of
a collection is its stacked occ tables (one 128-byte row per 128-symbol
block, both orientations: what `DeviceIndexes.from_host` charges) plus
what an episode allocates.  The port sizes its buffers to each level
rather than to a capacity bucket, so `episode_bytes` bounds the largest
level the collection can have: the intervals of one depth are disjoint in
each sample and hold at least fmin symbols each, so a level has at most
sum(n_s) // fmin (node, sample) pairs.

`plan` routes a collection to one device, to the sample-sharded episode
over as many devices as its largest shard needs (the shards are those
`ShardedIndexes` makes: consecutive samples, equal in count), or to the
host wavefront (engine_np), whose memory is bounded by the host's.  A
prefix shards work, not the resident tables (dsm_tpu's module docstring
says why), so residency shrinks only along the sample axis.

A device is a process's one device: the plan counts the processes of the
`torch.distributed` group (one without a group).  Shards that DSM_SHARDS
or a plan puts on one device share its memory (their tables, and one
episode state a process), so they are not devices for the plan.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch.distributed as dist

from ..ops.children import PAIR_COLS
from ..ops.rank import BLOCK, ROWW
from ..ops.shardstats import MAX_SHARDS, PART_COLS
from ..utils.device import resolve_device
from .config import MiningConfig
from .engine import OUT_COLS, OUT_RESERVE, hbm_budget
from .engine_device import _hist_cap
from .engine_np import MinedOutput

# int32 row offsets address fewer rows than this (DeviceIndexes.from_host)
MAX_TABLE_ROWS = 2**31 // ROWW
# device bytes a (node, sample) pair of a level: its row and its child's
# row (PAIR_COLS int32 each), the expand step's two (8,) int32 rank columns,
# freq, the four kept lanes and the symbol bits, and the gate byte
PAIR_BYTES = 2 * PAIR_COLS * 4 + 2 * 8 * 4 + 4 + 4 + 1 + 1
# device bytes a node of a level: its flags, entropy and first child id,
# its starts in this level's and the next level's pair list, and the
# sharded episode's partial statistics row
NODE_BYTES = 4 + 8 + 4 + 4 + 4 + PART_COLS * 8
# the scratch of the compaction and children kernels, the running states
# and the stats kernel's term table
SCRATCH_BYTES = 1 << 24


def _rows(n: int) -> int:
    """Table rows of one sample of n symbols (ops/rank.fused_rows)."""
    return -(-n // BLOCK) + 1


def table_rows(indexes) -> int:
    return sum(_rows(idx.n) for idx in indexes)


def table_bytes(indexes) -> int:
    """Device bytes of the resident tables (both orientations)."""
    return 2 * table_rows(indexes) * ROWW * 4


def level_pairs(indexes, fmin: int = 1, prefix: bytes = b"") -> int:
    """The most (node, sample) pairs a level of an episode under `prefix`
    mined at `fmin` can hold: max(S, occ // fmin), occ the occurrences of
    the prefix's path summed over the samples (its node's interval widths,
    each sample's n for the root).  A depth's intervals are disjoint within
    each sample's, and a pair holds at least fmin occurrences; the levels
    above the prefix hold one node."""
    ns = np.array([idx.n for idx in indexes], dtype=np.int64)
    # the episode extends a path by LF, so its node's interval is the
    # backward search of the path reversed
    occ = (int(ns.sum()) if not prefix
           else sum(idx.count(prefix[::-1]) for idx in indexes))
    return max(len(indexes), occ // fmin)


def episode_bytes(indexes, fmin: int = 1, prefix: bytes = b"") -> int:
    """Device bytes that an episode over `indexes` under `prefix` mined at
    `fmin` may hold beside its tables, on one device or as one process of
    the sharded episode (whose shards share one pair list, one node array
    and one staging buffer, so the bound does not grow with them): the
    largest level's pairs and nodes (at most `level_pairs` of each), the
    staged output rows (up to out_reserve plus one level's gated pairs,
    three times over: the doubling buffer and its old copy, the drain's
    packed copy), the history buffer (engine_device._hist_cap) and the
    kernels' scratch."""
    ns = np.array([idx.n for idx in indexes], dtype=np.int64)
    pairs = level_pairs(indexes, fmin, prefix)
    level = (PAIR_BYTES + NODE_BYTES) * pairs
    staged = 3 * OUT_COLS * 4 * (OUT_RESERVE + pairs)
    hist = 4 * _hist_cap(SimpleNamespace(ns=ns))
    return level + staged + hist + SCRATCH_BYTES


@dataclass
class CapacityPlan:
    """Where a collection fits.  mode is 'device' (single-device episode),
    'shard' (sample-sharded episode over `devices` devices), or 'host'
    (host wavefront)."""

    mode: str
    devices: int
    resident_bytes: int
    budget: int
    reason: str


def _world() -> int:
    """The processes of the torch.distributed group, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def plan(indexes, budget: int | None = None,
         devices_available: int | None = None, fmin: int = 1,
         device="cuda") -> CapacityPlan:
    """The plan for `indexes` mined at `fmin` under `budget` bytes a
    device (default: hbm_budget of `device`) with `devices_available`
    devices (default: the processes of the group)."""
    if budget is None:
        budget = hbm_budget(resolve_device(device))
    if devices_available is None:
        devices_available = _world()
    eb = episode_bytes(indexes, fmin)
    tb = table_bytes(indexes)
    rows = table_rows(indexes)
    if rows < MAX_TABLE_ROWS and tb + eb <= budget:
        return CapacityPlan("device", 1, tb + eb, budget,
                            "full residency fits one device")
    # sample-shard: ShardedIndexes' consecutive shards of S // n samples,
    # at most MAX_SHARDS a process
    per = [_rows(idx.n) for idx in indexes]
    S = len(per)
    for ndev in range(2, min(devices_available, MAX_SHARDS * _world()) + 1):
        worst = max(sum(per[k * S // ndev:(k + 1) * S // ndev])
                    for k in range(ndev))
        if worst < MAX_TABLE_ROWS and 2 * worst * ROWW * 4 + eb <= budget:
            return CapacityPlan(
                "shard", ndev, 2 * worst * ROWW * 4 + eb, budget,
                f"sample axis sharded over {ndev} devices "
                "(parallel/engine_episode.mine_device_sharded)")
    return CapacityPlan(
        "host", 0, 0, budget,
        f"tables need {tb + eb:,} bytes resident (row bound "
        f"{MAX_TABLE_ROWS} rows, budget {budget:,}) and "
        f"{devices_available} device(s) cannot shard it; host-resident "
        "wavefront engine (bounded memory, reference-style CPU path)")


def mine_big(indexes, cfg: MiningConfig, budget: int | None = None,
             devices_available: int | None = None,
             reader_order: str = "ascending", verbose: bool = False,
             device="cuda") -> MinedOutput:
    """Mine under an explicit device-memory budget, as `plan` routes it:
    the single-device episode on `device` when it fits, the sample-sharded
    episode over a samples axis of the plan's devices when the shards fit,
    the host wavefront otherwise.  A device error is raised, never caught
    to mine on the host instead."""
    p = plan(indexes, budget, devices_available, cfg.fmin, device)
    if verbose:
        print(f"mine_big: {p.mode} — {p.reason} "
              f"(resident {p.resident_bytes:,} / budget {p.budget:,})",
              file=sys.stderr, flush=True)
    if p.mode == "device":
        from .engine import mine_torch

        return mine_torch(indexes, cfg, reader_order=reader_order,
                          device=device)
    if p.mode == "shard":
        from ..parallel.engine_episode import mine_device_sharded
        from ..parallel.multihost import global_samples_mesh

        mesh = global_samples_mesh(math.ceil(p.devices / _world()), device)
        if verbose and mesh.shards_per_rank > 1:
            print(f"mine_big: {mesh.shards_per_rank} shards a process share "
                  f"{mesh.device}: the planned residency holds only across "
                  "processes", file=sys.stderr, flush=True)
        return mine_device_sharded(indexes, cfg, mesh=mesh,
                                   reader_order=reader_order)
    from .engine_np import mine_np

    return mine_np(indexes, cfg, reader_order=reader_order)
