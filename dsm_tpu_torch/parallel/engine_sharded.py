"""The sample-sharded occ tables of the port, and the per-level mesh
engine over them.

Counterpart of dsm_tpu/parallel/engine_sharded.py.  `ShardedIndexes`: the
samples are split into consecutive, nearly equal shards (shard k holds
samples [k*S // n, (k+1)*S // n)); a process uploads the tables of its own
shards, each as a `DeviceIndexes` with its own sample ids and int32 row
offsets (under mining/bigindex.MAX_TABLE_ROWS a shard).  The episode keeps
one pair list a process over all of them (parallel/engine_episode), with
process-local sample ids: shard k's samples start at base(k) - base(0).
dsm_tpu pads every sample to a common row count and the sample set to a
multiple of the shard count, because `shard_map` wants equal shards; here
the shards may differ in size, there is no dummy sample, and a shard may
be empty (more shards than samples).

`mine_sharded` is dsm_tpu's ('prefix', 'samples') mesh engine: the trie's
depth-0 (or deeper) symbol partitions as R prefix rows of one dense
frontier, each row a batch row of every launch, over the samples of the
process's shards; a level is one launch of the dense expand (K12, every
row and shard table in it) and one of the analyse-and-compact (K13), with,
in a group, one all-reduce of the (R, CAP, 5) per-node sums between them
where dsm_tpu psums over the samples axis.  The host emits every level
with one GnuOrderTracker a row (mining/engine.mine_levels), gathering the
frequencies and codes of every process's samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..mining.config import MiningConfig
from ..mining.engine import MIN_CAP, DeviceIndexes, mine_levels
from ..mining.engine_np import MinedOutput
from ..ops.rank import ROWW
from ..ops.shardstats import MAX_SHARDS
from .mesh import (Mesh, SamplesMesh, default_mesh_shape, make_mesh,
                   row_prefix_masks)


@dataclass
class ShardedIndexes:
    """S: the global sample count; ns: (S,) int64 text lengths of all
    samples; bounds: (n_shards + 1,) the first global sample id of every
    shard; first: the global number of this process's first shard;
    shards: this process's tables, one DeviceIndexes a shard."""

    S: int
    ns: np.ndarray
    bounds: np.ndarray
    first: int
    shards: list
    device: torch.device

    def base(self, k: int) -> int:
        """The global id of local shard k's first sample."""
        return int(self.bounds[self.first + k])

    @property
    def local_samples(self) -> int:
        """The samples of this process's shards."""
        return sum(sd.S for sd in self.shards)

    def local_soff(self) -> torch.Tensor:
        """(local_samples,) int32: each of this process's samples' first
        row in its own shard's table, by process-local sample id."""
        return torch.cat([sd.soff for sd in self.shards])

    def expand_tables(self) -> list:
        """The forward tables as ops/rank.expand_tables takes them: (frows,
        the process-local id of the shard's first sample) a shard."""
        b0 = self.base(0)
        return [(sd.frows, self.base(k) - b0)
                for k, sd in enumerate(self.shards)]

    def leftchar_tables(self) -> list:
        """The reverse tables as mining/engine.leftchar_rows takes them:
        (rrows, soff, the global id of the shard's first sample) a shard."""
        return [(sd.rrows, sd.soff, self.base(k))
                for k, sd in enumerate(self.shards)]

    def level_tables(self) -> list:
        """The tables as the dense level step takes them (ops/level.py):
        (frows, rrows, soff, the process-local column of the shard's first
        sample) a shard that holds samples."""
        b0 = self.base(0)
        return [(sd.frows, sd.rrows, sd.soff, self.base(k) - b0)
                for k, sd in enumerate(self.shards) if sd.S]

    def local_ns(self) -> np.ndarray:
        """The text lengths of this process's samples."""
        b0 = self.base(0)
        return self.ns[b0:b0 + self.local_samples]

    @classmethod
    def build(cls, indexes: list[FMIndex], mesh: SamplesMesh
              ) -> "ShardedIndexes":
        S, n = len(indexes), mesh.n_shards
        bounds = np.array([k * S // n for k in range(n + 1)], dtype=np.int64)
        shards = []
        for k in range(mesh.first_shard,
                       mesh.first_shard + mesh.shards_per_rank):
            own = indexes[bounds[k]:bounds[k + 1]]
            if own:
                shards.append(DeviceIndexes.build(own, mesh.device))
            else:
                empty = np.zeros((0, ROWW), dtype=np.uint32)
                shards.append(DeviceIndexes.from_host([], empty, empty, [],
                                                      mesh.device))
        return cls(S=S, ns=np.array([i.n for i in indexes], dtype=np.int64),
                   bounds=bounds, first=mesh.first_shard, shards=shards,
                   device=mesh.device)


def _gather_columns(dev: ShardedIndexes, mesh: SamplesMesh):
    """-> a function that turns a (R, m, S_local) tensor of this process's
    samples into the (R, m, d) host array of every process's, in sample
    order (the lists padded to the widest process's samples and
    all-gathered)."""
    import torch.distributed as dist

    spr = mesh.shards_per_rank
    widths = [int(dev.bounds[(r + 1) * spr] - dev.bounds[r * spr])
              for r in range(mesh.world)]
    wide = max(max(widths), 1)

    def gather(t: torch.Tensor) -> np.ndarray:
        pad = torch.zeros((*t.shape[:2], wide), dtype=t.dtype,
                          device=t.device)
        pad[..., :t.shape[2]] = t
        if t.device.type == "cuda":
            every = torch.empty((mesh.world, *pad.shape), dtype=t.dtype,
                                device=t.device)
            dist.all_gather_into_tensor(every, pad, group=mesh.group)
            parts = list(every)
        else:
            parts = [torch.empty_like(pad) for _ in range(mesh.world)]
            dist.all_gather(parts, pad, group=mesh.group)
        return torch.cat([p[..., :w] for p, w in zip(parts, widths)],
                         dim=2).cpu().numpy()

    return gather


def mine_sharded(indexes: list[FMIndex], cfg: MiningConfig,
                 mesh: Mesh | None = None, cap: int = MIN_CAP,
                 prefix: bytes = b"", reader_order: str = "ascending",
                 device="cuda", dev: ShardedIndexes | None = None,
                 profile: dict | None = None) -> MinedOutput:
    """Mine on a (prefix, samples) mesh: the samples in the mesh's shards,
    the child statistics summed over them each level, the trie split into
    disjoint prefix partitions, one a mesh row.  Output equal to
    engine_np.mine_np and mining/engine.mine_torch, the enforced `prefix`
    and reader_order 'gnu' included (one GnuOrderTracker a row: the rows
    see disjoint path sets, as one reference server a prefix set does).

    mesh: parallel/mesh.make_mesh; by default default_mesh_shape(world x
    DSM_SHARDS) on `device` (world: the processes of the torch.distributed
    group, one without).  Every process is given ALL the indexes, uploads
    its own shards' tables (or is given them as `dev`, built on the mesh's
    samples axis) and returns the full output.  cap: the first frontier
    capacity.  `profile`, a dict, receives the levels run, the regrows and
    the seconds of the level steps and of the host's part.  The engine
    takes no snapshot."""
    import torch.distributed as dist

    from .multihost import shards_from_env

    cfg.validate()
    if reader_order not in ("ascending", "gnu"):
        raise ValueError(f"unknown reader_order {reader_order!r}")
    if mesh is None:
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        mesh = make_mesh(*default_mesh_shape(world * shards_from_env()),
                         device=device)
    sm = mesh.samples
    if sm.shards_per_rank > MAX_SHARDS:
        raise ValueError(
            f"{sm.shards_per_rank} shards a process: the per-level engine "
            f"takes at most {MAX_SHARDS} (the level's expand carries the "
            "process's shard tables in one launch's parameters); use fewer "
            "shards a process or more processes")
    d = len(indexes)
    if dev is None:
        dev = ShardedIndexes.build(indexes, sm)
    elif (dev.device != sm.device or dev.first != sm.first_shard
          or len(dev.bounds) != sm.n_shards + 1
          or len(dev.shards) != sm.shards_per_rank):
        raise ValueError("the tables were built on another mesh")
    deep = row_prefix_masks(mesh.n_prefix)          # (R, k_rows, 4)
    trackers = None
    if reader_order == "gnu":
        from ..mining.gnuorder import GnuOrderTracker

        # one tracker a row = one reference server a owned prefix set; the
        # enforced-path depth is the longer of the row's partition depth and
        # the user prefix (wrapper-SLURM/example-server.sh)
        trackers = [GnuOrderTracker(
            d, server_prefix_len=max(1, deep.shape[1], len(prefix)))
            for _ in range(mesh.n_prefix)]
    group = sm.group
    gather = _gather_columns(dev, sm) if group is not None else None
    tables = dev.level_tables()
    if not tables:
        # a process without samples: one empty table keeps the launches
        empty = dev.shards[0]
        tables = [(empty.frows, empty.rrows, empty.soff, 0)]
    return mine_levels(cfg, d, tables, dev.local_ns(), deep, prefix,
                       trackers, cap, sm.device, group=group, gather=gather,
                       profile=profile)
