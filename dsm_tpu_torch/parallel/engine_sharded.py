"""The sample-sharded occ tables of the port.

Counterpart of dsm_tpu/parallel/engine_sharded.py `ShardedIndexes`.  The
samples are split into consecutive, nearly equal shards (shard k holds
samples [k*S // n, (k+1)*S // n)); a process uploads the tables of its own
shards, each as a `DeviceIndexes` with its own sample ids and int32 row
offsets (under mining/bigindex.MAX_TABLE_ROWS a shard).  The episode keeps
one pair list a process over all of them (parallel/engine_episode), with
process-local sample ids: shard k's samples start at base(k) - base(0).
dsm_tpu pads every sample to a common row count and the sample set to a
multiple of the shard count, because `shard_map` wants equal shards; here
the shards may differ in size, there is no dummy sample, and a shard may
be empty (more shards than samples).  The per-level mesh engine
`mine_sharded` of that module is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..mining.engine import DeviceIndexes
from ..ops.rank import ROWW
from .mesh import SamplesMesh


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
