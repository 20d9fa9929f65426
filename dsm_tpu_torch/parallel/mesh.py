"""The samples axis of the port: which shards of the sample set a process
holds.

Counterpart of dsm_tpu/parallel/mesh.py `SAMPLES_AXIS` and of the JAX
`Mesh` over it.  A process (a rank of `torch.distributed`, or the one
process of a run without a group) has one device and holds
`shards_per_rank` consecutive shards of the samples on it; the axis has
world x shards_per_rank shards in all, rank r holding shards
[r * shards_per_rank, (r + 1) * shards_per_rank).  `prefix_depth` sizes
the DNA-prefix shards of prefix ownership (parallel/multihost); the prefix
axis of dsm_tpu's per-level mesh is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SAMPLES_AXIS = "samples"


def prefix_depth(n_prefix: int) -> int:
    """Smallest k with 4**k >= n_prefix (enforced-prefix length)."""
    k = 0
    while 4 ** k < n_prefix:
        k += 1
    return k


@dataclass(frozen=True)
class SamplesMesh:
    """Stands where dsm_tpu's 1-D ('samples',) Mesh stood.  group: the
    process group of the axis, None for a single process; rank, world:
    this process in it; shards_per_rank: the shards each process holds;
    device: this process's device."""

    group: object
    rank: int
    world: int
    shards_per_rank: int
    device: torch.device

    @property
    def n_shards(self) -> int:
        return self.world * self.shards_per_rank

    @property
    def first_shard(self) -> int:
        """The global number of this process's first shard."""
        return self.rank * self.shards_per_rank
