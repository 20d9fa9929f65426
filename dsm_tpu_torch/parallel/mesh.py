"""The ('prefix', 'samples') mesh of the port.

Counterpart of dsm_tpu/parallel/mesh.py.  The reference scales along two
axes: one metaenumerate process a sample, merged by a server over d TCP
streams, and one metaserver a DNA-prefix shard of the trie
(wrapper-SLURM/example-server.sh).  dsm_tpu makes both axes of a JAX
device mesh; here they are:

  * the samples axis, `SamplesMesh`: a process (a rank of
    `torch.distributed`, or the one process of a run without a group) has
    one device and holds `shards_per_rank` consecutive shards of the
    samples on it; the axis has world x shards_per_rank shards in all,
    rank r holding shards [r * shards_per_rank, (r + 1) * shards_per_rank);
  * the prefix axis: disjoint depth-0 (or deeper) symbol partitions of the
    union trie, which the per-level engine (parallel/engine_sharded
    `mine_sharded`) keeps as a batch axis of every launch on the process's
    device (`row_prefix_masks`).

`Mesh` joins the two with dsm_tpu's `shape[PREFIX_AXIS]` and
`shape[SAMPLES_AXIS]`.  `prefix_depth` also sizes the prefix ownership of
parallel/multihost.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np
import torch

PREFIX_AXIS = "prefix"
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


@dataclass(frozen=True)
class Mesh:
    """Stands where dsm_tpu's 2-D ('prefix', 'samples') Mesh stood:
    n_prefix prefix rows (a batch axis of the launches) over the sample
    shards of `samples`."""

    n_prefix: int
    samples: SamplesMesh

    @property
    def shape(self) -> dict:
        return {PREFIX_AXIS: self.n_prefix,
                SAMPLES_AXIS: self.samples.n_shards}

    @property
    def device(self) -> torch.device:
        return self.samples.device


def make_mesh(n_prefix: int, n_samples: int, device="cuda") -> Mesh:
    """A (n_prefix, n_samples) mesh: n_samples sample shards over the
    processes of the torch.distributed group (one process without one),
    n_samples // world a process on `device`."""
    import torch.distributed as dist

    from .multihost import global_samples_mesh

    if n_prefix < 1 or n_samples < 1:
        raise ValueError(f"mesh {n_prefix}x{n_samples}: both axes must be "
                         "at least 1")
    _depth_splits(n_prefix)          # refuses counts with no partition
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if n_samples % world:
        raise ValueError(f"mesh {n_prefix}x{n_samples}: the samples axis "
                         f"must divide over the group's {world} processes")
    return Mesh(n_prefix, global_samples_mesh(n_samples // world, device))


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor a device count into (prefix, samples) axes: prefer 4 prefix
    shards (the reference's production A/C/G/T partitioning), else 2."""
    for p in (4, 2, 1):
        if n_devices % p == 0:
            return p, n_devices // p
    return 1, n_devices


def row_masks(n_prefix: int) -> np.ndarray:
    """(n_prefix, 4) bool: which depth-0 child symbols each prefix row
    owns.  Rows partition {A,C,G,T} contiguously.  For deeper partitions
    use row_prefix_masks."""
    if n_prefix > 4:
        raise ValueError("use row_prefix_masks for >4 prefix rows")
    if 4 % n_prefix:
        raise ValueError("prefix axis must divide 4")
    masks = np.zeros((n_prefix, 4), dtype=bool)
    per = 4 // n_prefix
    for r in range(n_prefix):
        masks[r, r * per:(r + 1) * per] = True
    return masks


def _depth_splits(n_prefix: int) -> list[list[list[int]]]:
    """Factor n_prefix into per-depth contiguous symbol-group splits
    (each depth splits {A,C,G,T} into <= 4 groups; the row count is the
    product of group counts).  Any n whose prime factors are <= 4 (2s
    and 3s) is expressible; sizes are balanced as evenly as 4 symbols
    allow (4 -> 1+1+1+1, 3 -> 1+1+2, 2 -> 2+2)."""
    groups_of = {
        1: [[0, 1, 2, 3]],
        2: [[0, 1], [2, 3]],
        3: [[0], [1], [2, 3]],
        4: [[0], [1], [2], [3]],
    }
    n = n_prefix
    splits: list[list[list[int]]] = []
    while n > 1:
        for f in (4, 2, 3):
            if n % f == 0:
                splits.append(groups_of[f])
                n //= f
                break
        else:
            raise ValueError(
                f"{n_prefix} prefix rows: a per-depth symbol-mask "
                "partition exists only for row counts whose prime "
                "factors are <= 4; for other counts give each worker an "
                "explicit prefix list (parallel/multihost.owned_prefixes "
                "+ per-prefix episodes, the reference's hash-array "
                "topology)")
    return splits or [groups_of[1]]


def row_prefix_masks(n_prefix: int) -> np.ndarray:
    """(n_prefix, k, 4) bool per-depth symbol masks that partition the
    length-k DNA prefixes into n_prefix rows (k = the number of split
    depths): each depth splits the alphabet into contiguous groups and a
    row owns one group a depth, so ownership is the per-depth mask form the
    level step consumes.  Works for any row count whose prime factors are
    <= 4; other counts (5, 7, ...) take owned_prefixes' explicit lists."""
    splits = _depth_splits(n_prefix)
    if n_prefix == 1:
        return np.ones((1, 0, 4), dtype=bool)
    k = len(splits)
    masks = np.zeros((n_prefix, k, 4), dtype=bool)
    for r in range(n_prefix):
        rr = r
        for d in range(k - 1, -1, -1):
            groups = splits[d]
            g = rr % len(groups)
            rr //= len(groups)
            masks[r, d, groups[g]] = True
    return masks


def prefixes_of_row(n_prefix: int, row: int) -> list[bytes]:
    """The length-k DNA prefixes row `row` owns (cartesian product of
    its per-depth symbol groups, matching row_prefix_masks)."""
    masks = row_prefix_masks(n_prefix)
    k = masks.shape[1]
    bases = b"ACGT"
    opts = [[i for i in range(4) if masks[row, d, i]] for d in range(k)]
    return [bytes(bases[x] for x in digs) for digs in product(*opts)]
