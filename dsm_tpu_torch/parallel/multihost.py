"""Mining on several hosts: the two modes of dsm_tpu/parallel/multihost.py.

  * PREFIX OWNERSHIP (`owned_prefixes`, `mine_owned`, `merge_outputs`):
    each host mines its contiguous share of the 4**k length-k DNA
    prefixes, one enforced-prefix run a prefix on its one device, and the
    hosts exchange nothing; the hosts' outputs merged in post-order are
    the full mine.  `python -m dsm_tpu_torch mine --num-hosts N --host-id
    I` drives it (cli/main.py).
  * GLOBAL SAMPLES AXIS (`initialize`, `global_samples_mesh`): after
    `initialize()` a samples axis over every process runs the sharded
    episode (parallel/engine_episode) with one all-reduce a level and
    all-gathers at the drains, so every process sees the same drained rows
    and emits the full output.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..index.fmindex import FMIndex
from ..mining.config import MiningConfig
from ..mining.engine_np import MinedOutput
from ..utils.device import resolve_device
from .mesh import SamplesMesh, prefix_depth


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str | None = None) -> None:
    """`torch.distributed.init_process_group` for process `process_id` of
    `num_processes`.  coordinator: "host:port" (as dsm_tpu's
    `initialize` takes it) or an init method of torch.distributed
    ("tcp://host:port", "file:///shared/path").  backend: "nccl" (one
    process a GPU) or "gloo" (the CPU); by default nccl where CUDA is
    available."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=method,
                            world_size=num_processes, rank=process_id)


def global_samples_mesh(shards_per_rank: int = 1,
                        device="cuda") -> SamplesMesh:
    """The samples axis over every initialised process (one process when
    `initialize` was not called), each holding `shards_per_rank` shards on
    `device`."""
    if shards_per_rank < 1:
        raise ValueError("shards_per_rank must be at least 1")
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return SamplesMesh(dist.group.WORLD, dist.get_rank(),
                           dist.get_world_size(), shards_per_rank, device)
    return SamplesMesh(None, 0, 1, shards_per_rank, device)


def shards_from_env() -> int:
    """Shards a process, from the environment variable DSM_SHARDS
    (default 1)."""
    return int(os.environ.get("DSM_SHARDS", "1"))


def owned_prefixes(num_hosts: int, host_id: int,
                   hash_depth: int | None = None) -> list[bytes]:
    """The DNA prefixes host `host_id` of `num_hosts` owns: a contiguous
    partition of the 4**hash_depth length-hash_depth prefixes
    (hash_depth defaults to the smallest depth with enough prefixes)."""
    if not 0 <= host_id < num_hosts:
        raise ValueError("host_id out of range")
    if hash_depth is None:
        hash_depth = max(1, prefix_depth(num_hosts))
    n = 4 ** hash_depth
    if num_hosts > n:
        raise ValueError(f"more hosts than 4**{hash_depth} prefixes")
    # contiguous split of the prefix index range (uneven tails allowed)
    lo = host_id * n // num_hosts
    hi = (host_id + 1) * n // num_hosts
    bases = b"ACGT"
    out = []
    for i in range(lo, hi):
        digs = [(i // 4 ** (hash_depth - 1 - d)) % 4
                for d in range(hash_depth)]
        out.append(bytes(bases[x] for x in digs))
    return out


def merge_outputs(parts: list[MinedOutput], d: int) -> MinedOutput:
    """Combine disjoint-subtree mining outputs (counters summed, lines
    re-sorted into global lexicographic post-order)."""
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    out.smallest_entropy = 1000.0
    out.largest_entropy = -1000.0
    for p in parts:
        out.lines.extend(p.lines)
        out.total_paths += p.total_paths
        out.total_output += p.total_output
        out.total_occs += p.total_occs
        out.smallest_entropy = min(out.smallest_entropy, p.smallest_entropy)
        out.largest_entropy = max(out.largest_entropy, p.largest_entropy)
        if p.freq_histogram is not None:
            out.freq_histogram += np.asarray(p.freq_histogram)
    out.sort_postorder()
    return out


def mine_owned(indexes: list[FMIndex], cfg: MiningConfig, num_hosts: int,
               host_id: int, hash_depth: int | None = None,
               engine: str = "tpu", device="cuda") -> MinedOutput:
    """Mine this host's owned prefix shards and merge them.  Together with
    the other hosts' runs this is the complete mine.  engine "numpy" mines
    each prefix on the host (engine_np.mine_np); any other engine runs the
    single-device episode (mining/engine.mine_torch) on `device`, one run
    a prefix, as dsm_tpu runs its mine_tpu."""
    d = len(indexes)
    parts = []
    for prefix in owned_prefixes(num_hosts, host_id, hash_depth):
        if engine == "numpy":
            from ..mining.engine_np import mine_np

            parts.append(mine_np(indexes, cfg, prefix=prefix))
        else:
            from ..mining.engine import mine_torch

            parts.append(mine_torch(indexes, cfg, prefix=prefix,
                                    device=device))
    return merge_outputs(parts, d)
