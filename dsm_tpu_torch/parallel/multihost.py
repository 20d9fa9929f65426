"""Several processes on one samples axis (`torch.distributed`).

Counterpart of dsm_tpu/parallel/multihost.py `initialize` and
`global_samples_mesh`: after `initialize()` a samples axis over every
process runs the sharded episode (parallel/engine_episode) with one
all-reduce a level and all-gathers at the drains, so every process sees
the same drained rows and emits the full output.  The prefix-ownership
mode (`owned_prefixes`, `mine_owned`, `merge_outputs`) is not ported yet.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import SamplesMesh


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
