"""The kernels of tools/pallas_repro.py (P2-P4, csrc/repro.cu).

Each takes an int32 (n,) tensor and returns a new one:
  smem_carry    : x + the index of x's 256-element block (P2, run1);
  async_copy    : 2x, through shared memory: one bulk async load and one
                  bulk async store per tile of up to 32 KB (P3, run2);
  dynamic_store : x, stored at an offset computed from the data at run
                  time (x[0] * 0) (P4, run3).
CPU tensors take the plain versions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import torch

from . import _build

BLOCK = 256   # csrc/repro.cu kBlk; tools/pallas_repro.py BLK


def smem_carry_plain(x: torch.Tensor) -> torch.Tensor:
    step = torch.arange(x.shape[0] // BLOCK, dtype=x.dtype, device=x.device)
    return x + step.repeat_interleave(BLOCK)


def async_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def dynamic_store_plain(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    off = int(x[0]) * 0 if x.shape[0] else 0
    out[off:off + x.shape[0]] = x
    return out


def _launch(name: str, key: str, x: torch.Tensor, *extra) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{key}: unsupported device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{key}: x must be contiguous (n,) int32")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    _build.launch(name, key, x.device, x.data_ptr(), out.data_ptr(),
                  x.shape[0], *extra)
    return out


def _whole_blocks(x: torch.Tensor, key: str) -> None:
    if x.shape[0] % BLOCK:
        raise ValueError(f"{key}: n must be a multiple of {BLOCK}")


def smem_carry(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return smem_carry_plain(x)
    _whole_blocks(x, "repro_carry")
    return _launch("dsm_repro_carry", "repro_carry", x)


def async_copy(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return async_copy_plain(x)
    _whole_blocks(x, "repro_async")
    if x.data_ptr() % 16:
        raise ValueError("repro_async: x must be 16-byte aligned (bulk copy)")
    return _launch("dsm_repro_async", "repro_async", x)


def dynamic_store(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return dynamic_store_plain(x)
    return _launch("dsm_repro_dynstore", "repro_dynstore", x, 0)
