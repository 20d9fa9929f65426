"""Suffix array by prefix doubling (kernel K8, csrc/sa.cu).

Counterpart of dsm_tpu/ops/sa.py: `suffix_array_np` is the port's copy
of the host NumPy sort (`build --sa-backend numpy`, and the oracle of the
tests), `suffix_array` the counterpart of `suffix_array_jax`, with their
result element for element.  The initial rank is the code;
each round sorts the suffixes by (rank[i], rank[i+k]) with -1 past the
end, gives each its number of distinct keys before it as the new rank,
and stops when the ranks are all distinct (then the sorted order is the
suffix array, which is unique); otherwise k doubles.

A round is two steps, each with a plain PyTorch version:
  sort_round : the packed uint64 key rank << 32 | (second + 1) and its
               stable sort carrying the suffix index (kernel: 8-bit
               onesweep LSD radix passes over only the bits the round's
               ranks need).  From the second round on, the previous
               round's order gives the stable order by second
               (`second_order_plain`), so the kernel sorts that order by
               the rank bits alone;
  rank_round : adjacent-difference flags, their inclusive scan and the
               scatter rank[order[i]] = new[i]; returns the largest new
               rank, the round's one 4-byte readback.
The input keeps its length (no power-of-two padding: the JAX version
padded so that XLA compiled one program for every length).  n < 2**31,
int32 indices; codes must lie in [0, 2**31).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

RADIX_BITS = 8      # csrc/sa.cu kDigitBits: bits a pass
SORT_TILE = 4096    # csrc/sa.cu kTile: keys per onesweep tile
RANK_BLOCK = 1024   # csrc/sa.cu kRankBlock
_INT_TYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def sort_round_plain(rank: torch.Tensor, k: int, max_rank: int,
                     prev_order: torch.Tensor | None = None):
    """-> (keys int64 (n,), order int32 (n,)): the round's packed keys in
    stable sorted order and the suffix index of each.  max_rank (the
    largest rank) and prev_order are unused here; the kernel sorts only
    the bits of max_rank, starting from prev_order where it is given."""
    n = rank.shape[0]
    second = torch.zeros(n, dtype=torch.int64, device=rank.device)
    if k < n:
        second[:n - k] = rank[k:].to(torch.int64) + 1
    keys, order = torch.sort((rank.to(torch.int64) << 32) | second,
                             stable=True)
    return keys, order.to(torch.int32)


def second_order_plain(prev_order: torch.Tensor, k: int) -> torch.Tensor:
    """The stable order of round k's suffixes by second = rank[i + k] (-1
    past the end), from the previous round's order (sorted by rank, ties
    in ascending index): the suffixes i >= n - k in ascending i, then
    p - k for each p >= k of prev_order.  int32 (n,)."""
    n = prev_order.shape[0]
    tail = torch.arange(max(n - k, 0), n, dtype=torch.int32,
                        device=prev_order.device)
    return torch.cat([tail, prev_order[prev_order >= k] - k])


def sort_round(rank: torch.Tensor, k: int, max_rank: int,
               prev_order: torch.Tensor | None = None):
    """The round's sort (see sort_round_plain).  rank: contiguous (n,)
    int32 with values in [0, max_rank]; prev_order: None, or the previous
    round's order (contiguous (n,) int32), which must be sorted by rank
    with ties in ascending index.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if rank.device.type == "cpu":
        return sort_round_plain(rank, k, max_rank, prev_order)
    _check_rank(rank, "sort_round")
    n = rank.shape[0]
    derive = prev_order is not None and k < n
    if derive and (prev_order.dtype != torch.int32
                   or prev_order.shape != (n,)
                   or not prev_order.is_contiguous()
                   or prev_order.device != rank.device):
        raise ValueError("sort_round: prev_order must be contiguous (n,) "
                         "int32 on the rank's device")
    # second + 1 <= max_rank + 1; with prev_order (or k >= n, where every
    # second is 0) the passes sort the rank bits alone
    lo_bits = 0 if derive or k >= n else (max_rank + 1).bit_length()
    bits = max_rank.bit_length() + lo_bits
    dev = rank.device
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return keys, order
    work = torch.empty(_build.lib().dsm_sa_sort_workspace(
        n, k if derive else 0, bits), dtype=torch.uint8, device=dev)
    _build.launch("dsm_sa_sort", "sa_sort", dev, rank.data_ptr(),
                  prev_order.data_ptr() if derive else None, n, k, lo_bits,
                  bits, keys.data_ptr(), order.data_ptr(), work.data_ptr())
    return keys, order


def rank_round_plain(keys: torch.Tensor, order: torch.Tensor,
                     rank: torch.Tensor) -> int:
    """rank[order[i]] = #{0 < j <= i : keys[j] != keys[j-1]}, in place;
    -> the largest new rank (n - 1 when every key is distinct)."""
    new = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    new[1:] = torch.cumsum(keys[1:] != keys[:-1], 0, dtype=torch.int32)
    rank[order.to(torch.int64)] = new
    return int(new[-1])


def rank_round(keys: torch.Tensor, order: torch.Tensor,
               rank: torch.Tensor) -> int:
    """The round's rank update (see rank_round_plain).  keys: contiguous
    (n,) int64 sorted; order: contiguous (n,) int32; rank: contiguous (n,)
    int32, updated in place.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if keys.device.type == "cpu":
        return rank_round_plain(keys, order, rank)
    _check_rank(rank, "rank_round")
    n = rank.shape[0]
    for t, dtype in ((keys, torch.int64), (order, torch.int32)):
        if (t.dtype != dtype or t.shape != (n,) or not t.is_contiguous()
                or t.device != rank.device):
            raise ValueError("rank_round: keys (n,) int64 and order (n,) "
                             "int32, contiguous, on the rank's device")
    dev = rank.device
    nblocks = -(-n // RANK_BLOCK)
    block_count = torch.empty(nblocks, dtype=torch.int32, device=dev)
    block_off = torch.empty_like(block_count)
    last = torch.empty(1, dtype=torch.int32, device=dev)
    _build.launch("dsm_sa_rank", "sa_rank", dev, keys.data_ptr(),
                  order.data_ptr(), n, rank.data_ptr(), block_count.data_ptr(),
                  block_off.data_ptr(), last.data_ptr())
    return int(last)


def _check_rank(rank: torch.Tensor, name: str) -> None:
    if rank.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rank.device}")
    if (rank.dtype != torch.int32 or rank.dim() != 1
            or not rank.is_contiguous()):
        raise ValueError(f"{name}: rank must be contiguous (n,) int32")


def _prefix_doubling(codes: torch.Tensor, sort, rank_update) -> torch.Tensor:
    if codes.dim() != 1 or codes.dtype not in _INT_TYPES:
        raise ValueError("suffix_array: codes must be a 1-D integer tensor")
    n = int(codes.shape[0])
    if n >= 1 << 31:
        raise ValueError("suffix_array requires n < 2**31")
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=codes.device)
    lo, hi = (int(v) for v in torch.aminmax(codes))
    if lo < 0 or hi >= 1 << 31:
        raise ValueError("suffix_array: codes must lie in [0, 2**31)")
    rank = codes.to(torch.int32, copy=True)
    max_rank, k, order = hi, 1, None
    while True:
        keys, order = sort(rank, k, max_rank, order)
        max_rank = rank_update(keys, order, rank)
        if max_rank == n - 1:
            return order
        k *= 2


def suffix_array_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch prefix doubling (stable torch.sort on the packed
    key), on any device: the reference the kernel is held against."""
    return _prefix_doubling(codes, sort_round_plain, rank_round_plain)


def suffix_array(codes: torch.Tensor) -> torch.Tensor:
    """Suffix array of `codes` (1-D, integers in [0, 2**31)) -> (n,)
    int32 on its device.  CPU tensors take the plain version; CUDA
    tensors run the kernels, one sort and one rank update per round."""
    if codes.device.type == "cpu":
        return suffix_array_plain(codes)
    if codes.device.type != "cuda":
        raise ValueError(f"suffix_array: unsupported device {codes.device}")
    return _prefix_doubling(codes, sort_round, rank_round)


def suffix_array_np(codes: np.ndarray) -> np.ndarray:
    """Suffix array of `codes` via prefix doubling (host/NumPy)."""
    n = int(codes.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)

    rank = np.ascontiguousarray(codes, dtype=np.int64)
    k = 1
    while True:
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        kf, ks = rank[order], second[order]
        neq = np.empty(n, dtype=np.int64)
        neq[0] = 0
        neq[1:] = (kf[1:] != kf[:-1]) | (ks[1:] != ks[:-1])
        new_at_order = np.cumsum(neq)
        if new_at_order[-1] == n - 1:
            return order.astype(np.int64)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_at_order
        k *= 2


def bwt_from_sa(codes, sa):
    """BWT[i] = codes[SA[i]-1] (cyclic), of NumPy arrays or of tensors.
    With every text terminated by code 0 the wrap-around lands on a
    terminator, reproducing the counting semantics of the reference's
    pseudo-BWT (FMIndex.cpp:473-480): LF on terminators is never taken by
    the mining path, and per-symbol interval counts for terminator-free
    patterns are exact."""
    if isinstance(codes, np.ndarray):
        return np.ascontiguousarray(codes[(sa - 1) % len(codes)])
    return codes[(sa.to(torch.int64) - 1) % codes.shape[0]]
