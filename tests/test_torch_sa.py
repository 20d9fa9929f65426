"""The port's suffix array (dsm_tpu_torch/ops/sa.py, kernel K8) and the
repro kernels' plain versions (ops/repro.py, P2-P4) against dsm_tpu.

On the CPU, `suffix_array` runs its plain PyTorch version.  It is held,
exactly, against dsm_tpu's `suffix_array_jax` (JAX CPU backend, as
tests/test_index_core.py runs it) and `suffix_array_np`, on inputs made
with numpy from a seed: random codes, n = 0, 1 and 2, all-equal codes,
many short texts each ending in TERM, one long repeat, and codes that
need more than 32 bits of key in the first round.  At every round of
those inputs, the order by second derived from the previous round's
order, sorted by rank alone, equals the round's sort: the shortcut the
kernel takes.  The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import TERM
from dsm_tpu.ops.sa import bwt_from_sa as bwt_from_sa_np
from dsm_tpu.ops.sa import suffix_array_jax, suffix_array_np
from dsm_tpu_torch.ops import repro
from dsm_tpu_torch.ops.sa import (bwt_from_sa, rank_round, rank_round_plain,
                                  second_order_plain, sort_round,
                                  sort_round_plain, suffix_array,
                                  suffix_array_plain)
from dsm_tpu_torch.tools.pallas_repro import expected, run_cases


def _codes(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case.startswith("n="):
        return rng.integers(0, 6, size=int(case[2:])).astype(np.int8)
    if case == "random":
        return rng.integers(0, 6, size=3000).astype(np.int8)
    if case == "all_equal":
        return np.full(1500, 3, dtype=np.int8)
    if case == "short_texts":          # 400 texts of 1..12 symbols + TERM
        parts = []
        for ln in rng.integers(1, 13, size=400):
            parts.append(rng.integers(1, 6, size=ln).astype(np.int8))
            parts.append(np.array([TERM], dtype=np.int8))
        return np.concatenate(parts)
    if case == "long_repeat":          # a 7-symbol period, then a tail
        unit = rng.integers(1, 6, size=7).astype(np.int8)
        return np.concatenate([np.tile(unit, 1200), unit[:3],
                               np.array([TERM], dtype=np.int8)])
    if case == "wide_codes":           # rank << 32 | second needs 50 bits
        return rng.integers(0, 1 << 24, size=2000).astype(np.int64)
    raise ValueError(case)


CASES = ["n=0", "n=1", "n=2", "random", "all_equal", "short_texts",
         "long_repeat", "wide_codes"]


@pytest.mark.parametrize("case", CASES)
def test_suffix_array_plain_matches_jax_and_numpy(case):
    codes = _codes(case)
    want = suffix_array_np(codes)
    got = suffix_array_plain(torch.as_tensor(codes))
    assert got.dtype == torch.int32 and got.shape == (len(codes),)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(suffix_array_jax(codes.astype(np.int32))), want)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        suffix_array(torch.as_tensor(codes)).numpy(), want)


def test_bwt_from_sa_matches_numpy():
    codes = _codes("short_texts")
    sa = suffix_array(torch.as_tensor(codes))
    np.testing.assert_array_equal(
        bwt_from_sa(torch.as_tensor(codes), sa).numpy(),
        bwt_from_sa_np(codes, suffix_array_np(codes)))


def test_rounds_match_numpy_prefix_doubling():
    """One round of each step against the numpy round of suffix_array_np:
    the stable order by (rank, second) and the new ranks."""
    codes = _codes("random").astype(np.int64)
    n, k = len(codes), 4
    rank = torch.as_tensor(codes.astype(np.int32))
    keys, order = sort_round(rank, k, int(codes.max()))
    second = np.full(n, -1, dtype=np.int64)
    second[:n - k] = codes[k:]
    want_order = np.lexsort((second, codes))
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(keys.numpy() >> 32, codes[want_order])
    top = rank_round(keys, order, rank)
    kf, ks = codes[want_order], second[want_order]
    new = np.concatenate([[0], np.cumsum((kf[1:] != kf[:-1])
                                         | (ks[1:] != ks[:-1]))])
    want_rank = np.empty(n, dtype=np.int64)
    want_rank[want_order] = new
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    assert top == new[-1]


def _packed_keys(rank: torch.Tensor, k: int) -> torch.Tensor:
    n = rank.shape[0]
    second = torch.zeros(n, dtype=torch.int64)
    if k < n:
        second[:n - k] = rank[k:].to(torch.int64) + 1
    return (rank.to(torch.int64) << 32) | second


def _check_round_from_prev(rank, k, top, prev):
    """second_order_plain(prev, k), then a stable sort by rank alone, is
    sort_round_plain's (keys, order) exactly; and sort_round_plain
    ignores prev_order.  -> that (keys, order)."""
    keys, order = sort_round_plain(rank, k, top)
    derived = second_order_plain(prev, k)
    assert derived.dtype == torch.int32
    by_rank = derived[torch.sort(rank[derived.long()], stable=True).indices]
    assert torch.equal(by_rank, order), k
    assert torch.equal(_packed_keys(rank, k)[by_rank.long()], keys), k
    again = sort_round_plain(rank, k, top, prev)
    assert torch.equal(again[0], keys) and torch.equal(again[1], order)
    return keys, order


@pytest.mark.parametrize("case", CASES + ["k>=n"])
def test_rank_sort_of_second_order_is_the_round_sort(case):
    """The invariant the kernel's sort relies on, at every round of the
    prefix doubling: the previous round's order is sorted by the ranks
    the round uses, ties in ascending index, so it gives the stable order
    by second, and a stable sort of that by rank alone is the round's
    sort.  Before the first round the stable order by the codes plays the
    previous order; "k>=n" checks rounds with k >= n, where the derived
    order is the identity."""
    rank = torch.as_tensor(
        _codes("random" if case == "k>=n" else case)).to(torch.int32)
    n = rank.shape[0]
    prev = torch.sort(rank, stable=True).indices.to(torch.int32)
    top = int(rank.max()) if n else 0
    if case == "k>=n":
        for k in (n, n + 5):
            _check_round_from_prev(rank, k, top, prev)
            assert torch.equal(second_order_plain(prev, k),
                               torch.arange(n, dtype=torch.int32))
        return
    k = 1
    while True:
        keys, prev = _check_round_from_prev(rank, k, top, prev)
        if n <= 1:
            break
        top = rank_round_plain(keys, prev, rank)
        if top == n - 1:
            break
        k *= 2


def test_suffix_array_rejects_bad_codes():
    with pytest.raises(ValueError):
        suffix_array(torch.tensor([1, -1, 2]))
    with pytest.raises(ValueError):
        suffix_array(torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("case", ["smem_carry", "async_copy",
                                  "dynamic_store"])
def test_repro_plain_matches_expected(case):
    """The expected arrays of tools/pallas_repro.py (want1, x * 2, x)."""
    x = np.arange(1024, dtype=np.int32)
    want = {"smem_carry": x + np.repeat(np.arange(4), 256),
            "async_copy": x * 2, "dynamic_store": x}[case]
    plain = {"smem_carry": repro.smem_carry_plain,
             "async_copy": repro.async_copy_plain,
             "dynamic_store": repro.dynamic_store_plain}[case]
    np.testing.assert_array_equal(plain(torch.as_tensor(x)).numpy(), want)
    np.testing.assert_array_equal(expected("cpu")[case].numpy(), want)


def test_repro_tool_passes_on_cpu():
    assert run_cases(torch.device("cpu")) == {
        "smem_carry": "PASS", "async_copy": "PASS", "dynamic_store": "PASS"}
