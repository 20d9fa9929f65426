"""The port's row compaction (dsm_tpu_torch/ops/compact.py) against
dsm_tpu's two forms of it.

The Pallas kernel (ops/pallas_compact.compact_rows) has no interpret flag
and no CPU test in the JAX package, so its own plain reference,
`compact_rows_np`, stands in for it; the production JAX form is
`compact_kidx_sort` followed by a row take.  The port's `compact_rows`
on CPU tensors takes the plain PyTorch version.  Tolerance: none, equal
counts and equal first-count rows.

`stage_rows`, the emit step on the same kernel, is held against the emit
block of dsm_tpu's `_level_single` (mining/engine_device.py `build_stage`):
the (B, 8) `orows` concatenated there, `compact_kidx_sort` and the take,
on the same numpy-seeded pairs.  Exact, columns 0-4 of the live rows; the
port's rows past the count are zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops.compact import compact_kidx_sort
from dsm_tpu.ops.pallas_compact import compact_rows_np
from dsm_tpu_torch.ops.children import (PC_HI, PC_LO, PC_NID, PC_RLO, PC_SID,
                                        PC_SOFF)
from dsm_tpu_torch.ops.compact import compact_rows, stage_rows


def _mask(kind, n, rng):
    if kind == "none":
        return np.zeros(n, dtype=bool)
    if kind == "all":
        return np.ones(n, dtype=bool)
    return rng.random(n) < 0.3


@pytest.mark.parametrize("kind", ["none", "all", "random"])
@pytest.mark.parametrize("c", [1, 5, 8])
@pytest.mark.parametrize("n", [2048, 4096, 3000])
def test_compact_rows_matches_jax(n, c, kind):
    rng = np.random.default_rng(n * 10 + c)
    mask = _mask(kind, n, rng)
    values = rng.integers(-2**31, 2**31, size=(n, c),
                          dtype=np.int64).astype(np.int32)
    width = n
    got, count = compact_rows(torch.from_numpy(mask),
                              torch.from_numpy(values), width)
    k = int(count)
    assert got.shape == (width, c) and got.dtype == torch.int32

    want_np, k_np = compact_rows_np(mask, values, width)
    assert k == k_np
    np.testing.assert_array_equal(got.numpy()[:k], want_np[:k])

    kidx, k_jax = compact_kidx_sort(jnp.asarray(mask), width)
    want_jax = np.asarray(jnp.take(jnp.asarray(values), kidx, axis=0))
    assert k == int(k_jax)
    np.testing.assert_array_equal(got.numpy()[:k], want_jax[:k])


def test_compact_rows_narrow_width():
    """width below the count keeps the first `width` kept rows."""
    rng = np.random.default_rng(3)
    mask = rng.random(3000) < 0.5
    values = np.arange(6000, dtype=np.int32).reshape(3000, 2)
    got, count = compact_rows(torch.from_numpy(mask),
                              torch.from_numpy(values), 100)
    want, k = compact_rows_np(mask, values, 100)
    assert int(count) == k
    np.testing.assert_array_equal(got.numpy(), want)


def _marked(kind, n, rng):
    mask = np.zeros(n, dtype=bool)
    if kind == "one":
        mask[n // 3] = True
    elif kind == "few":
        mask[rng.choice(n, size=7, replace=False)] = True
    elif kind == "all":
        mask[:] = True
    elif kind == "random":
        mask = rng.random(n) < 0.3
    return mask


@pytest.mark.parametrize("width", ["below", "at", "above"])
@pytest.mark.parametrize("kind", ["none", "one", "few", "all", "random"])
def test_stage_rows_matches_jax_emit(kind, width):
    """The port's emit rows against orows + compact_kidx_sort + take."""
    rng = np.random.default_rng(len(kind) * 7 + len(width))
    n, depth = 3000, 13
    lo = rng.integers(0, 2**30, size=n).astype(np.int32)
    hi = (lo + rng.integers(0, 5000, size=n)).astype(np.int32)
    rlo, soff = (rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
                 for _ in range(2))
    sid = rng.integers(0, 512, size=n).astype(np.int32)
    nid = np.sort(rng.integers(0, n, size=n)).astype(np.int32)
    mask = _marked(kind, n, rng)
    k = int(mask.sum())
    w = {"below": k // 2, "at": k, "above": min(n, k + 50)}[width]

    pairs = np.zeros((n, 6), dtype=np.int32)
    for col, a in ((PC_LO, lo), (PC_HI, hi), (PC_RLO, rlo), (PC_SID, sid),
                   (PC_SOFF, soff), (PC_NID, nid)):
        pairs[:, col] = a
    got, count = stage_rows(torch.from_numpy(mask), torch.from_numpy(pairs),
                            depth, w)
    assert got.shape == (w, 5) and got.dtype == torch.int32
    assert int(count) == k

    j = jnp.asarray
    orows = jnp.concatenate(
        [(j(hi) - j(lo))[:, None], j(rlo)[:, None], j(sid)[:, None],
         j(nid)[:, None], jnp.full((n, 1), depth, jnp.int32),
         jnp.zeros((n, 3), jnp.int32)], axis=1)
    kidx, wrote = compact_kidx_sort(j(mask), w)
    want = np.asarray(jnp.take(orows, kidx, axis=0))
    assert int(wrote) == k
    live = min(k, w)
    np.testing.assert_array_equal(got.numpy()[:live], want[:live, :5])
    assert not got.numpy()[live:].any()
