"""The port's row compaction (dsm_tpu_torch/ops/compact.py) against
dsm_tpu's two forms of it.

The Pallas kernel (ops/pallas_compact.compact_rows) has no interpret flag
and no CPU test in the JAX package, so its own plain reference,
`compact_rows_np`, stands in for it; the production JAX form is
`compact_kidx_sort` followed by a row take.  The port's `compact_rows`
on CPU tensors takes the plain PyTorch version.  Tolerance: none, equal
counts and equal first-count rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops.compact import compact_kidx_sort
from dsm_tpu.ops.pallas_compact import compact_rows_np
from dsm_tpu_torch.ops.compact import compact_rows


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
