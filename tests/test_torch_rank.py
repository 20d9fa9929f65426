"""The port's fused rank (dsm_tpu_torch/ops/rank.py) against dsm_tpu's.

The same numpy-made tables and queries go through JAX `occ_cum8T` /
`leftchar_codes_pairsT` (on the CPU backend) and through the port's
`occ_cum8` / `leftchar_codes_pairs` on CPU tensors, which take the plain
PyTorch version.  Tolerance: none, equal int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.engine import EXT4, leftchar_codes_pairsT
from dsm_tpu.ops.rank import BLOCK, LOG2_BLOCK, OccTable, fused_rows, occ_cum8T
from dsm_tpu_torch.mining.engine import DeviceIndexes, leftchar_codes_pairs
from dsm_tpu_torch.ops.rank import occ_cum8, occ_cum8_plain


def _stack(tables):
    """Baked-C4 fused rows of several OccTables, stacked, with offsets."""
    parts, offs, off = [], [], 0
    for t in tables:
        c4 = [int(t.C[c]) for c in EXT4]
        fr = fused_rows(t, c4=c4)
        parts.append(fr)
        offs.append(off)
        off += fr.shape[0]
    return np.concatenate(parts), np.asarray(offs, dtype=np.int32)


def _queries(ns, rng):
    """Every position of every sample (block edges and n included) plus
    random repeats, as (pos, sample)."""
    pos, sid = [], []
    for s, n in enumerate(ns):
        pos.append(np.arange(n + 1))
        sid.append(np.full(n + 1, s))
        pos.append(rng.integers(0, n + 1, size=300))
        sid.append(np.full(300, s))
    return (np.concatenate(pos).astype(np.int32),
            np.concatenate(sid).astype(np.int64))


@pytest.mark.parametrize("lengths", [(1000, 1280, 77), (128, 4096, 383)])
def test_occ_cum8_matches_jax(lengths):
    rng = np.random.default_rng(sum(lengths))
    tables = [OccTable.build(rng.integers(0, 7, size=n).astype(np.int8))
              for n in lengths]
    rows, soff = _stack(tables)
    pos, sid = _queries(lengths, rng)
    blk = (pos >> LOG2_BLOCK) + soff[sid]
    want = np.asarray(occ_cum8T(
        jnp.asarray(np.ascontiguousarray(rows.T)), jnp.asarray(blk),
        jnp.asarray(pos & (BLOCK - 1)), jnp.asarray(pos)))
    rows_t = torch.from_numpy(rows.view(np.int32))
    got = occ_cum8(rows_t, torch.from_numpy(pos),
                   torch.from_numpy(soff[sid]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_occ_cum8_strided_columns():
    """The episode passes pair-row columns (stride 6) straight in."""
    rng = np.random.default_rng(5)
    tables = [OccTable.build(rng.integers(0, 7, size=n).astype(np.int8))
              for n in (700, 300)]
    rows, soff = _stack(tables)
    pos, sid = _queries((700, 300), rng)
    pr = torch.zeros((pos.shape[0], 6), dtype=torch.int32)
    pr[:, 0] = torch.from_numpy(pos)
    pr[:, 4] = torch.from_numpy(soff[sid])
    rows_t = torch.from_numpy(rows.view(np.int32))
    np.testing.assert_array_equal(
        occ_cum8(rows_t, pr[:, 0], pr[:, 4]).numpy(),
        occ_cum8_plain(rows_t, pr[:, 0].contiguous(),
                       pr[:, 4].contiguous()).numpy())


def test_leftchar_codes_pairs_matches_jax():
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    idxs = [FMIndex.from_texts([transform(
        bases[rng.integers(0, 4, size=int(rng.integers(50, 400)))].tobytes())
        for _ in range(4)]) for _ in range(3)]
    dev = DeviceIndexes.build(idxs, "cpu")
    k = 4000
    sid = rng.integers(0, 3, size=k)
    n = dev.ns[sid]
    rlo = (rng.random(k) * (n + 1)).astype(np.int64)
    freq = (rng.random(k) * (n - rlo + 1)).astype(np.int64)
    freq[:50] = 0
    soff = dev.soff.numpy()[sid]
    want = np.asarray(leftchar_codes_pairsT(
        jnp.asarray(np.ascontiguousarray(dev.rrows.numpy().view(np.uint32).T)),
        jnp.asarray(soff), jnp.asarray(rlo.astype(np.int32)),
        jnp.asarray(freq.astype(np.int32))))
    got = leftchar_codes_pairs(dev.rrows, torch.from_numpy(soff),
                               torch.from_numpy(rlo.astype(np.int32)),
                               torch.from_numpy(freq.astype(np.int32)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) >= {0, 1}   # the codes cover '0' and 'N'
