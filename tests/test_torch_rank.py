"""The port's fused rank (dsm_tpu_torch/ops/rank.py) against dsm_tpu's.

The same numpy-made tables, queries and pair rows go through JAX
`occ_cum8T` / `leftchar_codes_pairsT` / the level's expand step (on the
CPU backend) and through the port's `occ_cum8` / `occ_cum8_pair` /
`expand` / `leftchar_codes_pairs` on CPU tensors, which take the plain
PyTorch versions.  Tolerance: none, equal int32 and bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.engine import EXT4, leftchar_codes_pairsT
from dsm_tpu.ops.rank import BLOCK, LOG2_BLOCK, OccTable, fused_rows, occ_cum8T
from dsm_tpu_torch.convert import fmindex_from_jax
from dsm_tpu_torch.mining.engine import DeviceIndexes, leftchar_codes_pairs
from dsm_tpu_torch.ops.rank import (expand, occ_cum8, occ_cum8_pair,
                                    occ_cum8_plain)


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
    dev = DeviceIndexes.build([fmindex_from_jax(i) for i in idxs], "cpu")
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


def _pair_rows(lengths, soff, rng, share):
    """(P, 6) int32 pair rows (the port's PC_* columns) over samples of
    `lengths` whose table rows start at `soff`: every block edge and n as
    lo, and random lo; hi in lo's table row for about `share` of them
    (empty intervals among them), in a later row for the rest, clipped to
    n; a few with hi < lo."""
    los, his, sids = [], [], []
    for s, n in enumerate(lengths):
        edges = np.concatenate([np.arange(0, n + 1, BLOCK), [n]])
        lo = np.concatenate([edges, rng.integers(0, n + 1, size=400)])
        same = rng.random(lo.size) < share
        row_end = np.minimum(n, lo | (BLOCK - 1))
        hi_same = lo + (rng.random(lo.size) * (row_end - lo + 1)).astype(
            np.int64)
        hi_same[::7] = lo[::7]                     # empty intervals
        hi_far = np.minimum(n, (lo & ~(BLOCK - 1)) + BLOCK
                            + rng.integers(0, 3 * BLOCK, size=lo.size))
        hi = np.where(same, hi_same, hi_far)
        hi[-3:] = np.maximum(lo[-3:] - 5, 0)       # hi < lo: no interval
        hi[edges.size - 1] = n                     # [n, n]
        los.append(lo)
        his.append(hi)
        sids.append(np.full(lo.size, s))
    sid = np.concatenate(sids)
    p = sid.size
    pr = np.zeros((p, 6), dtype=np.int32)
    pr[:, 0] = np.concatenate(los)
    pr[:, 1] = np.concatenate(his)
    pr[:, 2] = rng.integers(0, 1000, size=p)
    pr[:, 3] = sid
    pr[:, 4] = soff[sid]
    pr[:, 5] = rng.integers(0, 1000, size=p)
    return pr


def _jax_ranks(rows, lo, hi, soff):
    """dsm_tpu's occ_cum8T at both ends, as its level calls it."""
    rowsT = jnp.asarray(np.ascontiguousarray(rows.T))
    return [np.asarray(occ_cum8T(rowsT, jnp.asarray((p >> LOG2_BLOCK) + soff),
                                 jnp.asarray(p & (BLOCK - 1)),
                                 jnp.asarray(p)))
            for p in (lo, hi)]


@pytest.mark.parametrize("fmin,sym_mask,share", [
    (1, 0b1111, 0.7), (2, 0b1111, 0.0), (5, 0b1111, 1.0), (2, 0, 0.7),
    (1, 0b0100, 0.7), (2, 0b1010, 0.3), (5, 0b0001, 0.7)])
def test_expand_matches_jax(fmin, sym_mask, share):
    """expand on CPU tensors (expand_plain) against dsm_tpu's expand step:
    occ_cum8T at both ends, then pa, cact and keepc as
    dsm_tpu/mining/engine_device.py:714-724 computes them.  Equal."""
    lengths = (1000, 1280, 77, 383)
    rng = np.random.default_rng(fmin * 100 + sym_mask)
    tables = [OccTable.build(rng.integers(0, 7, size=n).astype(np.int8))
              for n in lengths]
    rows, soff = _stack(tables)
    pr = _pair_rows(lengths, soff, rng, share)
    lo, hi, soffp = pr[:, 0], pr[:, 1], pr[:, 4]
    olo_w, ohi_w = _jax_ranks(rows, lo, hi, soffp)
    pa = hi > lo
    cact = pa[None, :] & (ohi_w[:4] - olo_w[:4] >= fmin)
    symv = np.array([(sym_mask >> c) & 1 for c in range(4)], dtype=bool)
    got = expand(torch.from_numpy(rows.view(np.int32)), torch.from_numpy(pr),
                 fmin, sym_mask)
    olo, ohi, freq, keepc, cbits = (t.numpy() for t in got)
    assert (olo.dtype, freq.dtype, keepc.dtype, cbits.dtype) == (
        np.int32, np.int32, np.bool_, np.uint8)
    np.testing.assert_array_equal(olo, olo_w)
    np.testing.assert_array_equal(ohi, ohi_w)
    np.testing.assert_array_equal(freq, np.where(pa, hi - lo, 0))
    np.testing.assert_array_equal(keepc, cact & symv[:, None])
    np.testing.assert_array_equal(
        cbits, (cact * (1 << np.arange(4))[:, None]).sum(axis=0))
    same = ((lo >> LOG2_BLOCK) == (hi >> LOG2_BLOCK)).mean()
    assert (0 < same < 1) if 0 < share < 1 else same > 0
    assert cact.any() and (~pa).any()


def test_occ_cum8_pair_matches_jax():
    """The two-ended entry on strided columns against two occ_cum8T
    calls."""
    lengths = (700, 300, 1025)
    rng = np.random.default_rng(8)
    tables = [OccTable.build(rng.integers(0, 7, size=n).astype(np.int8))
              for n in lengths]
    rows, soff = _stack(tables)
    pr = _pair_rows(lengths, soff, rng, 0.5)
    olo_w, ohi_w = _jax_ranks(rows, pr[:, 0], pr[:, 1], pr[:, 4])
    pt = torch.from_numpy(pr)
    olo, ohi = occ_cum8_pair(torch.from_numpy(rows.view(np.int32)),
                             pt[:, 0], pt[:, 1], pt[:, 4])
    np.testing.assert_array_equal(olo.numpy(), olo_w)
    np.testing.assert_array_equal(ohi.numpy(), ohi_w)
