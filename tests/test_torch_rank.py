"""The port's fused rank (dsm_tpu_torch/ops/rank.py) against dsm_tpu's.

The same numpy-made tables, queries and pair rows go through JAX
`occ_cum8T` / `leftchar_codes_pairsT` / the level's expand step (on the
CPU backend) and through the port's `occ_cum8` / `occ_cum8_pair_plain` /
`expand` / `leftchar_codes_pairs` on CPU tensors, which take the plain
PyTorch versions.  The drain's `leftchar_rows` on staged (n, 5) output rows
is held against dsm_tpu's `_jitted_lc_pairs`, and with the rows' samples
split over several shard tables against its one-table codes.  Tolerance:
none, equal int32, int8 and bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.engine import EXT4, leftchar_codes_pairsT
from dsm_tpu.mining.engine_device import _jitted_lc_pairs
from dsm_tpu.ops.rank import BLOCK, LOG2_BLOCK, OccTable, fused_rows, occ_cum8T
from dsm_tpu_torch.convert import fmindex_from_jax
from dsm_tpu_torch.mining.engine import (OC_DEPTH, OC_FREQ, OC_RLO, OC_ROW,
                                         OC_SID, OUT_COLS, DeviceIndexes,
                                         leftchar_codes_pairs, leftchar_rows)
from dsm_tpu_torch.ops.rank import (expand, occ_cum8, occ_cum8_pair_plain,
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
    """The plain rank at both ends (the leftChar's and the expand step's
    reference) on strided columns against two occ_cum8T calls."""
    lengths = (700, 300, 1025)
    rng = np.random.default_rng(8)
    tables = [OccTable.build(rng.integers(0, 7, size=n).astype(np.int8))
              for n in lengths]
    rows, soff = _stack(tables)
    pr = _pair_rows(lengths, soff, rng, 0.5)
    olo_w, ohi_w = _jax_ranks(rows, pr[:, 0], pr[:, 1], pr[:, 4])
    pt = torch.from_numpy(pr)
    olo, ohi = occ_cum8_pair_plain(torch.from_numpy(rows.view(np.int32)),
                                   pt[:, 0], pt[:, 1], pt[:, 4])
    np.testing.assert_array_equal(olo.numpy(), olo_w)
    np.testing.assert_array_equal(ohi.numpy(), ohi_w)


def _random_indexes(rng, samples: int):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [fmindex_from_jax(FMIndex.from_texts([transform(
        bases[rng.integers(0, 4, size=int(rng.integers(50, 400)))].tobytes())
        for _ in range(int(rng.integers(1, 5)))])) for _ in range(samples)]


def _staged_rows(rng, ns, k: int) -> np.ndarray:
    """(k, 5) int32 staged output rows over samples of lengths `ns`: rlo
    and rlo + freq inside the sample's text, every 7th freq 0, node rows
    and depths at random."""
    rows = np.zeros((k, OUT_COLS), dtype=np.int32)
    sid = rng.integers(0, len(ns), size=k)
    n = np.asarray(ns)[sid]
    rlo = (rng.random(k) * (n + 1)).astype(np.int64)
    freq = (rng.random(k) * (n - rlo + 1)).astype(np.int64)
    freq[::7] = 0
    rows[:, OC_FREQ], rows[:, OC_RLO], rows[:, OC_SID] = freq, rlo, sid
    rows[:, OC_ROW] = rng.integers(0, 1 << 20, size=k)
    rows[:, OC_DEPTH] = rng.integers(0, 60, size=k)
    return rows


@pytest.mark.parametrize("samples,k", [(1, 1), (3, 4000), (6, 2500)])
def test_leftchar_rows_matches_jax(samples, k):
    """The drain's leftChar on staged rows (one table, base 0) against
    dsm_tpu's `_jitted_lc_pairs` on the same rows."""
    rng = np.random.default_rng(100 + samples)
    dev = DeviceIndexes.build(_random_indexes(rng, samples), "cpu")
    rows = _staged_rows(rng, dev.ns, k)
    want = np.asarray(_jitted_lc_pairs()(
        jnp.asarray(np.ascontiguousarray(dev.rrows.numpy().view(np.uint32).T)),
        jnp.asarray(dev.soff.numpy()), jnp.asarray(rows[:, OC_SID]),
        jnp.asarray(rows[:, OC_RLO]), jnp.asarray(rows[:, OC_FREQ])))
    got = leftchar_rows([(dev.rrows, dev.soff, 0)], torch.from_numpy(rows))
    assert got.dtype == torch.int8 and got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), want)
    if k > 100:
        assert set(np.unique(want)) >= {0, 1}


@pytest.mark.parametrize("bounds", [(0, 6), (0, 2, 6), (0, 1, 3, 5, 6),
                                    (0, 0, 2, 2, 3, 6, 6)])
def test_leftchar_rows_over_shards_matches_one_table(bounds):
    """The rows' samples split into consecutive shards, each with its own
    tables (local sample ids and row offsets) and its first global sample
    id, empty shards among them: the codes equal the one-table codes of
    the same rows, also when written into a slice of a larger vector."""
    rng = np.random.default_rng(sum(bounds))
    idxs = _random_indexes(rng, 6)
    dev = DeviceIndexes.build(idxs, "cpu")
    empty = np.zeros((0, 32), dtype=np.uint32)
    tables = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        sd = (DeviceIndexes.build(idxs[a:b], "cpu") if b > a else
              DeviceIndexes.from_host([], empty, empty, [], "cpu"))
        tables.append((sd.rrows, sd.soff, a))
    rows = torch.from_numpy(_staged_rows(rng, dev.ns, 3000))
    want = leftchar_rows([(dev.rrows, dev.soff, 0)], rows)
    np.testing.assert_array_equal(leftchar_rows(tables, rows).numpy(),
                                  want.numpy())
    big = torch.full((rows.shape[0] + 9,), -7, dtype=torch.int8)
    out = leftchar_rows(tables, rows, out=big[5:5 + rows.shape[0]])
    assert out.data_ptr() == big[5:].data_ptr()
    np.testing.assert_array_equal(big[5:5 + rows.shape[0]].numpy(),
                                  want.numpy())
    assert (big[:5] == -7).all() and (big[5 + rows.shape[0]:] == -7).all()
