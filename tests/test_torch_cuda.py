"""The port's CUDA kernels and its mining slice on the card.

Every test here needs a GPU (marker `cuda`) and skips without one.  The
file imports no JAX, so it runs where JAX is not installed:

    DSM_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(DSM_TEST_TPU=1 keeps tests/conftest.py from importing jax.)  Each kernel
is held against its plain PyTorch version on the same CUDA tensors, at
edge shapes; the suffix array also against the host numpy one; the
mining run (plain, killed and resumed from its snapshot, and halted) and
the index build on the card against the port's CPU path.
The kernels of the sharded level and drain (the expand over 1, 2 and 128
shard tables, the partial rows, the gates from their sums, the
outside-ids children step, the gather, the leftChar entry over 1, 2 and 7
shard tables) are held against their plain versions
at ragged sizes with empty segments (the gather also with more blocks than
one launch takes, at unaligned slices), a sharded drain must be two
launches at 2 and 7 shards, and a sharded mine (2 and 7 shards on the
card) is held against the single-device one.  Prefix ownership
(`mine_owned`) and the capacity-planned `mine_big` in each of its three
modes mine on the card as the host engine and the single-device episode
do, and so do the four prefix runs over one shared upload (bench.py's
topology for large tries) and a prefix run that pulls its history.
The per-level engines' kernels (K12, the dense expand, and K13, the
analyse-and-compact) are held against their plain versions at every level
of dense mines of 1, 5, 63, 255, 256, 257, 273 and 512 samples over 1 to 3
and 128 tables with 1, 4, 16 and 1,024 prefix rows (an enforced prefix
leaves rows empty; a small first capacity overflows), on random levels at
each of those widths (an empty node tile or chunk beside one that ranks,
an empty row, 1, 2 and 128 tables, 1 and 1,024 rows), on levels with no
valid row or no active cell, and K13 on rows of exactly CAP union flags
and of CAP + 1; the prepared tables (`LevelTables`) give the list's
outputs, and 129 tables are refused before any launch;
`compact_kidx` (K14) and `occ_batch` (K15) against theirs (K15 at every
in-block offset with each symbol, pos = n at a multiple of 128, ragged Q,
a blocks view 4-byte but not 16-byte aligned and a table past the L2);
`mine_sharded` and `mine_torch(reader_order="level-gnu")` on the card (and
`mine_sharded` in a one-rank NCCL group) against the CPU.
Exact, except the f64 entropy of segstats: absolute 1e-9 (the plain
version sums with index_add_, whose order on the card may differ), the
fixed-point entropy sums of the partial rows (each term truncated from a
log that the card's two libraries may round apart: one unit a pair), and
the f64 sums of the pairwise distance matrices: 1e-9 * (1 + |value|) (the
kernel's row slices meet in atomics, in an order of their own).
"""

import glob
import os

import numpy as np
import pytest
import torch

from dsm_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
TOYDATA = os.path.join(HERE, "data", "toydata")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def toy_indexes(cuda):
    from dsm_tpu_torch.index import indexes_from_fasta

    return indexes_from_fasta(sorted(glob.glob(os.path.join(
        TOYDATA, "toy*.fasta.gz"))), cuda)


def test_rank_kernel(cuda, toy_indexes):
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    from dsm_tpu_torch.ops.rank import occ_cum8, occ_cum8_plain

    dev = DeviceIndexes.build(toy_indexes, cuda)
    rng = np.random.default_rng(1)
    sid = rng.integers(0, dev.S, size=100_003)
    pos = (rng.random(sid.size) * (dev.ns[sid] + 1)).astype(np.int32)
    pos[:dev.S], sid[:dev.S] = dev.ns, np.arange(dev.S)
    pr = torch.zeros((sid.size, 6), dtype=torch.int32, device=cuda)
    pr[:, 0] = torch.as_tensor(pos, device=cuda)
    pr[:, 4] = dev.soff[torch.as_tensor(sid, device=cuda)]
    before = _build.LAUNCHES["rank"]
    got = occ_cum8(dev.frows, pr[:, 0], pr[:, 4])       # strided columns
    assert _build.LAUNCHES["rank"] == before + 1
    want = occ_cum8_plain(dev.frows, pr[:, 0], pr[:, 4])
    assert torch.equal(got, want)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert occ_cum8(dev.frows, empty, empty).shape == (8, 0)


def _card_pairs(dev, p, share, rng, cuda):
    """(p, 6) int32 pair rows over the card's tables: lo uniform in each
    sample's text (its end among them), hi in lo's table row for about
    `share` of the pairs (empty intervals among them) and in a later row
    for the rest, clipped to n."""
    sid = rng.integers(0, dev.S, size=p)
    n = dev.ns[sid]
    lo = (rng.random(p) * (n + 1)).astype(np.int64)
    lo[:min(p, dev.S)] = n[:dev.S]
    row_end = np.minimum(n, lo | 127)
    same = rng.random(p) < share
    hi = np.where(same, lo + (rng.random(p) * (row_end - lo + 1)).astype(
        np.int64), np.minimum(n, (lo & ~127) + 128 + rng.integers(
            0, 4000, size=p)))
    pr = np.zeros((p, 6), dtype=np.int32)
    pr[:, 0], pr[:, 1], pr[:, 3] = lo, hi, sid
    pr[:, 2] = rng.integers(0, 1 << 20, size=p)
    pr[:, 5] = rng.integers(0, 1 << 20, size=p)
    pt = torch.as_tensor(pr, device=cuda)
    pt[:, 4] = dev.soff[pt[:, 3].to(torch.int64)]
    return pt


@pytest.mark.parametrize("share", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("p", [0, 1, 7, 4097, (1 << 20) + 3])
def test_expand_kernel(cuda, toy_indexes, p, share):
    """The level's expand step (one launch: both ends, freq, keepc, cbits)
    against expand_plain, with none, ~70% and all of the pairs' two ends
    in one table row, under several fmin and symbol masks."""
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    from dsm_tpu_torch.ops.rank import expand, expand_plain

    dev = DeviceIndexes.build(toy_indexes, cuda)
    pairs = _card_pairs(dev, p, share, np.random.default_rng(p), cuda)
    for fmin, sym_mask in ((1, 0b1111), (2, 0), (5, 0b0110), (2, 0b1000)):
        before = _build.LAUNCHES["rank"]
        got = expand(dev.frows, pairs, fmin, sym_mask)
        assert _build.LAUNCHES["rank"] == before + (p > 0)
        want = expand_plain(dev.frows, pairs, fmin, sym_mask)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (fmin, sym_mask)
    if p > 7:
        same = ((pairs[:, 0] >> 7) == (pairs[:, 1] >> 7)).double().mean()
        assert abs(float(same) - share) < 0.05
    with pytest.raises(ValueError):
        expand(dev.frows, pairs[:, :5], 2, 15)


@pytest.mark.parametrize("tables", [1, 2, 128])
@pytest.mark.parametrize("p", [1, 4097, (1 << 20) + 3])
def test_expand_tables_kernel(cuda, toy_indexes, tables, p):
    """The expand step over a process's shard tables (the sharded level's
    one pair list; 128 tables of 5 samples: 123 empty) against its plain
    version and against the one-table expand on the unsharded tables: one
    launch, counted as `rank`, every output equal."""
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    from dsm_tpu_torch.ops.rank import (expand, expand_tables,
                                        expand_tables_plain)
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    dev = DeviceIndexes.build(toy_indexes, cuda)
    sh = ShardedIndexes.build(toy_indexes, global_samples_mesh(tables, cuda))
    whole = _card_pairs(dev, p, 0.7, np.random.default_rng(p + tables), cuda)
    pairs = whole.clone()
    pairs[:, 4] = sh.local_soff()[pairs[:, 3].to(torch.int64)]
    for fmin, sym_mask in ((1, 0b1111), (5, 0b0110)):
        before = _build.LAUNCHES["rank"]
        got = expand_tables(sh.expand_tables(), pairs, fmin, sym_mask)
        assert _build.LAUNCHES["rank"] == before + 1
        want = expand_tables_plain(sh.expand_tables(), pairs, fmin, sym_mask)
        one = expand(dev.frows, whole, fmin, sym_mask)
        torch.cuda.synchronize()
        for g, w, o in zip(got, want, one):
            assert g.dtype == w.dtype and torch.equal(g, w), (fmin, sym_mask)
            assert torch.equal(g, o)
    with pytest.raises(ValueError):
        expand_tables(sh.expand_tables(), pairs[:, :5], 2, 15)


def _staged_rows(dev, k, rng, cuda):
    """(k, 5) int32 staged output rows over the card's samples (global
    ids, sorted as a packed drain holds them): rlo and rlo + freq inside
    the sample's text, every 9th freq 0."""
    sid = np.sort(rng.integers(0, dev.S, size=k))
    n = dev.ns[sid]
    rlo = (rng.random(k) * (n + 1)).astype(np.int64)
    width = np.where(rng.random(k) < 0.5, 40, n - rlo + 1)
    freq = (rng.random(k) * np.minimum(width, n - rlo + 1)).astype(np.int64)
    freq[::9] = 0
    rows = np.zeros((k, 5), dtype=np.int32)
    rows[:, 0], rows[:, 1], rows[:, 2] = freq, rlo, sid
    rows[:, 3] = rng.integers(0, 1 << 20, size=k)
    rows[:, 4] = rng.integers(0, 80, size=k)
    return torch.as_tensor(rows, device=cuda)


@pytest.mark.parametrize("shards", [1, 2, 7])
@pytest.mark.parametrize("k", [1, 255, 257, 300_007])
def test_leftchar_kernel(cuda, toy_indexes, shards, k):
    """The rank kernel's leftChar entry on staged rows with one table (the
    single-device drain) and with 2 and 7 shard tables (7 of 5 samples:
    two are empty) against its plain version: one launch, counted as
    `rank`; also from rows at a 4-byte offset and into a slice of a larger
    code vector; the shard tables' codes equal the one table's."""
    from dsm_tpu_torch.mining.engine import (DeviceIndexes, leftchar_rows,
                                             leftchar_rows_plain)
    from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    dev = DeviceIndexes.build(toy_indexes, cuda)
    if shards == 1:
        tables = [(dev.rrows, dev.soff, 0)]
    else:
        sh = ShardedIndexes.build(toy_indexes,
                                  global_samples_mesh(shards, cuda))
        tables = [(sd.rrows, sd.soff, sh.base(j))
                  for j, sd in enumerate(sh.shards)]
    rows = _staged_rows(dev, k, np.random.default_rng(k + shards), cuda)
    before = _build.LAUNCHES["rank"]
    got = leftchar_rows(tables, rows)
    assert _build.LAUNCHES["rank"] == before + 1
    want = leftchar_rows_plain(tables, rows)
    one = leftchar_rows_plain([(dev.rrows, dev.soff, 0)], rows)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(want, one)
    # rows 4 bytes off 16-byte alignment, codes into a slice at an odd byte
    flat = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=cuda)
    flat[1:] = rows.reshape(-1)
    off = flat[1:].view(k, 5)
    big = torch.full((k + 3,), -9, dtype=torch.int8, device=cuda)
    leftchar_rows(tables, off, out=big[1:k + 1])
    torch.cuda.synchronize()
    assert torch.equal(big[1:k + 1], want)
    assert int(big[0]) == -9 and (big[k + 1:] == -9).all()
    empty = torch.zeros((0, 5), dtype=torch.int32, device=cuda)
    assert leftchar_rows(tables, empty).shape == (0,)
    with pytest.raises(ValueError):
        leftchar_rows(tables, rows[:, :4])


@pytest.mark.parametrize("shards", [2, 7])
def test_sharded_drain_is_two_launches(cuda, toy_indexes, shards,
                                       monkeypatch):
    """Each drain of a sharded mine (small drains: many levels staged, each
    level's one emit onto the process's one buffer) launches the gather
    kernel once and the rank kernel once (its leftChar entry), whatever
    the shard count."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    drains = []
    drain = tee._drain_sharded
    emits = [_build.LAUNCHES["compact"]]   # at the last drain

    def counted(*a, **k):
        chunks = _build.LAUNCHES["compact"] - emits[0]
        before = dict(_build.LAUNCHES)
        staged = drain(*a, **k)
        drains.append((staged, chunks, {
            key: _build.LAUNCHES[key] - before[key]
            for key in ("gather_pack", "rank")}))
        emits[0] = _build.LAUNCHES["compact"]
        return staged

    monkeypatch.setattr(tee, "_drain_sharded", counted)
    tee.mine_device_sharded(toy_indexes, MiningConfig(fmin=2, emax=1.2),
                            mesh=global_samples_mesh(shards, cuda),
                            reader_order="gnu", out_reserve=64)
    staged = [d for d in drains if d[0]]
    assert len(staged) > 2 and max(c for _s, c, _l in staged) > 1
    assert all(lc == {"gather_pack": 1, "rank": 1} for _s, _c, lc in staged)


@pytest.mark.parametrize("exits", ["default", "drain+histfull"])
def test_mine_rank_launches_one_a_level(cuda, toy_indexes, exits,
                                        monkeypatch):
    """The expand step is one launch a level on the device, and a drain
    with staged rows adds one (its leftChar)."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    kw = {}
    if exits == "drain+histfull":
        kw["out_reserve"] = 0
        monkeypatch.setenv("DSM_HIST_CAP", "20000")
    prof = {}
    _build.reset_launches()
    mine_torch(toy_indexes, MiningConfig(fmin=2, emax=1.2), device=cuda,
               profile=prof, **kw)
    assert prof["drains"] > 0
    assert _build.LAUNCHES["rank"] == prof["levels"] + prof["drains"]


@pytest.mark.parametrize("n,c", [(1, 1), (1023, 5), (1025, 6), (300_001, 8)])
def test_compact_kernel(cuda, n, c):
    from dsm_tpu_torch.ops.compact import compact_rows, compact_rows_plain

    rng = np.random.default_rng(n)
    vals = torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, c),
                                        dtype=np.int64).astype(np.int32),
                           device=cuda)
    for frac in (0.0, 0.3, 1.0):
        mask = torch.as_tensor(rng.random(n) < frac, device=cuda)
        k = int(mask.sum())
        for width in (k, k // 2, n):
            got, gc = compact_rows(mask, vals, width)
            want, wc = compact_rows_plain(mask, vals, width)
            assert int(gc) == int(wc) == k
            assert torch.equal(got, want), (frac, width)


def _garbage(shape, cuda):
    """Fill and free a block of the size of `shape`, so that the next
    torch.empty of that size on the card starts from garbage."""
    g = torch.full(shape, -0x5A5A5A5B, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    del g


@pytest.mark.parametrize("case", [
    "narrow_width", "unaligned_mask", "zeroed_tail", "wide_zeroed_tail",
    "all_false", "all_true", "more_tiles_than_blocks", "mask_bytes_not_one"])
def test_compact_kernel_cases(cuda, case):
    """The one-pass kernel's edges: width below the count (the count is
    still the total), a mask that is a slice starting at an odd byte, the
    tail zeroed by the kernel in an output that held garbage, more tiles
    than the card holds blocks (the look-back across waves), and a mask
    whose set bytes are not 1."""
    from dsm_tpu_torch.ops.compact import (TILE_ROWS, compact_rows,
                                           compact_rows_plain)

    rng = np.random.default_rng(len(case))
    n = {"more_tiles_than_blocks": TILE_ROWS * 3000 + 17,
         "wide_zeroed_tail": 5 * TILE_ROWS + 3}.get(case, 200_003)
    c = 6
    frac = {"all_false": 0.0, "all_true": 1.0, "wide_zeroed_tail": 0.01}.get(
        case, 0.3)
    vals = torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, c),
                                        dtype=np.int64).astype(np.int32),
                           device=cuda)
    if case == "unaligned_mask":
        mask = torch.as_tensor(rng.random(n + 3) < frac, device=cuda)[3:]
        assert mask.data_ptr() % 16 and mask.is_contiguous()
    elif case == "mask_bytes_not_one":
        raw = rng.integers(0, 256, size=n).astype(np.uint8)
        raw[rng.random(n) < 0.6] = 0
        mask = torch.as_tensor(raw, device=cuda).view(torch.bool)
    else:
        mask = torch.as_tensor(rng.random(n) < frac, device=cuda)
    k = int(mask.view(torch.uint8).ne(0).sum())
    width = {"narrow_width": k // 3, "zeroed_tail": k + 1001,
             "wide_zeroed_tail": n, "all_false": 4097}.get(case, k)
    _garbage((width, c), cuda)
    before = _build.LAUNCHES["compact"]
    got, gc = compact_rows(mask, vals, width)
    assert _build.LAUNCHES["compact"] == before + 1
    want, _wc = compact_rows_plain(mask.view(torch.uint8).ne(0), vals, width)
    torch.cuda.synchronize()
    assert int(gc) == k
    assert torch.equal(got, want)


@pytest.mark.parametrize("frac", [0.0, 0.001, 0.3, 1.0])
@pytest.mark.parametrize("p", [1, 4095, 4097, 1_000_003])
def test_stage_rows_kernel(cuda, p, frac):
    """The emit entry against its plain version: width below, at and above
    the count, the last into an output that held garbage."""
    from dsm_tpu_torch.ops.compact import stage_rows, stage_rows_plain

    rng = np.random.default_rng(p)
    pairs = torch.as_tensor(rng.integers(-2**31, 2**31, size=(p, 6),
                                         dtype=np.int64).astype(np.int32),
                            device=cuda)
    mask = torch.as_tensor(rng.random(p) < frac, device=cuda)
    k = int(mask.sum())
    for width in (k, k // 2, k + 77):
        _garbage((width, 5), cuda)
        before = _build.LAUNCHES["compact"]
        got, gc = stage_rows(mask, pairs, 41, width)
        assert _build.LAUNCHES["compact"] == before + 1
        want, wc = stage_rows_plain(mask, pairs, 41, width)
        torch.cuda.synchronize()
        assert int(gc) == int(wc) == k
        assert torch.equal(got, want), width


@pytest.mark.parametrize("row0", [0, 1, 2, 3, 4097])
def test_stage_rows_kernel_into_a_buffer(cuda, row0):
    """The emit entry into a run of rows of a larger buffer that held
    garbage (a shard's staging buffer: 20-byte rows, so any 4-byte
    alignment): the run equals the plain version and the rest of the
    buffer is left as it was."""
    from dsm_tpu_torch.ops.compact import stage_rows, stage_rows_plain

    rng = np.random.default_rng(row0)
    p = 70_001
    pairs = torch.as_tensor(rng.integers(-2**31, 2**31, size=(p, 6),
                                         dtype=np.int64).astype(np.int32),
                            device=cuda)
    mask = torch.as_tensor(rng.random(p) < 0.3, device=cuda)
    k = int(mask.sum())
    buf = torch.as_tensor(rng.integers(-2**31, 2**31, size=(row0 + k + 5, 5),
                                       dtype=np.int64).astype(np.int32),
                          device=cuda)
    keep = buf.clone()
    got, gc = stage_rows(mask, pairs, 9, k, buf[row0:row0 + k])
    want, _wc = stage_rows_plain(mask, pairs, 9, k)
    torch.cuda.synchronize()
    assert int(gc) == k and got.data_ptr() == buf[row0:].data_ptr()
    assert torch.equal(buf[row0:row0 + k], want)
    assert torch.equal(buf[:row0], keep[:row0])
    assert torch.equal(buf[row0 + k:], keep[row0 + k:])


def test_segstats_kernel(cuda):
    from dsm_tpu_torch.ops.segstats import Gates, segstats, segstats_plain

    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 6, size=50_000)
    nb = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)])
                         .astype(np.int32), device=cuda)
    p = int(sizes.sum())
    freq = rng.integers(0, 500, size=p).astype(np.int32)
    # frequencies past the kernel's table of terms
    big = rng.random(p) < 0.05
    freq[big] = rng.integers(4096, 1 << 24, size=int(big.sum()))
    freq[rng.random(p) < 0.2] = 0
    cact = (rng.integers(0, 16, size=p) * (freq > 0)).astype(np.uint8)
    f_t = torch.as_tensor(freq, device=cuda)
    c_t = torch.as_tensor(cact, device=cuda)
    # on the default stream and on a side stream (a ticket each)
    for stream in (torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda)):
        for depth, sym in ((0, 15), (5, 15), (9, 4)):
            g = Gates(depth=depth, s_total=5, mindepth=2, pmin=2, pmax=4,
                      use_egate=True, sym_mask=sym, emin_lo=0.1, emax_hi=1.5)
            with torch.cuda.stream(stream):
                fk, ek, pk, sk = segstats(nb, f_t, c_t, g)
            stream.synchronize()
            fp, ep, pp, sp = segstats_plain(nb, f_t, c_t, g)
            assert torch.equal(fk, fp) and torch.equal(pk, pp)
            assert float((ek - ep).abs().max()) < 1e-9
            _assert_sums(sk, sp)


def _assert_sums(got, want):
    """The level's sums: the four counts equal, the entropy range within
    1e-9 (the plain version's index_add_ sums a node's terms in the order
    of the card's atomics)."""
    from dsm_tpu_torch.ops.segstats import S_ENT_MIN

    g, w = got.tolist(), want.tolist()
    assert g[:S_ENT_MIN] == w[:S_ENT_MIN]
    for a, b in zip(g[S_ENT_MIN:], w[S_ENT_MIN:]):
        assert a == b or abs(a - b) < 1e-9, (g, w)


@pytest.mark.parametrize("lo,hi", [(1, 5), (1, 64), (1, 273), (64, 273),
                                   (0, 5)])
def test_segstats_kernel_widths(cuda, lo, hi):
    """The stats step at nodes of 1..5, 1..64 and 1..273 pairs (about 1M
    pairs; the wider nodes are reduced by a warp each), nodes of 64..273
    alone, and nodes without a pair among them: one launch, flags,
    pair_out and the counts equal, the entropy and its range within 1e-9,
    under the full symbol mask, one symbol and none."""
    from dsm_tpu_torch.ops.segstats import Gates, segstats, segstats_plain

    rng = np.random.default_rng(hi * 7 + lo)
    sizes = rng.integers(lo, hi + 1, size=(1 << 21) // (lo + hi))
    nb = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)])
                         .astype(np.int32), device=cuda)
    p = int(sizes.sum())
    freq = rng.integers(0, 3000, size=p).astype(np.int32)
    freq[rng.random(p) < 0.1] = 0
    cact = (rng.integers(0, 16, size=p) * (freq > 0)).astype(np.uint8)
    f_t = torch.as_tensor(freq, device=cuda)
    c_t = torch.as_tensor(cact, device=cuda)
    for sym in (0b1111, 0b0010, 0):
        g = Gates(depth=7, s_total=max(hi, 5), mindepth=0, pmin=2, pmax=0,
                  use_egate=True, sym_mask=sym, emin_lo=-0.01,
                  emax_hi=float(np.log2(hi + 1)) - 0.5)
        before = _build.LAUNCHES["segstats"]
        fk, ek, pk, sk = segstats(nb, f_t, c_t, g)
        assert _build.LAUNCHES["segstats"] == before + 1
        fp, ep, pp, sp = segstats_plain(nb, f_t, c_t, g)
        torch.cuda.synchronize()
        assert torch.equal(fk, fp) and torch.equal(pk, pp), sym
        assert float((ek - ep).abs().max()) < 1e-9
        _assert_sums(sk, sp)
        assert sk[2] > 0 or sym == 0


def _history(rng, widths):
    """Random parent pointers, level k >= 1 holding widths[k] nodes ->
    (hist, lvl_off) int32 numpy."""
    parts, offs, off = [], [], 0
    for k in range(1, len(widths)):
        parent = rng.integers(0, widths[k - 1], size=widths[k])
        parts.append((parent * 4 + rng.integers(0, 4, size=widths[k]))
                     .astype(np.int32))
        offs.append(off)
        off += widths[k]
    return (np.concatenate(parts) if parts else np.zeros(1, np.int32),
            np.asarray(offs, dtype=np.int32))


def _trie_history(rng, levels, width):
    """A trie-shaped history: each node has 0-4 children (1 on average),
    numbered in (parent, symbol) order -> (hist, lvl_off, widths)."""
    widths, parts, offs, off = [width], [], [], 0
    for _ in range(levels):
        kids = rng.choice(5, size=widths[-1], p=[0.5, 0.2, 0.15, 0.1, 0.05])
        kids[0] = max(kids[0], 1)
        parent = np.repeat(np.arange(widths[-1]), kids)
        within = np.arange(parent.size) - (np.cumsum(kids) - kids)[parent]
        shift = (rng.random(widths[-1]) * (5 - kids)).astype(np.int64)
        parts.append((parent * 4 + within + shift[parent]).astype(np.int32))
        offs.append(off)
        off += parent.size
        widths.append(parent.size)
    return np.concatenate(parts), np.asarray(offs, dtype=np.int32), widths


@pytest.mark.parametrize("case", ["m=0", "one_row", "jrel=0", "mixed",
                                  "deep", "random_maxj1", "random_maxj48",
                                  "random_maxj96", "trie_maxj1",
                                  "trie_maxj48", "trie_maxj96",
                                  "trie_maxj130"])
def test_decode_kernel(cuda, case):
    """The decode kernel against its plain version: random and trie-shaped
    histories (rows in (level, row) order, every row at the top for the
    trie cases), m not a multiple of the kernel's tile, maxj of 1, 48, 96
    and 130 (above what the kernel stages at once: two windows)."""
    from dsm_tpu_torch.ops.decode import decode, decode_plain

    kind, _, levels = case.partition("_maxj")
    if kind == "trie":
        rng = np.random.default_rng(int(levels))
        hist, offs, widths = _trie_history(rng, int(levels), 20_000)
    else:
        widths = {"m=0": [3, 5, 7], "one_row": [2, 9, 4], "jrel=0": [40, 8],
                  "mixed": [5] + [3000] * 12, "deep": [7] + [200] * 90,
                  "random": [7] + [5000] * int(levels or 1)}[kind]
    m = {"m=0": 0, "one_row": 1, "jrel=0": 500, "mixed": 100_003,
         "deep": 4097, "random": 70_001, "trie": 20_003}[kind]
    if kind != "trie":
        rng = np.random.default_rng(len(widths) + m)
        hist, offs = _history(rng, widths)
    top = len(widths) - 1
    jrel = (np.zeros(m, dtype=np.int32) if case == "jrel=0"
            else rng.integers(0, top + 1, size=m).astype(np.int32))
    if case == "one_row":
        jrel[:] = top
    if kind == "trie":
        jrel[m // 2:] = top
    rows = np.array([rng.integers(0, widths[j]) for j in jrel],
                    dtype=np.int32)
    if kind == "trie":
        order = np.lexsort((rows, jrel))
        rows, jrel = rows[order], jrel[order]
    maxj = top if case == "m=0" else int(jrel.max())
    args = [torch.as_tensor(a, device=cuda) for a in (hist, offs, rows, jrel)]
    before = _build.LAUNCHES["decode"]
    base, syms = decode(*args, maxj)
    assert _build.LAUNCHES["decode"] == before + (m > 0)
    pbase, psyms = decode_plain(*args, maxj)
    torch.cuda.synchronize()
    assert base.shape == (m,) and syms.shape == (m, maxj)
    assert torch.equal(base, pbase) and torch.equal(syms, psyms)


def _children_layout(rng, sizes, frac, sym_mask):
    U = len(sizes)
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(nb[-1])
    node = np.repeat(np.arange(U), sizes)
    pairs = rng.integers(-2**31, 2**31, size=(P, 6)).astype(np.int32)
    pairs[:, 5] = node
    olo = rng.integers(-2**31, 2**31 - 5000, size=(8, P))
    ohi = olo + rng.integers(0, 5000, size=(8, P))
    keep = rng.random((4, P)) < frac
    keep &= (((sym_mask >> np.arange(4)) & 1) > 0)[:, None]
    return nb, pairs, olo.astype(np.int32), ohi.astype(np.int32), keep


def _with_gaps(rng, sizes, share):
    """`sizes` with a share of the nodes holding no pair."""
    sizes = np.array(sizes)
    sizes[rng.random(sizes.size) < share] = 0
    return sizes


@pytest.mark.parametrize("case", ["U=1", "node_512", "nothing_kept",
                                  "all_kept", "restricted", "no_pairs",
                                  "wide", "d64", "d273", "d273_all_kept",
                                  "nodes_of_512", "nodes_without_pairs",
                                  "d273_nothing_kept", "long_gap",
                                  "tile_multiple"])
def test_children_kernel(cuda, case):
    """Among the cases: nodes of up to 64, 273 and 512 pairs (a tile of
    1024 pair positions then holds up to 1535 pairs, and with every lane
    kept its rows take several staging rounds), nodes that hold no pair
    (alone, in a run longer than a block, and at the end), nothing kept at
    all, and a pair count that is a multiple of the tile."""
    from dsm_tpu_torch.ops.children import (TILE_PAIRS, children,
                                            children_plain)

    rng = np.random.default_rng(len(case))
    sizes = {"U=1": [3], "node_512": [2, 512, 1, 5], "no_pairs": [0, 0],
             "wide": rng.integers(1, 6, size=300_001),
             "d64": rng.integers(1, 65, size=40_000),
             "d273": rng.integers(1, 274, size=10_000),
             "d273_all_kept": rng.integers(1, 274, size=3000),
             "d273_nothing_kept": _with_gaps(
                 rng, rng.integers(1, 274, size=3000), 0.2),
             "nodes_of_512": [512] * 37 + [0, 0, 511, 1, 512, 0],
             "nodes_without_pairs": _with_gaps(
                 rng, rng.integers(1, 6, size=50_000), 0.4),
             "long_gap": [3] + [0] * 5000 + [2] + [0] * 700,
             "tile_multiple": [4] * (TILE_PAIRS // 2) + [0, 0]}.get(
                 case, rng.integers(1, 6, size=5000))
    frac = {"nothing_kept": 0.0, "d273_nothing_kept": 0.0, "all_kept": 1.0,
            "d273_all_kept": 1.0}.get(case, 0.3)
    sym_mask = 0b0010 if case == "restricted" else 0b1111
    layout = _children_layout(rng, np.asarray(sizes), frac, sym_mask)
    nb, pairs, olo, ohi, keep = (torch.as_tensor(a, device=cuda)
                                 for a in layout)
    pair_count = int(keep.sum())
    node = pairs[:, 5].to(torch.int64)
    c = torch.arange(4, device=cuda)[:, None]
    child_total = int(torch.unique((node * 4 + c)[keep]).numel())
    got_hist = torch.full((child_total + 5,), -7, dtype=torch.int32,
                          device=cuda)
    want_hist = got_hist.clone()
    before = _build.LAUNCHES["children"]
    got = children(nb, pairs, olo, ohi, keep, pair_count, child_total,
                   got_hist)
    assert _build.LAUNCHES["children"] == before + 1
    want = children_plain(nb, pairs, olo, ohi, keep, pair_count,
                          child_total, want_hist)
    torch.cuda.synchronize()
    assert got[0].shape == (pair_count, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got_hist, want_hist)


def _sharded_level(rng, S, U, n):
    """A node-sorted pair list over S samples (nodes of 0..S pairs) and its
    split into n sample shards: [(nb, freq, cbits, own)]."""
    member = rng.random((U, S)) < rng.choice([0.0, 0.3, 0.9], size=(U, 1))
    nid, sid = np.nonzero(member)
    P = nid.shape[0]
    freq = rng.integers(0, 3000, size=P).astype(np.int32)
    freq[rng.random(P) < 0.15] = 0
    cbits = (rng.integers(0, 16, size=P) * (freq > 0)).astype(np.uint8)
    shards = []
    for k in range(n):
        own = (sid >= k * S // n) & (sid < (k + 1) * S // n)
        nb = np.concatenate([[0], np.cumsum(np.bincount(
            nid[own], minlength=U))]).astype(np.int32)
        shards.append((nb, freq[own], cbits[own], own))
    return nid.astype(np.int32), sid.astype(np.int32), shards


def _shardstats_inputs(rng, S, U, n, device):
    """A level of `_sharded_level` on the card: the whole list's (nb, freq,
    cbits) (one process holding the n shards) and each shard's."""
    nid, _sid, shards = _sharded_level(rng, S, U, n)
    P = nid.shape[0]
    freq, cbits = np.zeros(P, dtype=np.int32), np.zeros(P, dtype=np.uint8)
    for _nb, f, c, own in shards:
        freq[own], cbits[own] = f, c
    nb = np.concatenate([[0], np.cumsum(np.bincount(nid, minlength=U))])
    whole = [torch.as_tensor(a, device=device)
             for a in (nb.astype(np.int32), freq, cbits)]
    return whole, [[torch.as_tensor(a, device=device) for a in sh[:3]]
                   for sh in shards]


def _partials_checked(whole, parts_of, sym_mask, device):
    """K9a on the whole list, one launch, against its plain version (the
    fixed-point column within one unit a pair) and against the shards'
    plain rows added up (exact but that column); -> (the rows, the plain
    rows, vals with the kept slot written)."""
    from dsm_tpu_torch.ops.shardstats import (PART_COLS, V_KEPT, kept_slot,
                                              level_values, shard_partials,
                                              shard_partials_plain)

    nb, freq, cbits = whole
    U = nb.shape[0] - 1
    part = torch.empty((U, PART_COLS), dtype=torch.int64, device=device)
    vals = level_values(device)
    before = _build.LAUNCHES["shard_partials"]
    shard_partials(nb, freq, cbits, sym_mask, part, kept_slot(vals))
    assert _build.LAUNCHES["shard_partials"] == before + 1
    want, kept = shard_partials_plain(nb, freq, cbits, sym_mask)
    added = sum(shard_partials_plain(*a, sym_mask)[0] for a in parts_of)
    torch.cuda.synchronize()
    assert torch.equal(part[:, [0, 2]], want[:, [0, 2]])
    assert torch.equal(want, added)
    width = (nb[1:] - nb[:-1]).to(torch.int64)
    assert bool(((part[:, 1] - want[:, 1]).abs() <= width).all())
    assert float(vals[V_KEPT]) == float(kept)
    return part, want, vals


def _gates_equal(got, want, got_vals, want_vals, got_hist, want_hist):
    """node_gates against its plain version: every output equal but the
    entropy and its range (within 1e-9: the card's log and torch's)."""
    from dsm_tpu_torch.ops.shardstats import V_ENT_MAX, V_ENT_MIN

    assert torch.equal(got[0], want[0])
    assert float((got[1] - want[1]).abs().max()) < 1e-9
    assert torch.equal(got[2], want[2])
    assert torch.equal(got_hist, want_hist)
    assert torch.equal(got[3], want[3])
    gv, wv = got_vals.tolist(), want_vals.tolist()
    for i, (a, b) in enumerate(zip(gv, wv)):
        if i in (V_ENT_MIN, V_ENT_MAX) and a != b:
            assert abs(a - b) < 1e-9, (i, a, b)
        else:
            assert a == b, (i, a, b)


@pytest.mark.parametrize("S,U,n", [(5, 1, 1), (5, 257, 2), (5, 5000, 7),
                                   (64, 3000, 5), (512, 300, 3),
                                   (5, 300_001, 2), (64, 20_000, 2),
                                   (273, 5000, 2)])
def test_shardstats_kernels(cuda, S, U, n):
    """K9a and K9b against their plain versions in every output: rows,
    kept lanes, flags, entropy, kid0, history (also with a room below the
    children), pair_out and the level's values; one launch a call.  U =
    257, 5000 and 300,001 are no multiple of a tile; nodes of S = 273 and
    512 samples are wider than a warp's threshold."""
    from dsm_tpu_torch.ops.segstats import Gates
    from dsm_tpu_torch.ops.shardstats import node_gates, node_gates_plain

    rng = np.random.default_rng(S * U + n)
    whole, parts_of = _shardstats_inputs(rng, S, U, n, cuda)
    nb, P, ocount = whole[0], whole[1].shape[0], int(rng.integers(0, 1000))
    for depth, sym_mask, room in ((0, 0b1111, 4 * U), (6, 0b1111, 4 * U),
                                  (6, 0b0100, 4 * U), (6, 0b1111, U // 3)):
        part, plain, vals = _partials_checked(whole, parts_of, sym_mask,
                                              cuda)
        want_vals = vals.clone()
        g = Gates(depth=depth, s_total=S, mindepth=2, pmin=2, pmax=0,
                  use_egate=True, sym_mask=sym_mask, emin_lo=0.2,
                  emax_hi=1.6)
        got_hist = torch.full((room,), -7, dtype=torch.int32, device=cuda)
        want_hist = got_hist.clone()
        before = _build.LAUNCHES["node_gates"]
        got = node_gates(part, g, got_hist, nb, P, ocount, vals)
        assert _build.LAUNCHES["node_gates"] == before + 1
        want = node_gates_plain(part, g, want_hist, nb, P, ocount, want_vals)
        torch.cuda.synchronize()
        _gates_equal(got, want, vals, want_vals, got_hist, want_hist)


@pytest.mark.parametrize("S,U,n", [(5, 257, 2), (64, 3000, 5),
                                   (512, 300, 3), (273, 5000, 128),
                                   (64, 20_000, 128)])
def test_shardstats_one_row_a_node(cuda, S, U, n):
    """The sharded episode's form: the pairs of n shards a process (up to
    128: more shards than samples, empty ones) in one list, K9a once over
    it, on both of its shapes, gives the shards' rows added, and K9b on
    that one row a node (summed again over two processes, as the
    all-reduce sums them) equals its plain version."""
    from dsm_tpu_torch.ops.segstats import Gates
    from dsm_tpu_torch.ops.shardstats import node_gates, node_gates_plain

    rng = np.random.default_rng(S * U + n + 1)
    whole, parts_of = _shardstats_inputs(rng, S, U, n, cuda)
    g = Gates(depth=6, s_total=2 * S, mindepth=2, pmin=2, pmax=0,
              use_egate=True, sym_mask=0b1111, emin_lo=0.2, emax_hi=1.6)
    part, _plain, vals = _partials_checked(whole, parts_of, g.sym_mask, cuda)
    part = 2 * part
    want_vals = vals.clone()
    nb, P = whole[0], whole[1].shape[0]
    got_hist = torch.full((4 * U,), -7, dtype=torch.int32, device=cuda)
    want_hist = got_hist.clone()
    got = node_gates(part, g, got_hist, nb, P, 17, vals)
    want = node_gates_plain(part, g, want_hist, nb, P, 17, want_vals)
    torch.cuda.synchronize()
    _gates_equal(got, want, vals, want_vals, got_hist, want_hist)


def test_node_gates_on_two_streams(cuda):
    """Two K9b launches on two streams of one device, twice over (the
    second round on the state the first left): each its own values."""
    from dsm_tpu_torch.ops.segstats import Gates
    from dsm_tpu_torch.ops.shardstats import node_gates, node_gates_plain

    rng = np.random.default_rng(77)
    g = Gates(depth=6, s_total=5, mindepth=2, pmin=2, pmax=0,
              use_egate=True, sym_mask=0b1111, emin_lo=0.2, emax_hi=1.6)
    cases = []
    for U, n in ((300_001, 2), (70_000, 3)):
        whole, parts_of = _shardstats_inputs(rng, 5, U, n, cuda)
        part, _plain, vals = _partials_checked(whole, parts_of, g.sym_mask,
                                               cuda)
        nb, P = whole[0], whole[1].shape[0]
        want_hist = torch.full((4 * U,), -7, dtype=torch.int32, device=cuda)
        want_vals = vals.clone()
        want = node_gates_plain(part, g, want_hist, nb, P, 5, want_vals)
        cases.append((part, vals, nb, P, want, want_vals, want_hist))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    for _round in range(2):
        got = []
        for st, (part, vals, nb, P, *_w) in zip(streams, cases):
            with torch.cuda.stream(st):
                hist = torch.full((part.shape[0] * 4,), -7,
                                  dtype=torch.int32, device=cuda)
                v = vals.clone()
                got.append((node_gates(part, g, hist, nb, P, 5, v), v, hist))
        torch.cuda.synchronize()
        for (out, v, hist), (*_c, want, want_vals, want_hist) in \
                zip(got, cases):
            _gates_equal(out, want, v, want_vals, hist, want_hist)


@pytest.mark.parametrize("S,U,n", [(5, 1, 1), (5, 257, 2), (5, 5000, 7),
                                   (512, 300, 3), (5, 300_001, 2),
                                   (64, 20_000, 3), (273, 5000, 2),
                                   (273, 3000, 5)])
def test_children_ids_kernel(cuda, S, U, n):
    from dsm_tpu_torch.ops.children import children_ids, children_ids_plain

    rng = np.random.default_rng(S + U + n)
    nid, sid, shards = _sharded_level(rng, S, U, n)
    P = nid.shape[0]
    keep = rng.random((4, P)) < 0.35
    ex = np.zeros((U, 4), dtype=np.int64)
    c, p = np.nonzero(keep)
    ex[nid[p], c] = 1
    flags = torch.as_tensor(((ex << np.arange(4)).sum(1) << 4 | 5).astype(
        np.int32), device=cuda)
    kid0 = torch.as_tensor((np.cumsum(ex.sum(1)) - ex.sum(1)).astype(
        np.int32), device=cuda)
    child_total = int(ex.sum())
    rows = 0
    for nb, _freq, _cbits, own in shards:
        m = int(own.sum())
        pairs = rng.integers(-2**31, 2**31, size=(m, 6)).astype(np.int32)
        pairs[:, 5], pairs[:, 3] = nid[own], sid[own]
        olo = rng.integers(-2**31, 2**31 - 5000, size=(8, m))
        ohi = olo + rng.integers(0, 5000, size=(8, m))
        kp = np.ascontiguousarray(keep[:, own])
        args = [torch.as_tensor(a, device=cuda) for a in (
            nb, pairs, olo.astype(np.int32), ohi.astype(np.int32), kp)]
        before = _build.LAUNCHES["children_ids"]
        got = children_ids(*args, flags, kid0, int(kp.sum()), child_total)
        assert _build.LAUNCHES["children_ids"] == before + 1
        want = children_ids_plain(*args, flags, kid0, int(kp.sum()),
                                  child_total)
        torch.cuda.synchronize()
        assert got[1].shape == (child_total + 1,)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        rows += got[0].shape[0]
    assert rows == int(keep.sum())


@pytest.mark.parametrize("sizes", [[1], [4, 0, 7], [0, 0, 3, 0],
                                   [100_003, 0, 1, 65_536, 257]])
def test_gather_pack_kernel(cuda, sizes):
    from dsm_tpu_torch.ops.gatherpack import gather_pack, gather_pack_plain

    rng = np.random.default_rng(sum(sizes))
    for C, sid_col, with_lc in ((5, 2, True), (6, 3, False)):
        blocks = [torch.as_tensor(rng.integers(-10**6, 10**6, size=(m, C))
                                  .astype(np.int32), device=cuda)
                  for m in sizes]
        lcs = [torch.as_tensor(rng.integers(0, 6, size=m).astype(np.int8),
                               device=cuda) for m in sizes] \
            if with_lc else None
        bases = [int(b) for b in rng.integers(0, 500, size=len(sizes))]
        before = _build.LAUNCHES["gather_pack"]
        got = gather_pack(blocks, bases, sid_col, lcs)
        assert _build.LAUNCHES["gather_pack"] == before + 1
        want = gather_pack_plain(blocks, bases, sid_col, lcs)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert (got[1] is None and want[1] is None) \
            or torch.equal(got[1], want[1])


@pytest.mark.parametrize("C,sid_col,with_lc", [(5, 2, True), (6, 3, False)])
def test_gather_pack_kernel_many_blocks_at_offsets(cuda, C, sid_col, with_lc):
    """More blocks than one launch's table holds (so a launch a group of
    MAX_BLOCKS), a third of them empty, each a slice of one tensor at any
    4-byte offset and its codes at any byte, some past one tile of rows:
    equal to the plain version, and the source left as it was."""
    from dsm_tpu_torch.ops.gatherpack import (MAX_BLOCKS, gather_pack,
                                              gather_pack_plain)

    rng = np.random.default_rng(77 + C)
    nblk = 2 * MAX_BLOCKS + 37
    sizes = rng.integers(0, 40, size=nblk) * (rng.random(nblk) > 1 / 3)
    sizes[::97] = rng.integers(1000, 5000, size=sizes[::97].shape[0])
    flat = torch.as_tensor(rng.integers(
        -2**31, 2**31, size=int(sizes.sum()) * C + 4 * nblk,
        dtype=np.int64).astype(np.int32), device=cuda)
    flat_lc = torch.as_tensor(rng.integers(0, 6, size=flat.shape[0])
                              .astype(np.int8), device=cuda)
    keep = flat.clone()
    blocks, lcs, w = [], [], 0
    for m in sizes.tolist():
        w += int(rng.integers(0, 4))
        blocks.append(flat[w:w + m * C].view(m, C))
        lcs.append(flat_lc[w + 1:w + 1 + m])
        w += m * C
    bases = [int(b) for b in rng.integers(0, 2**20, size=nblk)]
    args = (blocks, bases, sid_col, lcs if with_lc else None)
    before = _build.LAUNCHES["gather_pack"]
    got = gather_pack(*args)
    groups = -(-int((sizes > 0).sum()) // MAX_BLOCKS)
    assert groups >= 2 and _build.LAUNCHES["gather_pack"] == before + groups
    want = gather_pack_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert (got[1] is None and want[1] is None) \
        or torch.equal(got[1], want[1])
    assert torch.equal(flat, keep)


@pytest.mark.parametrize("shards", [2, 7])
@pytest.mark.parametrize("order", ["ascending", "gnu"])
def test_sharded_mine_on_card_equals_single_device(cuda, toy_indexes, shards,
                                                   order, tmp_path):
    """The sharded episode on the card (7 shards of 5 samples: two are
    empty) against the single-device one, with small drains and a
    snapshot file: lines and counters equal, every kernel of its path
    launched."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    cfg = MiningConfig(fmin=2, emax=1.2)
    ck = str(tmp_path / "card.ckpt")
    _build.reset_launches()
    got = mine_device_sharded(
        toy_indexes, cfg, mesh=global_samples_mesh(shards, cuda),
        reader_order=order, out_reserve=16, checkpoint=ck)
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine_sharded"])
    assert _build.LAUNCHES["segstats"] == _build.LAUNCHES["children"] == 0
    assert not os.path.exists(ck)
    want = mine_torch(toy_indexes, cfg, device=cuda, reader_order=order)
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)
    assert abs(got.smallest_entropy - want.smallest_entropy) < 1e-5


@pytest.mark.parametrize("hosts,depth", [(2, None), (3, 2)])
def test_mine_owned_on_card_equals_cpu(cuda, toy_indexes, hosts, depth):
    """Prefix ownership on the card: every host's merged runs against the
    host engine's, lines and counters; the hosts' merge is the full mine
    (its paths counted once more for each run under a prefix's depth-1
    node, as dsm_tpu counts them)."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch
    from dsm_tpu_torch.parallel.multihost import merge_outputs, mine_owned

    cfg = MiningConfig(fmin=2, emax=1.2)
    parts = []
    for host in range(hosts):
        _build.reset_launches()
        got = mine_owned(toy_indexes, cfg, hosts, host, depth, device=cuda)
        assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine"])
        want = mine_owned(toy_indexes, cfg, hosts, host, depth,
                          engine="numpy")
        assert got.format_lines() == want.format_lines()
        assert (got.total_paths, got.total_output, got.total_occs) == \
            (want.total_paths, want.total_output, want.total_occs)
        parts.append(got)
    merged = merge_outputs(parts, len(toy_indexes))
    full = mine_torch(toy_indexes, cfg, device=cuda)
    assert merged.format_lines() == full.format_lines()
    assert merged.total_paths == full.total_paths + (12 if depth else 0)


@pytest.mark.parametrize("mode", ["device", "shard", "host"])
def test_mine_big_on_card(cuda, toy_indexes, mode):
    """`mine_big` routed to each mode by its budget: the lines of the
    single-device episode on the card, the card's launches where the plan
    put the mine there, none where it put it on the host."""
    from dsm_tpu_torch.mining import bigindex as big
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    eb, tb = big.episode_bytes(toy_indexes, 2), big.table_bytes(toy_indexes)
    budget = {"device": None, "shard": tb // 2 + eb + 4096,
              "host": eb + 1024}[mode]
    p = big.plan(toy_indexes, budget, devices_available=4, fmin=2,
                 device=cuda)
    assert p.mode == mode
    _build.reset_launches()
    got = big.mine_big(toy_indexes, cfg, budget=budget, devices_available=4,
                       device=cuda)
    path = {"device": "mine", "shard": "mine_sharded", "host": None}[mode]
    if path:
        assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS[path])
    else:
        assert sum(_build.LAUNCHES.values()) == 0
    want = mine_torch(toy_indexes, cfg, device=cuda)
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths


def test_checkpoint_resume_on_card_equals_cpu(cuda, toy_indexes, tmp_path,
                                              monkeypatch):
    """Killed after its second snapshot and resumed, on the card; the
    snapshot history pull included (small DSM_HIST_CAP)."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    monkeypatch.setenv("DSM_HIST_CAP", "20000")
    kw = dict(out_reserve=0, tail_width=0)
    ck = str(tmp_path / "card.ckpt")
    save = ckpt.save_checkpoint
    saves = []

    def killing(*a, **k):
        save(*a, **k)
        saves.append(1)
        if len(saves) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save_checkpoint", killing)
    with pytest.raises(KeyboardInterrupt):
        mine_torch(toy_indexes, cfg, device=cuda, checkpoint=ck, **kw)
    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    _build.reset_launches()
    got = mine_torch(toy_indexes, cfg, device=cuda, checkpoint=ck, **kw)
    assert _build.LAUNCHES["decode"] > 0 and _build.LAUNCHES["children"] > 0
    assert not os.path.exists(ck)
    want = mine_torch(toy_indexes, cfg, device="cpu", **kw)
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)


def test_halt_on_card_equals_cpu(cuda, toy_indexes):
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    runs = []
    for device in (cuda, "cpu"):
        depths = []
        out = mine_torch(toy_indexes, cfg, device=device, out_reserve=1,
                         halt=lambda d, o: depths.append(d) or [b"A", b"GT"])
        runs.append((out.format_lines(), out.total_paths, depths))
    assert runs[0] == runs[1] and runs[0][2]


@pytest.mark.parametrize("exits", ["default", "drain+histfull"])
def test_mine_on_card_equals_cpu(cuda, toy_indexes, exits, monkeypatch):
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    kw = {}
    if exits == "drain+histfull":
        kw["out_reserve"] = 0
        monkeypatch.setenv("DSM_HIST_CAP", "20000")
    _build.reset_launches()
    got = mine_torch(toy_indexes, cfg, device=cuda, **kw)
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine"])
    want = mine_torch(toy_indexes, cfg, device="cpu", **kw)
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)
    assert abs(got.smallest_entropy - want.smallest_entropy) < 1e-9


@pytest.mark.parametrize("order", ["ascending", "gnu"])
def test_shared_upload_prefixes_on_card_equal_cpu(cuda, toy_indexes, order):
    """The JAX package's topology for large tries on the card: one run an
    enforced prefix over ONE upload, each equal to the CPU's run of the
    prefix (lines and counters), A run again after the others equal to
    its first run."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    dev = DeviceIndexes.build(toy_indexes, cuda)
    runs = []
    for p in (b"A", b"C", b"G", b"T", b"A"):
        _build.reset_launches()
        got = mine_torch(toy_indexes, cfg, prefix=p, dev=dev, device=cuda,
                         reader_order=order)
        assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine"])
        want = mine_torch(toy_indexes, cfg, prefix=p, device="cpu",
                          reader_order=order)
        assert got.format_lines() == want.format_lines()
        assert (got.total_paths, got.total_output, got.total_occs) == \
            (want.total_paths, want.total_output, want.total_occs)
        runs.append(got.format_lines())
    assert runs[4] == runs[0]


def test_histfull_prefix_on_card_equals_cpu(cuda, toy_indexes, monkeypatch):
    """A prefix run on the card that takes HISTFULL exits and decodes its
    paths across the pulled segments, against the CPU's."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    monkeypatch.setenv("DSM_HIST_CAP", "20000")
    prof = {}
    got = mine_torch(toy_indexes, cfg, prefix=b"A", device=cuda,
                     reader_order="gnu", profile=prof)
    assert prof["histfull"] >= 2 and prof["pulled_levels"] > 0
    want = mine_torch(toy_indexes, cfg, prefix=b"A", device="cpu",
                      reader_order="gnu")
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)


def _sa_codes(case):
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fasta import read_fasta
    from dsm_tpu_torch.index.fmindex import collection_codes
    from dsm_tpu_torch.ops.sa import RANK_BLOCK, SORT_TILE

    rng = np.random.default_rng(11)
    sizes = {"n=2": 2, "tile": SORT_TILE,
             "tile-1": 3 * SORT_TILE - 1, "tile+1": 3 * SORT_TILE + 1,
             "many_tiles": 1 << 22,    # more tiles than SMs: look-back
             "rank_block-1": 5 * RANK_BLOCK - 1,
             "rank_block+1": 5 * RANK_BLOCK + 1}
    if case in sizes:
        return rng.integers(0, 6, size=sizes[case]).astype(np.int8)
    if case.startswith("rank_bits="):  # the first round's ranks: exactly b bits
        b = int(case.split("=")[1])
        codes = rng.integers(0, 1 << b, size=30_000).astype(np.int32)
        codes[17] = (1 << b) - 1
        return codes
    if case == "all_equal":
        return np.full(20_000, 2, dtype=np.int8)
    if case == "wide_key":     # 17 + 17 bits from the second round on
        return rng.integers(1, 5, size=100_000).astype(np.int8)
    if case == "wide_codes":   # 30 + 31 bits in the first round
        return rng.integers(0, 1 << 30, size=50_000).astype(np.int64)
    name, direction = case.split(":")
    texts = [transform(r.seq) for r in read_fasta(
        os.path.join(TOYDATA, name + ".fasta.gz"))]
    codes, rcodes, _lengths, _max = collection_codes(texts)
    return codes if direction == "fwd" else rcodes


@pytest.mark.parametrize("case", [
    "n=2", "tile", "tile-1", "tile+1", "many_tiles", "rank_block-1",
    "rank_block+1", "all_equal", "wide_key", "wide_codes", "rank_bits=8",
    "rank_bits=16", "rank_bits=24"] + [f"toy{i}:{d}" for i in range(5)
                                       for d in ("fwd", "rev")])
def test_sa_kernel(cuda, case):
    from dsm_tpu_torch.ops.sa import (suffix_array, suffix_array_np,
                                      suffix_array_plain)

    codes = _sa_codes(case)
    codes_t = torch.as_tensor(codes, device=cuda)
    before = _build.LAUNCHES["sa_sort"]
    got = suffix_array(codes_t)
    assert _build.LAUNCHES["sa_sort"] > before
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device == codes_t.device
    assert torch.equal(got, suffix_array_plain(codes_t))
    np.testing.assert_array_equal(got.cpu().numpy(), suffix_array_np(codes))


@pytest.mark.parametrize("top", [39_999, (1 << 8) - 1, (1 << 16) - 1,
                                 (1 << 24) - 1])
def test_sa_round_kernels(cuda, top):
    """One round's sort and rank update against their plain versions: the
    same keys, the same stable order, the same new ranks; each k sorted
    from scratch and from a previous order (the stable order by rank)."""
    from dsm_tpu_torch.ops.sa import (SORT_TILE, rank_round, rank_round_plain,
                                      sort_round, sort_round_plain)

    rng = np.random.default_rng(5)
    n = 300_001
    rank = torch.as_tensor(rng.integers(0, top + 1, size=n).astype(np.int32),
                           device=cuda)
    rank[7] = top
    prev = torch.sort(rank, stable=True).indices.to(torch.int32)
    for k in (1, 4, SORT_TILE + 3, n - 1, n, n + 1):
        pkeys, porder = sort_round_plain(rank, k, top)
        for given in (None, prev):
            keys, order = sort_round(rank, k, top, given)
            assert torch.equal(keys, pkeys) and torch.equal(order, porder), \
                (k, given is None)
        r1, r2 = rank.clone(), rank.clone()
        assert rank_round(keys, order, r1) == \
            rank_round_plain(pkeys, porder, r2)
        assert torch.equal(r1, r2)


@pytest.mark.parametrize("extra", [[], ["--buffer-symbols", "20000"]])
def test_build_on_card_equals_cpu(cuda, tmp_path, extra):
    from dsm_tpu_torch.cli.main import main

    fa = os.path.join(TOYDATA, "toy1.fasta.gz")
    _build.reset_launches()
    assert main(["build", *extra, "-o", str(tmp_path / "gpu"), fa]) == 0
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["build"])
    assert main(["build", *extra, "--device", "cpu", "-o",
                 str(tmp_path / "cpu"), fa]) == 0
    with np.load(tmp_path / "gpu.dsmi") as g, \
            np.load(tmp_path / "cpu.dsmi") as c:
        assert sorted(g.files) == sorted(c.files)
        for k in c.files:
            np.testing.assert_array_equal(g[k], c[k], err_msg=k)


@pytest.mark.parametrize("n", [256, 1024, 4096, (1 << 20) + 256])
def test_repro_kernels(cuda, n):
    from dsm_tpu_torch.ops import repro

    x = torch.as_tensor(np.random.default_rng(n).integers(
        -2**20, 2**20, size=n).astype(np.int32), device=cuda)
    x[0] = 3     # dynamic_store's offset is x[0] * 0
    for fn, plain, key in (
            (repro.smem_carry, repro.smem_carry_plain, "repro_carry"),
            (repro.async_copy, repro.async_copy_plain, "repro_async"),
            (repro.dynamic_store, repro.dynamic_store_plain,
             "repro_dynstore")):
        before = _build.LAUNCHES[key]
        got = fn(x)
        assert _build.LAUNCHES[key] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, plain(x)), key


@pytest.mark.parametrize("n", [1, 3, 256, (1 << 20) + 5])
@pytest.mark.parametrize("skip", [0, 1, 2, 3])
def test_dynamic_store_kernel(cuda, n, skip):
    """P4's 16-byte copy on views that start 0-3 words past a 16-byte
    boundary (x[skip:]), so that the aligned body, the joined body and the
    scalar head and tail all run."""
    from dsm_tpu_torch.ops import repro

    x = torch.as_tensor(np.random.default_rng(n).integers(
        -2**30, 2**30, size=n + skip).astype(np.int32), device=cuda)
    x[skip] = 3
    v = x[skip:]
    assert v.data_ptr() % 16 == 4 * skip
    before = _build.LAUNCHES["repro_dynstore"]
    got = repro.dynamic_store(v)
    assert _build.LAUNCHES["repro_dynstore"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, repro.dynamic_store_plain(v))
    assert torch.equal(got, v)


def test_repro_tool_on_card(cuda):
    from dsm_tpu_torch.tools.pallas_repro import run_cases

    assert set(run_cases(cuda).values()) == {"PASS"}


@pytest.mark.parametrize("rows,d,nbins,scaled,data", [
    (5000, 5, 21, False, "pareto"),     # one pair tile, most of it idle
    (4097, 64, 21, False, "pareto"),    # rows not a multiple of the staged 32
    (700, 273, 30, False, "pareto"),    # ragged last tile, more bins
    (31, 17, 1, False, "pareto"),       # fewer rows than one staging step
    (3000, 40, 4, True, "pareto"),      # normalising factors: lgamma left zero
    (0, 8, 3, False, "pareto"),
    (9000, 12, 1000, False, "pareto"),  # more bins than rows in a sort block
    (6000, 64, 21, False, "duplicated"),  # Q_j + Q_k - 2G cancels to 0
    (6000, 64, 21, False, "near"),      # ... and to one row's difference
    (20000, 64, 21, False, "sparse"),   # 3% of the entries nonzero
    (3000, 16, 4, False, "table_edge"),  # pair sums 2,044-2,052, dense rows
    (257, 512, 5, False, "pareto"),     # MAX_SAMPLES: 136 pair tiles
], ids=["d5", "d64", "d273", "tiny", "normalised", "no_rows", "many_bins",
        "duplicated", "near_duplicate", "density3", "table_edge", "d512"])
def test_pairwise_matrices_kernel_matches_plain(cuda, rows, d, nbins, scaled,
                                                data):
    """K11 against its plain version on the card and NumPy's on the host;
    bins 1 and nbins-1 hold no row; one row's frequencies are past the
    kernel's lgamma table; F as int32 and as int64.  Duplicated columns
    (3 = 9 = 40) come out within 1e-9 of 0 in log and sqrt."""
    from dsm_tpu_torch.ops.distance import (pairwise_matrices,
                                            pairwise_matrices_plain)
    from dsm_tpu_torch.post.distance import pairwise_matrices as oracle

    rng = np.random.default_rng(rows + d)
    density = 0.03 if data == "sparse" else 0.3
    F_np = (np.minimum(rng.pareto(1.1, size=(rows, d)) * 4 + 1, 2e6)
            * (rng.random((rows, d)) < density)).astype(np.int64)
    if data == "table_edge":
        F_np = rng.integers(1022, 1027, size=(rows, d))
    if rows:
        F_np[rows // 2] = rng.integers(1500, 5000, size=d)
    if data in ("duplicated", "near"):
        F_np[:, 9] = F_np[:, 40] = F_np[:, 3]
    if data == "near":
        F_np[rows // 3, 9] = F_np[rows // 3, 3] + 5
    bins_np = rng.integers(0, nbins, size=rows)
    bins_np[(bins_np == 1) | (bins_np == nbins - 1)] = 0
    nf_np = 1.0 / rng.uniform(500, 4000, size=d) if scaled else None
    nf = None if nf_np is None else torch.as_tensor(nf_np, device=cuda)
    bins = torch.as_tensor(bins_np, device=cuda)
    want_np = oracle(F_np, nbins, bins_np, nf_np)
    if scaled:
        want_np["lgamma"][:] = 0.0
    before = _build.LAUNCHES["distance"]
    for dtype in (torch.int32, torch.int64):
        F = torch.as_tensor(F_np, device=cuda).to(dtype)
        got = pairwise_matrices(F, nbins, bins, nf)
        want = pairwise_matrices_plain(F, nbins, bins, nf)
        torch.cuda.synchronize()
        assert torch.equal(got["count"], want["count"])
        assert np.array_equal(got["count"].cpu().numpy(), want_np["count"])
        for kind in ("log", "sqrt", "lgamma"):
            g = got[kind].cpu().numpy()
            wants = [want[kind].cpu().numpy(), want_np[kind]]
            if data == "table_edge" and kind != "lgamma":
                # NumPy's form, s2_j + s2_k - 2 cross, cancels here past the
                # tolerance itself (its sqrt further than 1e-9 of its size
                # from the direct differences): the plain version holds it
                wants = wants[:1]
            for w in wants:
                assert (np.abs(g - w) <= 1e-9 * (1 + np.abs(w))).all(), kind
            if data == "duplicated" and kind != "lgamma":
                for j, k in ((3, 9), (3, 40), (9, 40)):
                    assert np.abs(g[:, j, k]).max() <= 1e-9, kind
    launched = _build.LAUNCHES["distance"] - before
    assert launched == (2 if rows else 0)


def test_pairwise_matrices_rejects_what_the_kernel_does_not_take(cuda):
    from dsm_tpu_torch.ops.distance import pairwise_matrices

    F = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    bins = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pairwise_matrices(F.to(torch.float32), 2, bins)
    with pytest.raises(ValueError):
        pairwise_matrices(F.T, 2, bins[:3])
    with pytest.raises(ValueError):
        pairwise_matrices(F, 2, bins.cpu())
    with pytest.raises(ValueError):
        pairwise_matrices(F, 2, bins, torch.ones(3, device=cuda))


def test_distance_accumulator_on_the_card(cuda, toy_indexes):
    """Mined toydata lines through the accumulator: exact on the host
    against exact=False through the kernel."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch
    from dsm_tpu_torch.post.distance import (DistanceAccumulator,
                                             entropy_steps)

    out = mine_torch(toy_indexes, MiningConfig(fmin=2, emax=1.2), device=cuda)
    lines = out.format_lines().decode().splitlines()
    assert lines
    kw = dict(smpls=5, maxents=entropy_steps(0.05))
    exact = DistanceAccumulator(**kw)
    fast = DistanceAccumulator(exact=False, device=cuda, chunk_rows=7, **kw)
    exact.add_lines(lines)
    before = _build.LAUNCHES["distance"]
    fast.add_lines(lines)
    got, want = fast.matrices(), exact.matrices()
    assert _build.LAUNCHES["distance"] - before == -(-len(lines) // 7)
    assert np.array_equal(got["count"], want["count"])
    assert np.array_equal(got["noutput"], want["noutput"])
    for kind in ("log", "sqrt", "lgamma"):
        np.testing.assert_allclose(got[kind], want[kind], rtol=1e-9,
                                   atol=1e-9)


# the sample axis: tests/test_torch_samples.py's tiny pools (d -> maxdepth,
# the most shards) mined on the card against the port's CPU path
POOLS = {64: (None, 64), 273: (8, 128), 512: (5, 128)}


def _pool(d: int):
    """d samples of 3 texts of 60 bases from one 400-base genome, the
    port's FMIndex built on the CPU, and the mining config of width d."""
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fmindex import FMIndex
    from dsm_tpu_torch.mining.config import MiningConfig

    rng = np.random.default_rng(d)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=400)]
    idxs = [FMIndex.from_texts([transform(
        genome[int(rng.integers(0, 340)):][:60].tobytes()) for _ in range(3)],
        device="cpu") for _ in range(d)]
    maxdepth = POOLS[d][0]
    kw = {} if maxdepth is None else dict(maxdepth=maxdepth)
    return idxs, MiningConfig(fmin=2, emax=99, **kw)


@pytest.mark.parametrize("order", ["ascending", "gnu"])
@pytest.mark.parametrize("d", sorted(POOLS))
def test_many_samples_on_card_equal_cpu(cuda, d, order):
    """d = 64, 273 and 512 samples on one device and at 64 / 128 shards on
    the card (nodes of up to 512 pairs in K2, K3, K9a-c), with small
    drains: lines and counters equal the CPU path's, the expand, K9a, K9b
    and K9c launched once a level and the leftChar once a drain."""
    from dsm_tpu_torch.mining.engine import mine_torch
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    idxs, cfg = _pool(d)
    want = mine_torch(idxs, cfg, device="cpu", reader_order=order)
    assert want.total_output > 0
    _build.reset_launches()
    one = mine_torch(idxs, cfg, device=cuda, reader_order=order,
                     out_reserve=64)
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine"])
    shards, prof = POOLS[d][1], {}
    _build.reset_launches()
    many = mine_device_sharded(idxs, cfg, reader_order=order, out_reserve=64,
                               mesh=global_samples_mesh(shards, cuda),
                               profile=prof)
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine_sharded"])
    assert prof["histfull"] == 0
    for key in ("shard_partials", "node_gates", "children_ids"):
        assert _build.LAUNCHES[key] == prof["levels"], key
    assert _build.LAUNCHES["rank"] == prof["levels"] + prof["drains"]
    for got in (one, many):
        assert got.format_lines() == want.format_lines()
        assert (got.total_paths, got.total_output, got.total_occs) == \
            (want.total_paths, want.total_output, want.total_occs)
        assert np.array_equal(got.freq_histogram, want.freq_histogram)
        assert abs(got.smallest_entropy - want.smallest_entropy) < 1e-5
        assert abs(got.largest_entropy - want.largest_entropy) < 1e-5


def test_128_shard_drain_is_two_launches(cuda, monkeypatch):
    """A drain over 128 shards of 273 samples (K5's shard table at
    MAX_SHARDS, rows of more than 100 samples in one drain): one gather
    and one leftChar launch, the packed rows and their codes equal the
    plain versions'."""
    from dsm_tpu_torch.mining.engine import OC_SID, leftchar_rows_plain
    from dsm_tpu_torch.ops.gatherpack import gather_pack_plain
    from dsm_tpu_torch.parallel import engine_episode as tee
    from dsm_tpu_torch.parallel.multihost import global_samples_mesh

    idxs, cfg = _pool(273)
    drains, drain = [], tee._drain_sharded

    def counted(*a, **k):
        st, dev = a[3], a[6]
        staged_rows = st.out[:st.ocount].clone() if st.ocount else None
        before = dict(_build.LAUNCHES)
        staged = drain(*a, **k)
        if staged:
            rows = gather_pack_plain([staged_rows], [dev.base(0)], OC_SID)[0]
            codes = leftchar_rows_plain(dev.leftchar_tables(), rows)
            drains.append((len(set(rows[:, OC_SID].tolist())), rows, codes, {
                key: _build.LAUNCHES[key] - before[key]
                for key in ("gather_pack", "rank")}))
        return staged

    kept = []
    orig = tee.leftchar_rows

    def keeping(tables, rows, out=None):
        codes = orig(tables, rows, out)
        kept.append((rows.clone(), codes.clone()))
        return codes

    monkeypatch.setattr(tee, "_drain_sharded", counted)
    monkeypatch.setattr(tee, "leftchar_rows", keeping)
    tee.mine_device_sharded(idxs, cfg, mesh=global_samples_mesh(128, cuda),
                            reader_order="gnu", out_reserve=64)
    assert drains and max(n for n, *_ in drains) > 100
    assert all(lc == {"gather_pack": 1, "rank": 1} for *_, lc in drains)
    for (_n, rows, codes, _lc), (got_rows, got_codes) in zip(drains, kept):
        assert torch.equal(got_rows, rows)
        assert torch.equal(got_codes, codes)


# ------------------------------------- the per-level engines (K12-K15) --

def _level_tables(idxs, parts, device):
    """The samples in `parts` consecutive tables -> (tables, ns)."""
    from dsm_tpu_torch.mining.engine import DeviceIndexes

    bounds = [k * len(idxs) // parts for k in range(parts + 1)]
    tables = []
    for k in range(parts):
        dev = DeviceIndexes.build(idxs[bounds[k]:bounds[k + 1]], device)
        tables.append((dev.frows, dev.rrows, dev.soff, bounds[k]))
    return tables, np.array([i.n for i in idxs])


def _walk_levels(tables, ns, rows, prefix, fmin, maxdepth, cap, device):
    """The dense level loop with K12 and K13 on the card, each held against
    its plain version on the same inputs at every level (every output, the
    rows past the count included); -> (levels, regrows)."""
    from dsm_tpu_torch.mining.engine import (MIN_CAP, _next_pow2, _resize,
                                             _seed_state)
    from dsm_tpu_torch.ops import level as L
    from dsm_tpu_torch.parallel.mesh import row_prefix_masks

    masks = row_prefix_masks(rows)
    R = masks.shape[0]
    state = _seed_state(ns, R, cap, device)
    depth = levels = regrows = 0
    while True:
        mask = np.zeros((R, 4), bool) if depth >= maxdepth else \
            np.ones((R, 4), bool)
        if depth < min(masks.shape[1], maxdepth):
            mask &= masks[:, depth]
        if depth < min(len(prefix), maxdepth):
            mask &= np.eye(4, dtype=bool)[b"ACGT".index(prefix[depth])]
        sm = torch.from_numpy(mask).to(device)
        e0, c0 = _build.LAUNCHES["level_expand"], _build.LAUNCHES[
            "level_compact"]
        core = L.expand_level(tables, *state, fmin)
        res = L.compact_level(core, core["sums"], sm)
        assert (_build.LAUNCHES["level_expand"] - e0,
                _build.LAUNCHES["level_compact"] - c0) == (1, 1)
        want = L.expand_level_plain(tables, *state, fmin)
        for k in ("clo", "chi", "crlo", "cactive", "freq", "lc", "sums"):
            assert torch.equal(core[k], want[k]), (depth, k)
        exp = L.compact_level_plain(want, want["sums"], sm)
        for k in exp:
            assert torch.equal(res[k], exp[k]), (depth, k)
        levels += 1
        counts = res["child_count"].tolist()
        cap_now, cmax = state[0].shape[1], max(counts)
        if cmax > cap_now:
            regrows += 1
            state = _resize(state, _next_pow2(cmax))
            continue
        if cmax == 0:
            return levels, regrows
        state = (res["lo"], res["hi"], res["rlo"], res["valid"])
        want_cap = max(MIN_CAP, _next_pow2(cmax))
        if want_cap < cap_now:
            state = _resize(state, want_cap)
        depth += 1


def _samples(toy_indexes, S: int) -> list:
    """S samples: the toydata's (S <= 5), else the first S of a pool."""
    return toy_indexes[:S] if S <= 5 else _pool(273 if S <= 273 else
                                                 512)[0][:S]


@pytest.mark.parametrize("S,parts,rows,prefix,maxdepth,cap", [
    (1, 1, 1, b"", 12, 1024), (5, 1, 1, b"", 12, 2),
    (5, 2, 4, b"A", 10, 16), (5, 3, 16, b"", 8, 1024),
    (273, 2, 4, b"", 5, 64), (512, 3, 16, b"G", 4, 1024),
    (512, 1, 1, b"", 3, 1024),
    (5, 1, 1024, b"", 7, 2), (63, 1, 1, b"", 5, 1024),
    (255, 2, 4, b"", 4, 64), (256, 128, 1, b"", 4, 1024),
    (257, 2, 16, b"C", 4, 1024), (273, 128, 4, b"", 4, 1024),
    (512, 128, 1, b"", 3, 1024)])
def test_level_kernels(cuda, toy_indexes, S, parts, rows, prefix, maxdepth,
                       cap):
    """K12 and K13 at every level of a dense mine: S = 1 and 5 (toydata),
    63, 255, 256, 257, 273 and 512 (pools: node tiles of 4, 1 and 1 nodes,
    past 256 a node a block in 32-sample chunks), R = 1, 4, 16 and 1,024
    prefix rows (rows that hold nothing: the enforced prefix empties three
    of four), 1-3 and 128 tables, and a first capacity that overflows."""
    idxs = _samples(toy_indexes, S)
    tables, ns = _level_tables(idxs, parts, cuda)
    levels, regrows = _walk_levels(tables, ns, rows, prefix, 2, maxdepth,
                                   cap, cuda)
    assert levels > 2
    if cap < 64:
        assert regrows > 0


@pytest.mark.parametrize("S", [5, 257, 512])
def test_level_kernels_all_inactive(cuda, toy_indexes, S):
    """A level with no valid row and one whose cells are all empty, in node
    tiles (S = 5) and in a node's 32-sample chunks (257, 512): the kernels
    write dsm_tpu's zeros, the codes 0 and no child."""
    from dsm_tpu_torch.ops import level as L

    tables, ns = _level_tables(_samples(toy_indexes, S), 2, cuda)
    R, CAP = 4, 3000 if S == 5 else 40
    g = torch.Generator(device="cpu").manual_seed(3)
    lo = torch.randint(0, int(ns.min()) - 5, (R, CAP, S), generator=g,
                       dtype=torch.int32).to(cuda)
    for valid, hi in ((torch.zeros((R, CAP), dtype=torch.bool, device=cuda),
                       lo + 5),
                      (torch.ones((R, CAP), dtype=torch.bool, device=cuda),
                       lo.clone())):
        rlo = lo.clone()
        core = L.expand_level(tables, lo, hi, rlo, valid, 1)
        want = L.expand_level_plain(tables, lo, hi, rlo, valid, 1)
        for k in ("clo", "chi", "crlo", "cactive", "freq", "lc", "sums"):
            assert torch.equal(core[k], want[k]), k
        assert not core["cactive"].any() and not core["sums"].any()
        sm = torch.ones((R, 4), dtype=torch.bool, device=cuda)
        res = L.compact_level(core, core["sums"], sm)
        exp = L.compact_level_plain(want, want["sums"], sm)
        for k in exp:
            assert torch.equal(res[k], exp[k]), k
        assert res["child_count"].tolist() == [0] * R


def _synthetic_level(ns, R: int, CAP: int, S: int, seed: int, device):
    """A random dense state over samples of text lengths `ns`: ~40% of the
    cells empty, the rest narrow or wide intervals and reverse starts that
    fit their sample, ~85% of the nodes valid.  The first block's node tile
    of row 0 is all empty (kCells // S nodes, or one node); at S > 256 the
    next node's samples past 256 too (empty chunks beside ones that rank);
    the last row (R > 1) is empty and invalid, as an empty prefix row."""
    rng = np.random.default_rng(seed)
    n = np.asarray(ns, dtype=np.int64)[None, None, :]
    shape = (R, CAP, S)
    wide = rng.random(shape) < 0.5
    w = np.where(rng.random(shape) < 0.4, 0, np.where(
        wide, (rng.random(shape) * (n + 1)).astype(np.int64),
        rng.integers(1, 9, size=shape))).clip(0, n)
    lo = (rng.random(shape) * (n - w + 1)).astype(np.int64)
    rlo = (rng.random(shape) * (n - w + 1)).astype(np.int64)
    hi = lo + w
    valid = rng.random((R, CAP)) < 0.85
    tile = max(1, 256 // S)
    hi[0, :tile] = lo[0, :tile]
    if S > 256 and CAP > tile:
        hi[0, tile, 256:] = lo[0, tile, 256:]
    if R > 1:
        hi[-1] = lo[-1]
        valid[-1] = False
    as32 = [torch.as_tensor(a.astype(np.int32), device=device)
            for a in (lo, hi, rlo)]
    return (*as32, torch.as_tensor(valid, device=device))


def _level_kernels_equal(tables, state, sym_mask, label):
    """K12 and K13 (one launch each) against their plain versions: every
    output, the rows past the count included; -> K13's outputs."""
    from dsm_tpu_torch.ops import level as L

    e0, c0 = _build.LAUNCHES["level_expand"], _build.LAUNCHES[
        "level_compact"]
    core = L.expand_level(tables, *state, 2)
    res = L.compact_level(core, core["sums"], sym_mask)
    assert (_build.LAUNCHES["level_expand"] - e0,
            _build.LAUNCHES["level_compact"] - c0) == (1, 1)
    want = L.expand_level_plain(tables, *state, 2)
    for k in ("clo", "chi", "crlo", "cactive", "freq", "lc", "sums"):
        assert torch.equal(core[k], want[k]), (label, k)
    exp = L.compact_level_plain(want, want["sums"], sym_mask)
    for k in exp:
        assert torch.equal(res[k], exp[k]), (label, k)
    return res


@pytest.mark.parametrize("parts", [1, 2, 128])
@pytest.mark.parametrize("S", [1, 5, 63, 255, 256, 257, 273, 512])
def test_level_kernels_synthetic(cuda, toy_indexes, S, parts):
    """K12 and K13 on random dense levels at every node-tile shape (a tile
    of 256 // S whole nodes; past 256 a node a block in 32-sample chunks)
    and every row start's alignment to 16 bytes (S = 63, 255, 257, 273),
    with an empty tile beside tiles that rank, empty chunks beside ones
    that rank, an empty prefix row, 1, 2 and 128 tables (tables with no
    sample among them where S < 128), R = 1 and R = MAX_ROWS at a small
    capacity."""
    from dsm_tpu_torch.ops import level as L

    idxs = _samples(toy_indexes, S)
    tables, ns = _level_tables(idxs, min(parts, S), cuda)
    if parts > S:        # tables that hold no sample, bases repeated
        tables += [tables[-1][:3] + (S,)] * (parts - S)
    for R, CAP in ((1, 700 if S <= 5 else 9), (L.MAX_ROWS, 3)):
        state = _synthetic_level(ns, R, CAP, S, seed=S * R + parts,
                                 device=cuda)
        g = np.random.default_rng(R + S)
        sm = torch.as_tensor(g.random((R, 4)) < 0.8, device=cuda)
        _level_kernels_equal(tables, state, sm, (S, parts, R))


@pytest.mark.parametrize("S", [1, 5, 256, 257, 512])
@pytest.mark.parametrize("R", [1, 4, 1024])
def test_level_compact_at_the_capacity(cuda, R, S):
    """K13 on sums whose rows have exactly CAP union flags, CAP + 1 (the
    level overflows), none, and a random number below CAP (the unset flags
    past the count, over several flag tiles), against its plain version;
    its running state is left zero for the next launch."""
    from dsm_tpu_torch.ops import level as L

    CAP = 3000 if R == 1 else (1100 if R == 4 else 5)
    rng = np.random.default_rng(R * 1000 + S)
    flags = np.zeros((R, CAP * 4), dtype=bool)
    want_counts = [CAP, CAP + 1, 0, int(rng.integers(1, CAP))] * R
    for r in range(R):
        flags[r, rng.permutation(CAP * 4)[:want_counts[r]]] = True
    cc = flags.reshape(R, CAP, 4) * rng.integers(1, 7, size=(R, CAP, 4))
    na = np.where(rng.random((R, CAP)) < 0.5, cc.max(axis=2), 9)
    sums = torch.as_tensor(np.concatenate([na[..., None], cc], axis=2)
                           .astype(np.int32), device=cuda)
    shape4 = (R, CAP, 4, S)
    g = torch.Generator(device=cuda).manual_seed(R + S)
    core = {k: torch.randint(-2**31, 2**31 - 1, shape4, generator=g,
                             device=cuda, dtype=torch.int32)
            for k in ("clo", "chi", "crlo")}
    core["cactive"] = torch.rand(shape4, generator=g, device=cuda) < 0.6
    sm = torch.ones((R, 4), dtype=torch.bool, device=cuda)
    for _ in range(2):                  # the second finds the state zero
        res = L.compact_level(core, sums, sm)
        exp = L.compact_level_plain(core, sums, sm)
        for k in exp:
            assert torch.equal(res[k], exp[k]), k
    assert res["child_count"].tolist() == want_counts[:R]
    for status, _bits in L._COMPACT_STATES.values():
        assert not status.any()


def test_level_expand_prepared_tables_equal_the_list(cuda, toy_indexes):
    """The tables prepared once (LevelTables) and as a list give K12 equal
    outputs, over 1, 2 and 128 tables; a prepared form on another device
    than the state is refused."""
    from dsm_tpu_torch.ops import level as L

    idxs = _samples(toy_indexes, 273)
    for parts in (1, 2, 128):
        tables, ns = _level_tables(idxs, parts, cuda)
        state = _synthetic_level(ns, 4, 9, 273, seed=parts, device=cuda)
        by_list = L.expand_level(tables, *state, 2)
        prepared = L.LevelTables(tables)
        got = L.expand_level(prepared, *state, 2)
        for k in by_list:
            assert torch.equal(got[k], by_list[k]), (parts, k)
    on_cpu = L.LevelTables([tuple(t.cpu() for t in tables[0][:3]) + (0,)])
    with pytest.raises(ValueError, match="tables are on cpu"):
        L.expand_level(on_cpu, *state, 2)


def test_level_expand_refuses_129_tables(cuda, toy_indexes):
    """More than MAX_TABLES tables are refused before any launch, as a
    list and when prepared."""
    from dsm_tpu_torch.ops import level as L

    tables, ns = _level_tables(toy_indexes, 1, cuda)
    state = _synthetic_level(ns, 1, 4, 5, seed=1, device=cuda)
    many = tables * (L.MAX_TABLES + 1)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="1 to 128 tables"):
        L.expand_level(many, *state, 2)
    with pytest.raises(ValueError, match="1 to 128 tables"):
        L.LevelTables(many)
    assert _build.LAUNCHES == before
    L.expand_level(tables * L.MAX_TABLES, *state, 2)
    assert _build.LAUNCHES["level_expand"] == before["level_expand"] + 1


@pytest.mark.parametrize("n", [1, 31, 4096, 4097, (1 << 20) + 7])
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_compact_kidx_kernel(cuda, n, frac):
    from dsm_tpu_torch.ops.compact import (compact_kidx, compact_kidx_plain,
                                           compact_kidx_sort)

    g = torch.Generator(device="cpu").manual_seed(n)
    mask = (torch.rand(n, generator=g) < frac).to(cuda)
    k = int(mask.sum())
    for width in sorted({0, max(k - 3, 0), k, n}):
        before = _build.LAUNCHES["compact_kidx"]
        got, count = compact_kidx(mask, width)
        assert _build.LAUNCHES["compact_kidx"] == before + 1
        want, wcount = compact_kidx_plain(mask, width)
        assert int(count) == int(wcount) == k
        assert torch.equal(got, want)
        assert torch.equal(compact_kidx_sort(mask, width)[0], want)


def _occ_batch_once(blocks, occ, syms, pos):
    """K15 once (one launch) against its plain version, bit for bit."""
    from dsm_tpu_torch.ops.rank import occ_batch, occ_batch_plain

    before = _build.LAUNCHES["occ_batch"]
    got = occ_batch(blocks, occ, syms, pos)
    assert _build.LAUNCHES["occ_batch"] == before + 1
    assert torch.equal(got, occ_batch_plain(blocks, occ, syms, pos))


def _occ_edges(n: int, nb: int) -> np.ndarray:
    """Every in-block offset of the first, a middle and the last block (the
    last one's codes only), and pos = n, each with the 8 symbols ->
    (syms, pos) int32."""
    starts = sorted({0, (nb // 2) * 128, (nb - 1) * 128})
    pos = np.concatenate([s + np.arange(128) for s in starts] + [[n]])
    pos = np.tile(pos[pos <= n], 8).astype(np.int32)
    return np.repeat(np.arange(8, dtype=np.int32), pos.size // 8), pos


@pytest.mark.parametrize("q", [1, 7, 33, 100_003])
def test_occ_batch_kernel(cuda, toy_indexes, q):
    t = toy_indexes[0].table
    blocks = torch.as_tensor(t.blocks, device=cuda)
    occ = torch.as_tensor(t.occ, device=cuda)
    rng = np.random.default_rng(q)
    pos = rng.integers(0, t.n + 1, size=q).astype(np.int32)
    pos[:min(q, 3)] = [0, t.n, (t.n // 128) * 128][:min(q, 3)]
    syms = rng.integers(0, 8, size=q).astype(np.int32)
    _occ_batch_once(blocks, occ, torch.as_tensor(syms, device=cuda),
                    torch.as_tensor(pos, device=cuda))


@pytest.mark.parametrize("which", [0, 1])
def test_occ_batch_kernel_every_offset(cuda, toy_indexes, which):
    """Every in-block offset 0..127 (each 16-byte vector's and sector's
    edge; the counts from the start and from the nearer end) of toy0's and
    toy1's first, middle and last blocks and pos = n, with each of the 8
    symbols, PAD (7) included; toy1's last block holds codes past its
    middle (counted from its start: the last occ row leaves the padding
    out of PAD's count)."""
    t = toy_indexes[which].table
    if which == 1:
        assert t.n % 128 > 64
    syms, pos = _occ_edges(t.n, t.blocks.shape[0])
    _occ_batch_once(torch.as_tensor(t.blocks, device=cuda),
                    torch.as_tensor(t.occ, device=cuda),
                    torch.as_tensor(syms, device=cuda),
                    torch.as_tensor(pos, device=cuda))


def test_occ_batch_kernel_n_multiple_of_128(cuda):
    """pos = n with n a multiple of 128 reads no row (offset 0 of the row
    past the last); the last block's offsets, each symbol."""
    from dsm_tpu_torch.ops.rank import OccTable

    codes = np.random.default_rng(11).integers(1, 6, size=128 * 37)
    t = OccTable.build(codes.astype(np.int8))
    syms, pos = _occ_edges(t.n, t.blocks.shape[0])
    assert pos[-1] == t.n == 128 * t.blocks.shape[0]
    _occ_batch_once(torch.as_tensor(t.blocks, device=cuda),
                    torch.as_tensor(t.occ, device=cuda),
                    torch.as_tensor(syms, device=cuda),
                    torch.as_tensor(pos, device=cuda))


def test_occ_batch_kernel_unaligned_blocks(cuda, toy_indexes):
    """A blocks view 4-byte aligned but not 16-byte aligned takes the
    kernel's 4-byte loads, bit for bit; a view not 4-byte aligned is
    refused."""
    t = toy_indexes[1].table
    flat = torch.zeros(t.blocks.size + 16, dtype=torch.int8, device=cuda)
    blocks = flat[4:4 + t.blocks.size].view(-1, 128)
    blocks.copy_(torch.as_tensor(t.blocks))
    assert blocks.data_ptr() % 16 == 4 and blocks.data_ptr() % 4 == 0
    syms, pos = _occ_edges(t.n, t.blocks.shape[0])
    rng = np.random.default_rng(12)
    syms = np.concatenate([syms, rng.integers(0, 8, 10_001)]).astype(np.int32)
    pos = np.concatenate([pos, rng.integers(0, t.n + 1, 10_001)]).astype(
        np.int32)
    occ = torch.as_tensor(t.occ, device=cuda)
    args = (torch.as_tensor(syms, device=cuda),
            torch.as_tensor(pos, device=cuda))
    _occ_batch_once(blocks, occ, *args)
    odd = flat[1:1 + t.blocks.size].view(-1, 128)
    from dsm_tpu_torch.ops.rank import occ_batch

    with pytest.raises(ValueError, match="4-byte"):
        occ_batch(odd, occ, *args)


def test_occ_batch_kernel_past_the_l2(cuda):
    """chip_smoke's case (c): 2^27 random codes in 1..5 (1,048,576 blocks,
    128 MB, and a 32 MB occ table by cumulative counts), past the 50 MB L2,
    at 2^16 random queries and the edges of its first, middle and last
    blocks."""
    from dsm_tpu_torch.ops.rank import SIGMA

    gen = torch.Generator(device=cuda).manual_seed(27)
    blocks = torch.randint(1, 6, (1 << 20, 128), device=cuda,
                           dtype=torch.int8, generator=gen)
    occ = torch.zeros((blocks.shape[0] + 1, SIGMA), dtype=torch.int32,
                      device=cuda)
    occ[1:] = torch.stack([(blocks == c).sum(1, dtype=torch.int32)
                           for c in range(SIGMA)], 1).cumsum(
                               0, dtype=torch.int32)
    n = blocks.numel()
    syms, pos = _occ_edges(n, blocks.shape[0])
    rng = np.random.default_rng(13)
    syms = np.concatenate([syms, rng.integers(0, 8, 1 << 16)])
    pos = np.concatenate([pos, rng.integers(0, n + 1, 1 << 16)])
    _occ_batch_once(blocks, occ,
                    torch.as_tensor(syms.astype(np.int32), device=cuda),
                    torch.as_tensor(pos.astype(np.int32), device=cuda))


def test_occ_cum_on_card(cuda, toy_indexes):
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    from dsm_tpu_torch.ops.rank import occ_cum, occ_cum_plain

    dev = DeviceIndexes.build(toy_indexes, cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    blk = torch.randint(0, dev.frows.shape[0], (7, 1001), generator=g,
                        dtype=torch.int32).to(cuda)
    rem = torch.randint(0, 128, (7, 1001), generator=g,
                        dtype=torch.int32).to(cuda)
    got = occ_cum(dev.frows, blk, rem)
    assert got.shape == (7, 1001, 5)
    assert torch.equal(got, occ_cum_plain(dev.frows, blk, rem))


@pytest.mark.parametrize("order", ["ascending", "gnu"])
def test_level_engines_on_card_equal_cpu(cuda, toy_indexes, order):
    """mine_sharded at (4, 2) and (3, 2) and, in gnu order,
    mine_torch(reader_order='level-gnu') on the card against the episode
    on the CPU; each level one launch of K12 and of K13."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch
    from dsm_tpu_torch.parallel.engine_sharded import mine_sharded
    from dsm_tpu_torch.parallel.mesh import make_mesh

    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=10)
    want = mine_torch(toy_indexes, cfg, reader_order=order, device="cpu")
    runs = [lambda p: mine_sharded(toy_indexes, cfg, mesh=make_mesh(
        *shape, device=cuda), reader_order=order, cap=64, profile=p)
        for shape in ((4, 2), (3, 2))]
    if order == "gnu":
        runs.append(lambda p: mine_torch(toy_indexes, cfg,
                                         reader_order="level-gnu",
                                         device=cuda, profile=p))
    for run in runs:
        _build.reset_launches()
        prof = {}
        got = run(prof)
        assert got.format_lines() == want.format_lines()
        assert got.total_paths == want.total_paths
        assert _build.LAUNCHES["level_expand"] == prof["levels"]
        assert _build.LAUNCHES["level_compact"] == prof["levels"]


def test_mine_sharded_in_a_nccl_group(cuda, toy_indexes, tmp_path):
    """mine_sharded at (4, 2) inside a one-rank NCCL group: the level's
    all-reduce of the per-node sums and the emission's all-gathers on the
    card, against the CPU's run without a group."""
    import torch.distributed as dist

    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.parallel.engine_sharded import mine_sharded
    from dsm_tpu_torch.parallel.mesh import make_mesh
    from dsm_tpu_torch.parallel.multihost import initialize

    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=10)
    want = mine_sharded(toy_indexes, cfg, mesh=make_mesh(4, 2, device="cpu"),
                        reader_order="gnu", device="cpu")
    initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(4, 2, device=cuda)
        assert mesh.samples.group is not None
        got = mine_sharded(toy_indexes, cfg, mesh=mesh, reader_order="gnu")
    finally:
        dist.destroy_process_group()
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths


CLOCK_SLACK_US = 1000.0


def test_spans_share_the_device_clock(cuda, toy_indexes, tmp_path):
    """A job under torch.profiler with the port's annotations on: every
    launch of a port kernel lies inside the one `dsm.job` span and inside a
    phase span within it, and every such kernel starts on the device
    between its launch's host start and the job's end, give or take
    CLOCK_SLACK_US (one clock for both).  The profiler maps the device's
    timestamps onto the host's clock with an error that differs from one
    profiling session to the next: on an H100, a kernel read as starting
    up to 149 us before its launch (5 sessions at the benchmark's scale),
    29 us on the toy job; two clocks apart would differ by far more.
    With the annotations off, the window holds no `dsm.*` event."""
    import json
    import sys

    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch
    from dsm_tpu_torch.utils import trace

    sys.path.insert(0, os.path.dirname(HERE))
    from dsmbench.run import is_port_kernel, port_kernels

    cfg = MiningConfig(fmin=2, emax=1.2)
    dev = DeviceIndexes.build(toy_indexes, cuda)
    mine_torch(toy_indexes, cfg, device=cuda, dev=dev)   # built and warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    events = {}
    for on in (True, False):
        trace.annotate(on)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                mine_torch(toy_indexes, cfg, device=cuda, dev=dev)
                torch.cuda.synchronize(cuda)
        finally:
            trace.annotate(False)
        path = tmp_path / f"trace-{on}.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events[on] = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
    assert not [e for e in events[False]
                if e.get("name", "").startswith("dsm.")]

    ev = events[True]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("dsm.")]
    jobs = [s for s in spans if s[0] == "dsm.job"]
    assert len(jobs) == 1
    j0, j1 = jobs[0][1:]
    phases = [s for s in spans if s[0] != "dsm.job"]
    assert {"dsm.level", "dsm.level_wait", "dsm.drain"} <= {
        s[0] for s in phases}
    names = port_kernels()
    host = {e["args"]["correlation"]: e for e in ev
            if e.get("cat") == "cuda_runtime" and "correlation" in
            e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"
               and is_port_kernel(e["name"], names)]
    assert kernels
    for k in kernels:
        launch = host[k["args"]["correlation"]]
        t0, t1 = launch["ts"], launch["ts"] + launch["dur"]
        assert j0 <= t0 and t1 <= j1, k["name"]
        assert any(s0 <= t0 and t1 <= s1 for _n, s0, s1 in phases), \
            k["name"]
        assert t0 - CLOCK_SLACK_US <= k["ts"] <= j1 + CLOCK_SLACK_US, \
            (k["name"], k["ts"] - t0)
