"""The per-level engines of the port against dsm_tpu's, on the CPU.

(a) The mesh helpers (`row_masks`, `_depth_splits`, `row_prefix_masks`,
    `prefixes_of_row` for 1-64 prefix rows, `default_mesh_shape(1..16)`)
    equal dsm_tpu/parallel/mesh.py's, refusals included.
(b) `occ_cum` and `occ_batch` (plain) equal dsm_tpu/ops/rank.py's on
    random queries over toy0's tables (block edges and pos = n included),
    `occ_batch` also at every in-block offset with each symbol, with syms
    of int8, int32 and int64, at Q = 0 and where n is a multiple of 128;
    `compact_kidx`, `compact_kidx_sort` (plain) equal dsm_tpu's
    `compact_kidx_np` and both JAX forms on the first `count` slots at 0%,
    30% and 100% set, widths below and above the count.
(c) The dense level step (`_level_step`: K12 and K13's plain versions) on
    real toydata levels carried across from dsm_tpu's `_seed_state` /
    `_level_step_impl` by `convert.level_state_from_jax`: every output
    bit for bit (freq, lc, single_full, parent_row, sym, child_count and
    the next lo, hi, rlo, valid, the rows past the count included), also
    on a level that overflows its capacity and under an enforced prefix;
    K12's children equal `expand_core`'s; the same with the tables prepared
    once (`ops/level.LevelTables`), whose outputs also equal the list's at
    every level.  `LevelTables` refuses bad tables when it is made, and
    the level-gnu and sharded engines make one a run, which every level
    takes.
(d) `mine_torch(reader_order='level-gnu', device='cpu')` against the
    reference servers' frozen output (tests/golden, all four prefixes
    concatenated, the whole trie at `default`; `shallow` also against
    dsm_tpu's level-gnu run), and a checkpoint with level-gnu raises
    dsm_tpu's ValueError.
(e) `mine_sharded(device='cpu')` against dsm_tpu's `mine_sharded` on
    conftest's 8 virtual devices, as tests/test_sharded.py runs it: meshes
    (4, 2), (1, 8) (as (1, 8) sample shards on one process), (3, 2) and
    (8, 1) (whose depth-1 nodes two rows count), gates, full depth, an
    enforced prefix, gnu order, a small capacity; in two gloo processes
    (this file's `__main__` is the worker) against the oracle.
(f) `NativeTrieParser.feed_arrays` equals dsm_tpu's on one byte stream fed
    in pieces.
Exact everywhere; the entropy diagnostics within 5e-6 of dsm_tpu's f32
ones where both run the device engines.
"""

import glob
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOYDATA = os.path.join(HERE, "data", "toydata")
GOLDEN = os.path.join(HERE, "golden")


def _worker(rank: int, world: int, init_file: str, outdir: str) -> None:
    """One gloo process of test (e): mine_sharded on a (2, 2 x world) mesh,
    2 sample shards a process, ascending and gnu; writes each output."""
    sys.path.insert(0, REPO)
    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.parallel.engine_sharded import mine_sharded
    from dsm_tpu_torch.parallel.mesh import make_mesh
    from dsm_tpu_torch.parallel.multihost import initialize

    initialize(f"file://{init_file}", world, rank, backend="gloo")
    mesh = make_mesh(2, 2 * world, device="cpu")
    assert mesh.samples.shards_per_rank == 2
    idxs = indexes_from_fasta(sorted(glob.glob(os.path.join(
        TOYDATA, "toy*.fasta.gz"))), "cpu")
    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=9)
    for order in ("ascending", "gnu"):
        out = mine_sharded(idxs, cfg, mesh=mesh, reader_order=order, cap=64)
        with open(os.path.join(outdir, f"{order}{rank}.txt"), "wb") as f:
            f.write(out.format_lines() + b"paths %d\n" % out.total_paths)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    raise SystemExit(0)


import jax.numpy as jnp  # noqa: E402

from dsm_tpu.index.alphabet import transform  # noqa: E402
from dsm_tpu.index.fasta import read_fasta  # noqa: E402
from dsm_tpu.index.fmindex import FMIndex  # noqa: E402
from dsm_tpu.mining import engine as jeng  # noqa: E402
from dsm_tpu.mining.config import MiningConfig  # noqa: E402
from dsm_tpu.mining.engine_np import mine_np  # noqa: E402
from dsm_tpu.ops import compact as jcompact  # noqa: E402
from dsm_tpu.ops import rank as jrank  # noqa: E402
from dsm_tpu.parallel import engine_sharded as jes  # noqa: E402
from dsm_tpu.parallel import mesh as jmesh  # noqa: E402
from dsm_tpu_torch import convert  # noqa: E402
from dsm_tpu_torch.mining import engine as peng  # noqa: E402
from dsm_tpu_torch.ops import compact as pcompact  # noqa: E402
from dsm_tpu_torch.ops import rank as prank  # noqa: E402
from dsm_tpu_torch.ops import level as plevel  # noqa: E402
from dsm_tpu_torch.ops.level import expand_level  # noqa: E402
from dsm_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dsm_tpu_torch.parallel.engine_sharded import mine_sharded  # noqa: E402

ENT_TOL = 5e-6
CFG = MiningConfig(fmin=2, emax=1.2, maxdepth=9)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU runs: the suite's workers
    share the cores, and a level's many small ops each wait on every
    thread of the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def indexes():
    return [FMIndex.from_texts([transform(r.seq) for r in read_fasta(p)])
            for p in sorted(glob.glob(os.path.join(TOYDATA,
                                                   "toy*.fasta.gz")))]


@pytest.fixture(scope="module")
def port_indexes(indexes):
    return [convert.fmindex_from_jax(i) for i in indexes]


def golden_bytes(config: str) -> bytes:
    data = b""
    for p in "ACGT":
        with gzip.open(os.path.join(
                GOLDEN, f"server-output.{config}.{p}.txt.gz")) as f:
            data += f.read()
    return data


def assert_same(got, want, entropy_tol=None):
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)
    np.testing.assert_array_equal(got.freq_histogram, want.freq_histogram)
    if entropy_tol is not None:
        assert abs(got.smallest_entropy - want.smallest_entropy) < entropy_tol
        assert abs(got.largest_entropy - want.largest_entropy) < entropy_tol


# ------------------------------------------------- (a) the mesh helpers --

def _same_or_both_raise(f, g, *args):
    try:
        want = f(*args)
    except ValueError:
        with pytest.raises(ValueError):
            g(*args)
        return None
    got = g(*args)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want
    return want


@pytest.mark.parametrize("n", range(1, 65))
def test_mesh_helpers_match_jax(n):
    for name in ("row_masks", "_depth_splits", "row_prefix_masks",
                 "prefix_depth"):
        _same_or_both_raise(getattr(jmesh, name), getattr(pmesh, name), n)
    if _same_or_both_raise(jmesh.row_prefix_masks, pmesh.row_prefix_masks,
                           n) is not None:
        for row in range(n):
            assert pmesh.prefixes_of_row(n, row) == \
                jmesh.prefixes_of_row(n, row)
    if n <= 16:
        assert pmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n)


def test_make_mesh():
    mesh = pmesh.make_mesh(3, 8, device="cpu")
    assert mesh.shape == {"prefix": 3, "samples": 8}
    assert (mesh.samples.world, mesh.samples.shards_per_rank) == (1, 8)
    for bad in ((5, 1), (0, 1), (1, 0)):
        with pytest.raises(ValueError):
            pmesh.make_mesh(*bad, device="cpu")


# ------------------------------------- (b) occ_cum, occ_batch, compact --

@pytest.mark.parametrize("baked", [False, True])
def test_occ_cum_matches_jax(indexes, baked):
    idx = indexes[0]
    c4 = [idx.C[c] for c in peng.EXT4] if baked else None
    rows = jrank.fused_rows(idx.table, c4=c4)
    rng = np.random.default_rng(7)
    pos = rng.integers(0, idx.n + 1, size=(3, 4001))
    pos[0, :4] = [0, idx.n, 128, (idx.n // 128) * 128]
    blk = (pos >> 7).astype(np.int32)
    rem = (pos & 127).astype(np.int32)
    want = np.asarray(jrank.occ_cum(jnp.asarray(rows), jnp.asarray(blk),
                                    jnp.asarray(rem)))
    prow = torch.from_numpy(rows.view(np.int32))
    got = prank.occ_cum(prow, torch.from_numpy(blk), torch.from_numpy(rem))
    assert got.shape == (3, 4001, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_occ_batch_matches_jax(indexes):
    t = indexes[1].table
    rng = np.random.default_rng(8)
    pos = rng.integers(0, t.n + 1, size=20_011).astype(np.int32)
    pos[:3] = [0, t.n, (t.n // 128) * 128]
    syms = rng.integers(0, 8, size=pos.size).astype(np.int8)
    want = np.asarray(jrank.occ_batch(jnp.asarray(t.blocks),
                                      jnp.asarray(t.occ), jnp.asarray(syms),
                                      jnp.asarray(pos)))
    got = prank.occ_batch(torch.from_numpy(t.blocks), torch.from_numpy(t.occ),
                          torch.from_numpy(syms), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, jrank.occ_prefix_np(t, syms.astype(np.int64), pos))


def _occ_edges(t) -> np.ndarray:
    """Every in-block offset of the first, a middle and the last block
    (the last one's codes only), and pos = n."""
    nb = t.blocks.shape[0]
    starts = sorted({0, (nb // 2) * 128, (nb - 1) * 128})
    pos = np.concatenate([s + np.arange(128) for s in starts] + [[t.n]])
    return pos[pos <= t.n].astype(np.int32)


OCC_EDGE_CASES = ([f"offsets, sym {s}" for s in range(8)]
                  + ["syms int8", "syms int32", "syms int64", "no queries",
                     "n a multiple of 128"])


@pytest.mark.parametrize("case", OCC_EDGE_CASES)
def test_occ_batch_edges_match_jax(indexes, case):
    """The port's occ_batch against dsm_tpu's (JAX on the CPU): every
    in-block offset (each 16-byte vector's and 32-byte sector's edge, both
    halves of a block) with each symbol, PAD (7) included, on toy0 and on
    toy1, whose last block holds codes past its middle; syms of int8, int32
    and int64; Q = 0; a sample whose n is a multiple of 128 (pos = n is
    offset 0 of the row past the last), every offset of its last block with
    each symbol."""
    tables = [idx.table for idx in indexes[:2]]
    rng = np.random.default_rng(9)
    if case.startswith("offsets"):
        assert tables[1].n % 128 > 64
        runs = [(t, np.full(_occ_edges(t).size, int(case[-1]), np.int8),
                 _occ_edges(t)) for t in tables]
    elif case.startswith("syms"):
        t = tables[0]
        pos = np.concatenate([_occ_edges(t), rng.integers(0, t.n + 1, 5_003)])
        runs = [(t, rng.integers(0, 8, pos.size).astype(case.split()[1]),
                 pos.astype(np.int32))]
    elif case == "no queries":
        runs = [(tables[0], np.zeros(0, np.int8), np.zeros(0, np.int32))]
    else:
        codes = rng.integers(1, 6, size=128 * 37).astype(np.int8)
        t = jrank.OccTable.build(codes)
        pt = prank.OccTable.build(codes)
        np.testing.assert_array_equal(pt.blocks, t.blocks)
        np.testing.assert_array_equal(pt.occ, t.occ)
        pos = np.tile(_occ_edges(t), 8)
        assert pos[-1] == t.n == 128 * t.blocks.shape[0]
        runs = [(t, np.repeat(np.arange(8, dtype=np.int32), pos.size // 8),
                 pos)]
    for t, syms, pos in runs:
        want = np.asarray(jrank.occ_batch(
            jnp.asarray(t.blocks), jnp.asarray(t.occ), jnp.asarray(syms),
            jnp.asarray(pos)))
        got = prank.occ_batch(torch.from_numpy(t.blocks),
                              torch.from_numpy(t.occ), torch.from_numpy(syms),
                              torch.from_numpy(pos))
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        if case == "n a multiple of 128":
            # dsm_tpu's occ_prefix_np reads the row past the last at pos = n
            # here (the port's copy was repaired, PERF.md's PR 16 findings)
            np.testing.assert_array_equal(
                want, prank.occ_prefix_np(pt, syms.astype(np.int64), pos))
        elif syms.size:
            np.testing.assert_array_equal(
                want, jrank.occ_prefix_np(t, syms.astype(np.int64), pos))


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_compact_kidx_matches_jax(frac):
    n = 4096 + 96
    mask = np.random.default_rng(int(frac * 10)).random(n) < frac
    count = int(mask.sum())
    for width in sorted({1, max(count - 5, 1), count or 1, n}):
        want, wcount = jcompact.compact_kidx_np(mask, width)
        k = min(count, width)
        for fn in (pcompact.compact_kidx, pcompact.compact_kidx_sort):
            got, gcount = fn(torch.from_numpy(mask), width)
            assert int(gcount) == wcount == count
            assert got.dtype == torch.int32 and got.shape == (width,)
            np.testing.assert_array_equal(got.numpy()[:k], want[:k])
        np.testing.assert_array_equal(
            pcompact.compact_kidx_np(mask, width)[0], want)
        for jfn in (jcompact.compact_kidx, jcompact.compact_kidx_sort):
            jk, jc = jfn(jnp.asarray(mask), width)
            assert int(jc) == count
            np.testing.assert_array_equal(np.asarray(jk)[:k], want[:k])
    with pytest.raises(ValueError):
        pcompact.compact_kidx(torch.from_numpy(mask), n + 1)


# ----------------------------------------------- (c) the dense level step --

LEVEL_CASES = {"default": (b"", 1024, 6), "overflow": (b"", 4, 5),
               "prefix": (b"GA", 16, 6), "maxdepth": (b"", 1024, 3)}


def _level_steps_against_jax(indexes, case, prepared):
    """dsm_tpu's per-level loop, level by level: its state carried across
    to the port's `_level_step` at every level, every output compared; with
    `prepared`, the step takes the tables as one LevelTables made before
    the first level and must also give the list's outputs at each level."""
    prefix, cap, depths = LEVEL_CASES[case]
    maxdepth = 3 if case == "maxdepth" else CFG.maxdepth
    jdev = jeng.DeviceIndexes.build(indexes)
    pdev = convert.tables_from_device_indexes(jdev, "cpu")
    listed = [(pdev.frows, pdev.rrows, pdev.soff, 0)]
    tables = plevel.LevelTables(listed) if prepared else listed
    fmin = jnp.asarray(CFG.fmin, dtype=jnp.int32)
    state = jeng._seed_state(jdev, cap)
    depth = levels = regrows = 0
    while depth <= depths:
        m = np.zeros(4, bool) if depth >= maxdepth else np.ones(4, bool)
        if depth < len(prefix) and depth < maxdepth:
            m = np.eye(4, dtype=bool)[b"ACGT".index(prefix[depth])]
        want = jeng._level_step(jdev.frows, jdev.rrows, jdev.soff, *state,
                                fmin, jnp.asarray(m))
        carried = convert.level_state_from_jax(*state, "cpu", sym_mask=m)
        got = peng._level_step(tables, carried[:4], CFG.fmin, carried[4])
        for k, v in want.items():
            np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(v),
                                          err_msg=f"{case} depth {depth} {k}")
        if prepared:
            by_list = peng._level_step(listed, carried[:4], CFG.fmin,
                                       carried[4])
            assert by_list.keys() == got.keys()
            for k in got:
                assert torch.equal(got[k], by_list[k]), (case, depth, k)
        if depth == 1:
            core = jeng.expand_core(jdev.frows, jdev.rrows, jdev.soff,
                                    *state, fmin)
            pcore = expand_level(tables, *carried[:4], CFG.fmin)
            for k in ("clo", "chi", "crlo", "cactive"):
                np.testing.assert_array_equal(
                    pcore[k][0].permute(0, 2, 1).numpy(),
                    np.asarray(core[k]))
            for k in ("nactive", "child_counts", "freq", "lc"):
                np.testing.assert_array_equal(pcore[k][0].numpy(),
                                              np.asarray(core[k]))
        levels += 1
        count = int(want["child_count"])
        cap_now = state[0].shape[0]
        if count > cap_now:
            regrows += 1
            state = jeng._resize(state, jeng._next_pow2(count))
            continue
        if count == 0:
            break
        state = (want["lo"], want["hi"], want["rlo"], want["valid"])
        depth += 1
    assert levels > 3
    if case == "overflow":
        assert regrows > 0


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_step_matches_jax(indexes, case):
    _level_steps_against_jax(indexes, case, prepared=False)


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_step_prepared_tables_match_jax(indexes, case):
    _level_steps_against_jax(indexes, case, prepared=True)


def _bad_tables(t, case):
    frows, rrows, soff = t
    one = (frows, rrows, soff, 0)
    return {
        "no table": [],
        "129 tables": [one] * 129,
        "frows int64": [(frows.to(torch.int64), rrows, soff, 0)],
        "rrows 16 words": [(frows, rrows[:, :16].contiguous(), soff, 0)],
        "frows not contiguous": [(frows.t().contiguous().t(), rrows, soff,
                                  0)],
        "soff int64": [(frows, rrows, soff.to(torch.int64), 0)],
        "soff 2-D": [(frows, rrows, soff[None, :], 0)],
        "another device": [one, (frows, rrows, soff.to("meta"), 2)],
        "first base 1": [(frows, rrows, soff, 1)],
        "bases descending": [one, (frows, rrows, soff, 3),
                             (frows, rrows, soff, 2)],
    }[case]


BAD_TABLES = ("no table", "129 tables", "frows int64", "rrows 16 words",
              "frows not contiguous", "soff int64", "soff 2-D",
              "another device", "first base 1", "bases descending")


@pytest.mark.parametrize("case", BAD_TABLES)
def test_level_tables_refuse_bad_tables(port_indexes, case):
    """LevelTables checks the tables once, when the run prepares them: each
    bad table raises there (as the list form raises on the card at every
    call)."""
    dev = peng.DeviceIndexes.build(port_indexes, "cpu")
    t = (dev.frows, dev.rrows, dev.soff)
    with pytest.raises(ValueError, match="LevelTables"):
        plevel.LevelTables(_bad_tables(t, case))


def test_level_tables_take_128_and_keep_the_list(port_indexes):
    dev = peng.DeviceIndexes.build(port_indexes, "cpu")
    listed = [(dev.frows, dev.rrows, dev.soff, min(k, 3))
              for k in range(plevel.MAX_TABLES)]
    tables = plevel.LevelTables(listed)
    assert tables.tables == listed
    assert tables.device == torch.device("cpu")
    assert list(tables.packed[:4]) == [dev.frows.data_ptr(),
                                       dev.rrows.data_ptr(),
                                       dev.soff.data_ptr(), 0]
    assert tables.packed[-1] == 3 and len(tables.packed) == 4 * 128
    # a state on another device than the prepared tables' is refused
    meta = torch.empty((1, 4, dev.S), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="tables are on cpu"):
        expand_level(tables, meta, meta, meta,
                     torch.empty((1, 4), dtype=torch.bool, device="meta"), 2)


@pytest.mark.parametrize("engine", ["level-gnu", "sharded (4, 2)"])
def test_tables_are_packed_once_a_run(port_indexes, monkeypatch, engine):
    """mine_levels prepares the tables once a run: one LevelTables
    made, and every level's step (redone levels too) takes that one."""
    made, seen = [], []
    init = plevel.LevelTables.__init__

    def counted(self, tables):
        made.append(len(tables))
        init(self, tables)

    step = peng._level_step

    def recording(tables, *args, **kw):
        seen.append(tables)
        return step(tables, *args, **kw)

    monkeypatch.setattr(plevel.LevelTables, "__init__", counted)
    monkeypatch.setattr(peng, "_level_step", recording)
    cfg = convert.config_from_jax(MiningConfig(fmin=2, emax=1.2, maxdepth=6))
    prof = {}
    if engine == "level-gnu":
        peng.mine_torch(port_indexes, cfg, reader_order="level-gnu",
                        device="cpu", cap=16, profile=prof)
        assert made == [1]
    else:
        mine_sharded(port_indexes, cfg, mesh=pmesh.make_mesh(
            4, 2, device="cpu"), device="cpu", cap=16, profile=prof)
        assert made == [2]
    assert prof["regrows"] > 0 and len(seen) == prof["levels"] > 3
    assert isinstance(seen[0], plevel.LevelTables)
    assert all(t is seen[0] for t in seen)


# -------------------------------------------------- (d) level-gnu engine --

def test_level_gnu_matches_reference_golden(port_indexes):
    """The whole trie at `default` (unlimited depth) in level-gnu order:
    the four reference servers' stdout concatenated."""
    cfg = convert.config_from_jax(MiningConfig(fmin=2, emax=1.2))
    prof = {}
    got = peng.mine_torch(port_indexes, cfg, reader_order="level-gnu",
                          device="cpu", profile=prof)
    assert got.format_lines() == golden_bytes("default")
    assert prof["levels"] > 100


def test_level_gnu_shallow_matches_jax(indexes, port_indexes):
    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=12)
    got = peng.mine_torch(port_indexes, convert.config_from_jax(cfg),
                          reader_order="level-gnu", device="cpu", cap=64)
    assert got.format_lines() == golden_bytes("shallow")
    want = jeng.mine_tpu(indexes, cfg, reader_order="level-gnu")
    assert_same(got, want, entropy_tol=1e-12)
    assert_same(got, mine_np(indexes, cfg, reader_order="gnu"))


def test_level_gnu_refuses_a_checkpoint(port_indexes, indexes, tmp_path):
    ck = str(tmp_path / "x.ckpt")
    with pytest.raises(ValueError) as jerr:
        jeng.mine_tpu(indexes, CFG, reader_order="level-gnu", checkpoint=ck)
    with pytest.raises(ValueError) as perr:
        peng.mine_torch(port_indexes, convert.config_from_jax(CFG),
                        reader_order="level-gnu", device="cpu",
                        checkpoint=ck)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="reader_order"):
        peng.mine_torch(port_indexes, convert.config_from_jax(CFG),
                        reader_order="level-ascending", device="cpu")


# ------------------------------------------------------ (e) mine_sharded --

SHARDED = {
    # test_sharded.py:45-56: two meshes against the oracle at cap 512
    "(4,2)": ((4, 2), CFG, {}, 512),
    "(1,8)": ((1, 8), CFG, {}, 512),
    # :59-67: gates
    "gates": ((4, 2), MiningConfig(fmin=5, emax=10, pmin=1, pmax=1,
                                   maxdepth=10), {}, 1024),
    # :70-86: prefixes and gnu order
    "prefix-A": ((4, 2), CFG, dict(prefix=b"A"), 1024),
    "prefix-GA": ((4, 2), CFG, dict(prefix=b"GA"), 1024),
    "gnu": ((4, 2), CFG, dict(reader_order="gnu"), 1024),
    # :89-100: full depth
    "full-depth": ((4, 2), MiningConfig(fmin=4, emax=99, pmin=1), {}, 1024),
    # :142-155: three prefix rows, and a small capacity that regrows
    "(3,2)": ((3, 2), CFG, {}, 1024),
    "(3,2)-cap16-gnu": ((3, 2), CFG, dict(reader_order="gnu"), 16),
    # :287-310: eight rows, depth-2 partitions
    "(8,1)": ((8, 1), CFG, {}, 1024),
    "(8,1)-gnu": ((8, 1), CFG, dict(reader_order="gnu"), 1024),
}


@pytest.mark.parametrize("case", list(SHARDED))
def test_mine_sharded_matches_jax(indexes, port_indexes, case):
    shape, cfg, kw, cap = SHARDED[case]
    want = jes.mine_sharded(indexes, cfg, mesh=jmesh.make_mesh(*shape),
                            cap=cap, **kw)
    prof = {}
    got = mine_sharded(port_indexes, convert.config_from_jax(cfg),
                       mesh=pmesh.make_mesh(*shape, device="cpu"), cap=cap,
                       device="cpu", profile=prof, **kw)
    assert_same(got, want, entropy_tol=ENT_TOL)
    if cap < 64:
        assert prof["regrows"] > 0
    if "reader_order" not in kw:
        oracle = mine_np(indexes, cfg, prefix=kw.get("prefix", b""))
        assert got.format_lines() == oracle.format_lines()


def test_mine_sharded_default_mesh(indexes, port_indexes, monkeypatch):
    """mesh=None: default_mesh_shape(DSM_SHARDS) on the one process."""
    monkeypatch.setenv("DSM_SHARDS", "6")
    got = mine_sharded(port_indexes, convert.config_from_jax(CFG),
                       device="cpu", reader_order="gnu")
    want = jes.mine_sharded(indexes, CFG, mesh=jmesh.make_mesh(2, 3),
                            reader_order="gnu")
    assert_same(got, want, entropy_tol=ENT_TOL)


def test_mine_sharded_two_gloo_processes(indexes, tmp_path):
    """2 processes x 2 shards on a (2, 4) mesh over gloo: the level's
    all-reduce and the emission's gathers cross the process boundary, and
    every process ends with the full output."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    init = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2", init,
         str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE) for rank in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e.decode()
    for order in ("ascending", "gnu"):
        want = mine_np(indexes, CFG, reader_order=order)
        blob = want.format_lines() + b"paths %d\n" % want.total_paths
        for rank in range(2):
            assert (tmp_path / f"{order}{rank}.txt").read_bytes() == blob


# ------------------------------------------------------ (f) feed_arrays --

def test_feed_arrays_matches_jax(indexes):
    from dsm_tpu.net import native as jnative
    from dsm_tpu.net.client import serialize_trie
    from dsm_tpu_torch.net import native as pnative

    if jnative.get_lib() is None or pnative.get_lib() is None:
        pytest.skip("no C++ compiler for the native codec")
    data, _nodes = serialize_trie(indexes[2], fmin=2, maxdepth=8)
    jp, pp = jnative.NativeTrieParser(), pnative.NativeTrieParser()
    step = len(data) // 7 + 3
    for pos in range(0, len(data), step):
        want = jp.feed_arrays(data[pos:pos + step])
        got = pp.feed_arrays(data[pos:pos + step])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (pp.depth, pp.n, pp.pending) == (jp.depth, jp.n, jp.pending)
    assert pp.depth == 0 and pp.pending == 0


def test_prefix_mine_over_a_whole_last_block():
    """Samples of n = 6 x 128 symbols: the count of a prefix reads the
    rank at pos = n, past the last block (dsm_tpu's occ_prefix_np indexes
    past its blocks there); the port's episode and level-gnu mine under a
    prefix as its host engine does."""
    from dsm_tpu_torch.index.alphabet import transform as ptransform
    from dsm_tpu_torch.index.fmindex import FMIndex as PFMIndex
    from dsm_tpu_torch.mining.config import MiningConfig as PConfig
    from dsm_tpu_torch.mining.engine_np import mine_np as pmine_np

    rng = np.random.default_rng(128)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=300)]
    # two texts, their reverse complements and terminators: 6 x 128
    idxs = [PFMIndex.from_texts([ptransform(genome[s:s + w].tobytes())
                                 for s, w in ((k, 190), (k + 60, 192))],
                                device="cpu") for k in range(0, 40, 10)]
    assert all(i.n == 6 * 128 for i in idxs)
    t = idxs[0].table
    pos = np.array([t.n, t.n - 1, 0, 128])
    for sym in range(8):
        got = prank.occ_prefix_np(t, np.full(4, sym), pos)
        np.testing.assert_array_equal(
            got, prank.occ_batch_plain(torch.from_numpy(t.blocks),
                                       torch.from_numpy(t.occ),
                                       torch.full((4,), sym),
                                       torch.from_numpy(pos)).numpy())
    assert idxs[0].count(b"A") > 0
    cfg = PConfig(fmin=2, emax=99)
    for order in ("ascending", "gnu"):
        want = pmine_np(idxs, cfg, prefix=b"A", reader_order=order)
        assert want.total_output > 0
        for ro in ((order, "level-gnu") if order == "gnu" else (order,)):
            got = peng.mine_torch(idxs, cfg, prefix=b"A", reader_order=ro,
                                  device="cpu")
            assert_same(got, want)
