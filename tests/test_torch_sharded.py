"""The sample-sharded mining episode of the port
(dsm_tpu_torch/parallel/engine_episode.py) against dsm_tpu's and `mine_np`.

Everything runs on the CPU with the kernels' plain versions.

(a) The level (K9).  dsm_tpu's `_level_sharded` runs under `shard_map` on
    4 of the 8 virtual CPU devices, one level a call at a fixed bucket;
    before each level its state is carried to the port (convert.py) and the
    port's `_level_sharded` runs on it.  dsm_tpu numbers children c-major
    and pads the samples to 8 with dummies; the port numbers them in
    (node, symbol) order and splits the 5 real samples 1+1+1+2.  So the
    states are compared by decoded path: equal node count, total_paths,
    exit flag, the set of (path, global sample, lo, hi, rlo) live pairs
    and of (path, sample, freq, rlo, depth) staged rows.  The entropy
    min/max are float32 there and fixed-point sums here: relative 1e-5.
    The port's sharded level is also held against its single-device
    `_level` for 1, 2, 3 and 5 shards, where node ids agree: the one pair
    list a process in (node, global sample) order and by decoded path, the
    node starts, history, total_paths and flag exactly, entropy min/max
    within ENT_FP_TOL; and a level launches each of its kernels once at 1,
    2, 5 and 8 shards (the wrappers' calls counted).
(b) The kernels' plain versions: the multi-table expand over a process's
    shard tables against the single-table expand of each shard and of the
    unsharded tables; the partial rows of the process's list equal to those
    of its samples' parts added up (the merge over processes), and gated
    against `segstats_plain` on the unsharded list (flags equal,
    entropy within ENT_FP_TOL: each pair's term is truncated to 2^-17 and
    the sum is divided by s_total + sum f, which exceeds the pairs'
    number, so the error stays under 2^-17 = 7.6e-6),
    the outside-ids children against a numpy statement, the gather
    against numpy (also with more blocks than one launch of its kernel
    takes and with slices at 4-byte offsets), and the drain's leftChar
    over a process's shard tables against the single-device codes of the
    same rows; with empty segments, an empty shard and a one-sample
    shard, over seeded random cases.  More than MAX_SHARDS shards a
    process are refused before any table is built.
(c) The slice: `mine_device_sharded` against `mine_np` and dsm_tpu's
    `mine_device_sharded` (lines, total_paths, total_output, total_occs,
    freq_histogram exactly; the entropy diagnostics within 1e-5), at full
    depth, with prefixes, in gnu order, killed and resumed, across
    engines, shard counts and packages, and with a small history.
(d) Two gloo processes x 2 shards (this file's `__main__` is the worker;
    rendezvous through a file under tmp_path): each process's full output
    equals the oracle, ascending and gnu.
(e) The CLI with DSM_SHARDS=2 against `dsm mine`, with --checkpoint.
"""

import functools
import glob
import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOYDATA = os.path.join(HERE, "data", "toydata")
ENT_FP_TOL = 1e-5   # the fixed-point entropy against the f64 one


def _worker(rank: int, world: int, init_file: str, outdir: str) -> None:
    """One gloo process of test (d): mines the toydata with 2 shards a
    process, ascending and gnu, and writes each full output."""
    sys.path.insert(0, REPO)
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fasta import read_fasta
    from dsm_tpu_torch.index.fmindex import FMIndex
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.multihost import (global_samples_mesh,
                                                  initialize)

    initialize(f"file://{init_file}", world, rank, backend="gloo")
    mesh = global_samples_mesh(shards_per_rank=2, device="cpu")
    assert (mesh.rank, mesh.world, mesh.n_shards) == (rank, world, 2 * world)
    idxs = [FMIndex.from_texts([transform(r.seq) for r in read_fasta(p)],
                               device="cpu")
            for p in sorted(glob.glob(os.path.join(TOYDATA,
                                                   "toy*.fasta.gz")))]
    cfg = MiningConfig(fmin=2, emax=1.2)
    for order in ("ascending", "gnu"):
        # out_reserve 64: several drains, each an all-gather
        out = mine_device_sharded(idxs, cfg, mesh=mesh, reader_order=order,
                                  out_reserve=64,
                                  checkpoint=os.path.join(outdir,
                                                          f"{order}.ckpt"))
        with open(os.path.join(outdir, f"{order}{rank}.txt"), "wb") as f:
            f.write(out.format_lines())
            f.write(b"paths %d\n" % out.total_paths)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    raise SystemExit(0)


import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dsm_tpu.cli.main import main as dsm_main  # noqa: E402
from dsm_tpu.index.alphabet import transform  # noqa: E402
from dsm_tpu.index.fasta import read_fasta  # noqa: E402
from dsm_tpu.index.fmindex import FMIndex  # noqa: E402
from dsm_tpu.mining import checkpoint as jckpt  # noqa: E402
from dsm_tpu.mining import engine_device as jed  # noqa: E402
from dsm_tpu.mining.config import MiningConfig  # noqa: E402
from dsm_tpu.mining.engine_np import mine_np  # noqa: E402
from dsm_tpu.ops.rank import ROWW  # noqa: E402
from dsm_tpu.parallel import engine_episode as jee  # noqa: E402
from dsm_tpu.parallel.engine_sharded import \
    ShardedIndexes as JaxShardedIndexes  # noqa: E402
from dsm_tpu_torch import convert  # noqa: E402
from dsm_tpu_torch.cli.main import main as port_main  # noqa: E402
from dsm_tpu_torch.mining import checkpoint as pckpt  # noqa: E402
from dsm_tpu_torch.mining import engine_device as ted  # noqa: E402
from dsm_tpu_torch.mining.engine import DeviceIndexes  # noqa: E402
from dsm_tpu_torch.ops.children import (PC_HI, PC_LO, PC_NID, PC_RLO,  # noqa: E402
                                        PC_SID, children_ids_plain,
                                        children_plain)
from dsm_tpu_torch.mining.engine import leftchar_rows  # noqa: E402
from dsm_tpu_torch.ops.gatherpack import (MAX_BLOCKS,  # noqa: E402
                                          gather_pack_plain)
from dsm_tpu_torch.ops.segstats import (S_CHILDREN, S_ENT_MAX,  # noqa: E402
                                        S_ENT_MIN, S_GATED, S_KEPT,
                                        S_PRESENT, Gates, segstats_plain)
from dsm_tpu_torch.ops.rank import (expand_plain,  # noqa: E402
                                    expand_tables_plain)
from dsm_tpu_torch.ops.shardstats import (FLAG_BITS, MAX_SHARDS,  # noqa: E402
                                          NACT_SHIFT,
                                          V_CHILDREN, V_ENT_MAX, V_ENT_MIN,
                                          V_GATED, V_KEPT, V_PRESENT,
                                          V_STAGED, kept_slot, level_values,
                                          node_gates_plain,
                                          shard_partials_plain)
from dsm_tpu_torch.parallel import engine_episode as tee  # noqa: E402
from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes  # noqa: E402
from dsm_tpu_torch.parallel.mesh import SamplesMesh  # noqa: E402
from dsm_tpu_torch.parallel.multihost import global_samples_mesh  # noqa: E402

EXT = np.frombuffer(b"\0NACGTN", dtype=np.uint8)   # alphabet.EXT_CHARS
CFG = MiningConfig(fmin=2, emax=1.2)
CFG_ONE = MiningConfig(fmin=5, emax=10, pmin=1, pmax=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU episodes: the suite's
    workers share the cores, and an episode's many small ops each wait on
    every thread of the pool."""
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
def pidx(indexes):
    return [convert.fmindex_from_jax(i) for i in indexes]


def cpu_mesh(n: int):
    return global_samples_mesh(shards_per_rank=n, device="cpu")


def port(pidx, cfg=CFG, shards=4, **kw):
    """The port's sharded episode on one process with `shards` shards."""
    return tee.mine_device_sharded(pidx, convert.config_from_jax(cfg),
                                   mesh=cpu_mesh(shards), **kw)


def assert_same(got, want, entropy_tol=None):
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
    assert got.total_output == want.total_output
    assert got.total_occs == want.total_occs
    np.testing.assert_array_equal(got.freq_histogram, want.freq_histogram)
    if entropy_tol is not None:
        assert abs(got.smallest_entropy - want.smallest_entropy) < entropy_tol
        assert abs(got.largest_entropy - want.largest_entropy) < entropy_tol


# ------------------------------------------------------- (a) the level --

B = 1 << 14          # the JAX level's fixed bucket, and its capacity
HIST_CAP = 1 << 18
JAX_SHARDS = 4
LEVEL_CASES = {
    "default": (MiningConfig(fmin=2, emax=1.5), ()),
    "filtered": (MiningConfig(fmin=2, emax=99, pmin=1, pmax=2, mindepth=3),
                 ()),
    "prefix": (MiningConfig(fmin=2, emax=99, emin=0.3, pmin=1), (2, 0)),  # GA
}


@functools.cache
def _jax_sharded_level(s_total: int):
    """dsm_tpu's `_level_sharded`, one level a call at bucket B, under
    shard_map over 4 virtual devices: the shard body of
    `_jitted_episode_sharded` without its while loop and bucket switch."""
    mesh = Mesh(np.array(jax.devices()[:JAX_SHARDS]), ("samples",))
    sh, rep, state_spec = jee._specs(mesh)

    def body(frowsT, state, *flat):
        state = {k: (v[0] if k in jee._SHARDED_KEYS else v)
                 for k, v in state.items()}
        s_l, nbp = frowsT.shape[0], frowsT.shape[2]
        flatT = frowsT.transpose(1, 0, 2).reshape(ROWW, s_l * nbp)
        state = jed._level_sharded(B, flatT, s_total, jed._Scalars(*flat),
                                   HIST_CAP, "samples", state)
        return {k: (v[None] if k in jee._SHARDED_KEYS else v)
                for k, v in state.items()}

    return jax.jit(jee._shard_map(
        body, mesh, in_specs=(sh, state_spec) + (rep,) * 12,
        out_specs=state_spec))


def _paths(hist: np.ndarray, lvl_off, rows: np.ndarray, depth: int):
    """Paths of node `rows` at level `depth` of a history segment that
    starts at the root, as bytes."""
    r = np.asarray(rows, dtype=np.int64)
    codes = np.zeros((r.shape[0], depth), dtype=np.int64)
    for j in range(depth, 0, -1):
        e = hist[int(lvl_off[j - 1]) + r]
        codes[:, j - 1] = e & 3
        r = e >> 2
    return [EXT[2 + row].tobytes() for row in codes]


def _by_path(live: dict):
    """The live state keyed by decoded path: its sorted (path, sid, lo, hi,
    rlo) pairs and (path, sid, freq, rlo, depth) staged rows."""
    pr, out = live["pr"], live["out"]
    at = _paths(live["hist"], live["lvl_off"], pr[:, PC_NID], live["depth"])
    pairs = sorted((p, int(s), int(a), int(b), int(c)) for p, s, a, b, c in
                   zip(at, pr[:, PC_SID], pr[:, PC_LO], pr[:, PC_HI],
                       pr[:, PC_RLO]))
    staged = []
    for dep in np.unique(out[:, ted.OC_DEPTH]):
        o = out[out[:, ted.OC_DEPTH] == dep]
        at = _paths(live["hist"], live["lvl_off"], o[:, ted.OC_ROW], int(dep))
        staged += [(p, int(s), int(f), int(r), int(dep)) for p, s, f, r in
                   zip(at, o[:, ted.OC_SID], o[:, ted.OC_FREQ],
                       o[:, ted.OC_RLO])]
    return pairs, sorted(staged)


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_level_matches_jax(indexes, case):
    cfg, prefix = LEVEL_CASES[case]
    d = len(indexes)
    jdev = JaxShardedIndexes.build(indexes, pad_to=2 * JAX_SHARDS)
    s_loc = jdev.S // JAX_SHARDS
    pdev = convert.sharded_tables_from_jax(jdev, cpu_mesh(JAX_SHARDS), d)
    mesh = cpu_mesh(JAX_SHARDS)
    # neither side hands off or drains: one level a call on both
    kw = dict(prefix_codes=prefix, tail_width=0, out_reserve=1 << 30)
    jsc = jed._Scalars.build(cfg, **kw)
    psc = ted._Scalars.build(convert.config_from_jax(cfg), **kw)
    step = _jax_sharded_level(d)
    jstate = jee._seed_sharded_episode(jdev, JAX_SHARDS, B, HIST_CAP)
    staged = 0
    for level in range(12):
        pst = convert.sharded_state_from_numpy(jax.device_get(jstate), s_loc,
                                               pdev)
        jstate = step(jdev.frowsT, jstate, *jsc.flat())
        jhost = jax.device_get(jstate)
        pflag = tee._level_sharded(pdev, psc, pst, mesh)
        want = convert.sharded_live_numpy(jhost, s_loc, d)
        got = convert.sharded_state_to_numpy(pst, pdev)
        where = f"{case} level {level}"
        assert pflag == int(jhost["flag"]), where
        for k in ("nnodes", "depth", "hist_len", "nlev", "total_paths"):
            assert got[k] == want[k], f"{where}: {k}"
        gp, go = _by_path(got)
        wp, wo = _by_path(want)
        assert gp == wp, where
        assert go == wo, where
        for k in ("ent_min", "ent_max"):
            if np.isfinite(want[k]):
                assert got[k] == pytest.approx(want[k], rel=1e-5), where
            else:
                assert got[k] == want[k], where
        staged = len(wo)
        if want["nnodes"] == 0:
            break
    assert staged > 0, "the case never staged a row: it tests too little"


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_level_matches_single_device(pidx, shards):
    """The sharded level against the single-device one, level by level
    from the root: the (node, symbol) numbering is the same, so the one
    pair list (but its table offsets; process-local sample ids are the
    global ones on one process), the history and the node starts are equal
    as they are, and so are the pairs and staged rows by decoded path."""
    cfg = convert.config_from_jax(MiningConfig(fmin=2, emax=1.5))
    sc = ted._Scalars.build(cfg, tail_width=0, out_reserve=1 << 30)
    mesh = cpu_mesh(shards)
    dev1 = DeviceIndexes.build(pidx, "cpu")
    devn = ShardedIndexes.build(pidx, mesh)
    st1 = ted._seed_episode(dev1, HIST_CAP)
    stn = tee._seed_sharded_episode(devn, HIST_CAP)
    cols = [PC_LO, PC_HI, PC_RLO, PC_SID, PC_NID]
    for level in range(14):
        f1 = ted._level(dev1, sc, st1)
        fn = tee._level_sharded(devn, sc, stn, mesh)
        where = f"{shards} shards, level {level}"
        assert fn == f1, where
        assert (stn.nnodes, stn.depth, stn.hist_len, stn.lvl_off,
                stn.total_paths) == (st1.nnodes, st1.depth, st1.hist_len,
                                     st1.lvl_off, st1.total_paths), where
        live = tee._gather_live_pairs(stn, devn, mesh)
        np.testing.assert_array_equal(live[:, cols],
                                      st1.pairs.numpy()[:, cols], where)
        np.testing.assert_array_equal(stn.pairs.numpy()[:, cols],
                                      st1.pairs.numpy()[:, cols], where)
        np.testing.assert_array_equal(stn.hist[:stn.hist_len].numpy(),
                                      st1.hist[:st1.hist_len].numpy(), where)
        np.testing.assert_array_equal(stn.nb.numpy(), st1.nb.numpy(), where)
        got = convert.sharded_state_to_numpy(stn, devn)
        want = torch.cat(st1.out).numpy() if st1.out else got["out"][:0]
        np.testing.assert_array_equal(
            got["out"], want[np.lexsort((want[:, ted.OC_SID],
                                         want[:, ted.OC_ROW]))], where)
        assert _by_path(got) == _by_path(dict(
            pr=st1.pairs.numpy(), out=want, hist=st1.hist.numpy(),
            lvl_off=st1.lvl_off, depth=st1.depth)), where
        for a, b in ((stn.ent_min, st1.ent_min), (stn.ent_max, st1.ent_max)):
            if np.isfinite(float(b)):
                assert abs(float(a) - float(b)) < ENT_FP_TOL, where
    assert st1.ocount > 0


# ------------------------------------- (b) the kernels' plain versions --

def _random_level(rng, S: int, U: int):
    """A node-sorted pair list over S samples: nodes of 0..S pairs, with
    ascending sample ids."""
    pairs, sizes = [], []
    for u in range(U):
        own = np.flatnonzero(rng.random(S) < rng.choice([0.0, 0.3, 0.9]))
        sizes.append(own.size)
        pairs += [(u, s) for s in own]
    nid, sid = (np.array(pairs, dtype=np.int32).reshape(-1, 2).T
                if pairs else np.zeros((2, 0), dtype=np.int32))
    P = nid.shape[0]
    freq = rng.integers(0, 3000, size=P).astype(np.int32)
    freq[rng.random(P) < 0.15] = 0
    cbits = (rng.integers(0, 16, size=P) * (freq > 0)).astype(np.uint8)
    return nid, sid, freq, cbits


def _nb(nid: np.ndarray, U: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.bincount(nid, minlength=U))]
                          ).astype(np.int32)


def _bounds(S: int, n: int) -> np.ndarray:
    return np.array([k * S // n for k in range(n + 1)])


SPLITS = [(5, 1), (5, 2), (5, 4), (5, 5), (5, 7), (3, 2), (12, 5)]


@pytest.mark.parametrize("S,n", SPLITS)
def test_partials_and_gates_match_segstats(S, n):
    """The partial rows of a list are the rows of its samples' parts (n
    processes' lists) added up, as the merge over processes adds them; the
    summed rows gate as segstats gates the list, and the level's values
    match segstats' sums: the kept lanes, children, present nodes, gated
    pairs, the entropy range within ENT_FP_TOL, the pair gates, and the
    rows staged after the emit.  (5, 4) has one-sample parts, (5, 7)
    empty ones."""
    rng = np.random.default_rng(100 * S + n)
    t = torch.from_numpy
    for trial in range(6):
        U = int(rng.integers(1, 300))
        nid, sid, freq, cbits = _random_level(rng, S, U)
        bounds = _bounds(S, n)
        owns = [(sid >= bounds[k]) & (sid < bounds[k + 1]) for k in range(n)]
        nb = t(_nb(nid, U))
        ocount = int(rng.integers(0, 1000))
        for depth, sym_mask, pmin in ((0, 0b1111, 2), (4, 0b1111, 2),
                                      (9, 0b0100, 1), (9, 0, 2)):
            vals = level_values("cpu")
            part, kept = shard_partials_plain(nb, t(freq), t(cbits),
                                              sym_mask)
            kept_slot(vals).copy_(kept)
            parts = [shard_partials_plain(t(_nb(nid[own], U)), t(freq[own]),
                                          t(cbits[own]), sym_mask)
                     for own in owns]
            assert torch.equal(part, sum(p for p, _k in parts))
            assert float(kept) == sum(float(k) for _p, k in parts)
            g = Gates(depth=depth, s_total=S, mindepth=3, pmin=pmin, pmax=4,
                      use_egate=True, sym_mask=sym_mask, emin_lo=0.2,
                      emax_hi=1.6)
            want_flags, want_ent, want_po, sums = segstats_plain(
                nb, t(freq), t(cbits), g)
            hist = torch.full((4 * U,), -1, dtype=torch.int32)
            flags, ent, kid0, pair_out = node_gates_plain(
                part, g, hist, nb, nid.shape[0], ocount, vals)
            # a gate within ENT_FP_TOL of its threshold may fall either way
            near = ((want_ent - g.emin_lo).abs() < ENT_FP_TOL) | \
                ((want_ent - g.emax_hi).abs() < ENT_FP_TOL)
            assert not near.any()
            np.testing.assert_array_equal((flags & FLAG_BITS).numpy(),
                                          want_flags.numpy())
            assert float((ent - want_ent).abs().max()) < ENT_FP_TOL
            nact = np.bincount(nid[freq > 0], minlength=U)
            np.testing.assert_array_equal((flags >> NACT_SHIFT).numpy(), nact)
            ex = ((want_flags.numpy()[:, None] >> (4 + np.arange(4))) & 1)
            entries = np.flatnonzero(ex.reshape(-1))
            np.testing.assert_array_equal(hist[:entries.size].numpy(),
                                          entries)
            assert (hist[entries.size:] == -1).all()
            np.testing.assert_array_equal(
                kid0.numpy(), np.cumsum(ex.sum(1)) - ex.sum(1))
            # the level's values against segstats' sums of the whole list
            got, want = vals.tolist(), sums.tolist()
            assert got[V_KEPT] == want[S_KEPT]
            assert got[V_CHILDREN] == want[S_CHILDREN] == entries.size
            assert got[V_PRESENT] == want[S_PRESENT]
            assert got[V_GATED] == want[S_GATED] == int(pair_out.sum())
            for key, skey in ((V_ENT_MIN, S_ENT_MIN), (V_ENT_MAX, S_ENT_MAX)):
                if np.isfinite(want[skey]):
                    assert abs(got[key] - want[skey]) < ENT_FP_TOL
                else:
                    assert got[key] == want[skey]
            np.testing.assert_array_equal(pair_out.numpy(), want_po.numpy())
            assert got[V_STAGED] == ocount + want[S_GATED]
            # a short history drops the entries past its room
            short = torch.full((entries.size // 2,), -1, dtype=torch.int32)
            node_gates_plain(part, g, short, nb, nid.shape[0], ocount, vals)
            assert vals[V_CHILDREN] == entries.size
            np.testing.assert_array_equal(short.numpy(),
                                          entries[:entries.size // 2])


@pytest.mark.parametrize("S,n", SPLITS)
def test_children_ids_match_numpy(S, n):
    """The outside-ids children step of every shard against a numpy
    statement, and the shards together against the single-list step."""
    rng = np.random.default_rng(200 * S + n)
    t = torch.from_numpy
    for trial in range(6):
        U = int(rng.integers(1, 200))
        nid, sid, _freq, _cbits = _random_level(rng, S, U)
        P = nid.shape[0]
        pairs = rng.integers(-2**31, 2**31, size=(P, 6)).astype(np.int32)
        pairs[:, PC_NID], pairs[:, PC_SID] = nid, sid
        olo = rng.integers(-2**31, 2**31 - 5000, size=(8, P)).astype(np.int32)
        ohi = (olo + rng.integers(0, 5000, size=(8, P))).astype(np.int32)
        keep = rng.random((4, P)) < 0.4
        lane = nid[None, :].astype(np.int64) * 4 + np.arange(4)[:, None]
        kids = np.unique(lane[keep])                 # the existing children
        ex = np.zeros(4 * U, dtype=np.int64)
        ex[kids] = 1
        ex = ex.reshape(U, 4)
        flags = ((ex << np.arange(4)).sum(1) << 4 | 7).astype(np.int32)
        kid0 = (np.cumsum(ex.sum(1)) - ex.sum(1)).astype(np.int32)
        hist = torch.zeros(kids.size, dtype=torch.int32)
        whole, _ = children_plain(t(_nb(nid, U)), t(pairs), t(olo), t(ohi),
                                  t(keep), int(keep.sum()), kids.size, hist)
        whole = whole.numpy()
        bounds = _bounds(S, n)
        seen = []
        for k in range(n):
            own = (sid >= bounds[k]) & (sid < bounds[k + 1])
            kp = np.ascontiguousarray(keep[:, own])
            newp, nb_next = children_ids_plain(
                t(_nb(nid[own], U)), t(pairs[own]),
                t(np.ascontiguousarray(olo[:, own])),
                t(np.ascontiguousarray(ohi[:, own])), t(kp), t(flags),
                t(kid0), int(kp.sum()), kids.size)
            newp, nb_next = newp.numpy(), nb_next.numpy()
            # numpy statement: the kept lanes sorted by (child, pair)
            c, p = np.nonzero(kp)
            child = np.searchsorted(kids, lane[:, own][c, p])
            order = np.lexsort((p, child))
            c, p, child = c[order], p[order], child[order]
            po = pairs[own]
            want = np.stack([
                olo[:, own][c, p], ohi[:, own][c, p],
                po[p, PC_RLO] + ohi[:, own][4 + c, p] - olo[:, own][4 + c, p],
                po[p, PC_SID], po[p, 4], child], axis=1).astype(np.int32)
            np.testing.assert_array_equal(newp, want)
            np.testing.assert_array_equal(
                nb_next, np.searchsorted(child, np.arange(kids.size + 1)))
            seen.append(newp)
        both = np.concatenate(seen)
        both = both[np.lexsort((both[:, PC_SID], both[:, PC_NID]))]
        np.testing.assert_array_equal(both, whole)


def test_gather_pack_matches_numpy():
    rng = np.random.default_rng(300)
    for C, sid_col, with_lc in ((5, 2, True), (6, 3, False)):
        for sizes in ([4, 0, 7], [0], [0, 0, 3], [1], [5, 5, 5, 5, 0]):
            blocks = [rng.integers(-1000, 1000, size=(m, C)).astype(np.int32)
                      for m in sizes]
            bases = [int(b) for b in rng.integers(0, 400, size=len(sizes))]
            lcs = [rng.integers(0, 6, size=m).astype(np.int8) for m in sizes]
            rows, lc = gather_pack_plain(
                [torch.from_numpy(b.copy()) for b in blocks], bases, sid_col,
                [torch.from_numpy(x) for x in lcs] if with_lc else None)
            want = np.concatenate(blocks)
            want[:, sid_col] += np.repeat(bases, sizes).astype(np.int32)
            np.testing.assert_array_equal(rows.numpy(), want)
            if with_lc:
                np.testing.assert_array_equal(lc.numpy(),
                                              np.concatenate(lcs))
            else:
                assert lc is None


@pytest.mark.parametrize("C,sid_col,with_lc", [(5, 2, True), (6, 3, False)])
def test_gather_pack_many_blocks_at_offsets_matches_numpy(C, sid_col,
                                                         with_lc):
    """More blocks than one launch's table holds (a third of them empty),
    each a slice of one larger tensor at an offset of a few words, and
    codes sliced at any byte."""
    rng = np.random.default_rng(301 + C)
    nblk = 2 * MAX_BLOCKS + 37
    sizes = rng.integers(0, 9, size=nblk) * (rng.random(nblk) > 1 / 3)
    big = rng.integers(-2**31, 2**31, size=int(sizes.sum()) * C + 4 * nblk,
                       dtype=np.int64).astype(np.int32)
    big_lc = rng.integers(0, 6, size=big.shape[0]).astype(np.int8)
    big_t, big_lc_t = torch.from_numpy(big), torch.from_numpy(big_lc)
    blocks, lcs, want, want_lc, w = [], [], [], [], 0
    for m in sizes.tolist():
        w += int(rng.integers(0, 4))         # a gap of 0-3 words
        blocks.append(big_t[w:w + m * C].view(m, C))
        lcs.append(big_lc_t[w:w + m])
        want.append(big[w:w + m * C].reshape(m, C))
        want_lc.append(big_lc[w:w + m])
        w += m * C
    offsets = {(b.data_ptr() // 4) % 4 for b, m in zip(blocks, sizes) if m}
    assert len(offsets) == 4                # every 4-byte offset mod 16
    bases = [int(b) for b in rng.integers(0, 2**20, size=nblk)]
    rows, lc = gather_pack_plain(blocks, bases, sid_col,
                                 lcs if with_lc else None)
    want = np.concatenate(want)
    want[:, sid_col] += np.repeat(bases, sizes).astype(np.int32)
    np.testing.assert_array_equal(rows.numpy(), want)
    if with_lc:
        np.testing.assert_array_equal(lc.numpy(), np.concatenate(want_lc))
    else:
        assert lc is None
    np.testing.assert_array_equal(big_t.numpy(), big)   # left as it was


@pytest.mark.parametrize("shards", [1, 2, 3, 5, 7])
def test_drain_leftchar_over_shards_matches_single_device(pidx, shards):
    """The sharded drain's leftChar: rows with global sample ids, packed in
    shard order, coded over the process's shard tables (slices of the same
    indexes; 7 shards of 5 samples leave two empty) equal the codes of the
    single-device tables."""
    rng = np.random.default_rng(410 + shards)
    dev = DeviceIndexes.build(pidx, "cpu")
    sh = ShardedIndexes.build(pidx, cpu_mesh(shards))
    k = 5000
    rows = np.zeros((k, ted.OUT_COLS), dtype=np.int32)
    sid = np.sort(rng.integers(0, dev.S, size=k))
    n = dev.ns[sid]
    rlo = (rng.random(k) * (n + 1)).astype(np.int64)
    freq = (rng.random(k) * np.minimum(n - rlo + 1, 50)).astype(np.int64)
    freq[::9] = 0
    rows[:, ted.OC_FREQ], rows[:, ted.OC_RLO], rows[:, ted.OC_SID] = \
        freq, rlo, sid
    rows_t = torch.from_numpy(rows)
    want = leftchar_rows([(dev.rrows, dev.soff, 0)], rows_t)
    got = leftchar_rows([(sd.rrows, sd.soff, sh.base(j))
                         for j, sd in enumerate(sh.shards)], rows_t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert set(np.unique(want.numpy())) >= {0, 1}


@pytest.mark.parametrize("gated", [[1], [3000, 3000, 3001], [5, 9000, 7]])
def test_stage_shard_appends_to_one_buffer(gated):
    """A process's emits land in one staging buffer, level after level: it
    doubles when a level's rows do not fit (from STAGE_ROWS on), and its
    live rows equal the levels' emitted rows one after another."""
    from dsm_tpu_torch.ops.compact import stage_rows_plain

    rng = np.random.default_rng(len(gated) + sum(gated))
    st = tee._fresh_state(torch.zeros((0, 6), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), 0, 1)
    want = []
    for depth, n in enumerate(gated):
        p = 2 * n + 3
        st.pairs = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(p, 6), dtype=np.int64).astype(np.int32))
        mark = np.zeros(p, dtype=bool)
        mark[rng.choice(p, size=n, replace=False)] = True
        pair_out = torch.from_numpy(mark)
        want.append(stage_rows_plain(pair_out, st.pairs, depth, n)[0])
        tee._stage(st, pair_out, n, depth)
        assert st.ocount == sum(gated[:depth + 1])
        assert st.out.shape[0] >= max(st.ocount, tee.STAGE_ROWS)
    assert torch.equal(st.out[:st.ocount], torch.cat(want))


def _random_pairs(rng, ns: np.ndarray, k: int) -> np.ndarray:
    """k pair rows over samples of lengths `ns`, sorted by sample: intervals
    within each sample's text (an eighth of them empty), random rlo."""
    S = ns.shape[0]
    pairs = np.zeros((k, 6), dtype=np.int32)
    sid = np.sort(rng.integers(0, S, size=k))
    n = ns[sid]
    lo = (rng.random(k) * (n + 1)).astype(np.int64)
    hi = lo + (rng.random(k) * (n - lo + 1)).astype(np.int64)
    hi[::8] = lo[::8]
    pairs[:, PC_LO], pairs[:, PC_HI], pairs[:, PC_SID] = lo, hi, sid
    pairs[:, PC_RLO] = rng.integers(0, 1 << 20, size=k)
    pairs[:, PC_NID] = np.arange(k)
    return pairs


def expand_tables_matches_single(pidx, shards: int, seed: int,
                                 k: int = 3000) -> None:
    """The multi-table expand over `shards` shard tables of `pidx` (the
    pairs' PC_SOFF offsets into their own shard's table) against the
    single-table expand of each shard's pairs and of the unsharded tables
    (PC_SOFF into the stacked table): every output equal."""
    rng = np.random.default_rng(seed)
    one = DeviceIndexes.build(pidx, "cpu")
    devn = ShardedIndexes.build(pidx, cpu_mesh(shards))
    pairs = _random_pairs(rng, one.ns, k)
    whole = pairs.copy()
    whole[:, 4] = one.soff.numpy()[pairs[:, PC_SID]]
    pairs[:, 4] = devn.local_soff().numpy()[pairs[:, PC_SID]]
    fmin, sym_mask = 2, 0b1011
    got = expand_tables_plain(devn.expand_tables(), torch.from_numpy(pairs),
                              fmin, sym_mask)
    want = expand_plain(one.frows, torch.from_numpy(whole), fmin, sym_mask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for j, (frows, base) in enumerate(devn.expand_tables()):
        mine = ((pairs[:, PC_SID] >= base)
                & (pairs[:, PC_SID] < base + devn.shards[j].S))
        own = expand_plain(frows, torch.from_numpy(pairs[mine]), fmin,
                           sym_mask)
        for a, b in zip(got, own):
            assert torch.equal(a[..., torch.from_numpy(mine)], b)
    assert bool(got[3].any()) and not bool(got[3].all())


@pytest.mark.parametrize("shards", [1, 2, 3, 5, 7])
def test_expand_tables_matches_single_table(pidx, shards):
    """The multi-table expand at 1, 2, 3, 5 and 7 shards of the toydata (7
    shards of 5 samples: two empty)."""
    expand_tables_matches_single(pidx, shards, 600 + shards)


@pytest.mark.parametrize("shards", [1, 2, 5, 8])
def test_level_launches_each_kernel_once(pidx, shards, monkeypatch):
    """A sharded level calls the multi-table expand, the partials, the
    gates and the children step once each at any shard count, and the emit
    once where it gates a pair; a drain the gather and leftChar once each
    (the wrappers' calls counted, as the card counts their launches)."""
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(tee, name, wrapped)

    for name in ("expand_tables", "shard_partials", "node_gates",
                 "stage_rows", "children_ids", "gather_pack",
                 "leftchar_rows"):
        counting(name, getattr(tee, name))
    cfg = convert.config_from_jax(MiningConfig(fmin=2, emax=1.5))
    sc = ted._Scalars.build(cfg, tail_width=0, out_reserve=1 << 30)
    mesh = cpu_mesh(shards)
    dev = ShardedIndexes.build(pidx, mesh)
    st = tee._seed_sharded_episode(dev, HIST_CAP)
    staged = 0
    for level in range(10):
        calls.clear()
        before = st.ocount
        flag = tee._level_sharded(dev, sc, st, mesh)
        emitted = int(st.ocount > before)
        staged += emitted
        assert calls == {"expand_tables": 1, "shard_partials": 1,
                         "node_gates": 1, "children_ids": 1,
                         **({"stage_rows": 1} if emitted else {})}, level
        if flag == ted.FLAG_DONE:
            break
    assert staged > 2
    calls.clear()
    out = tee.MinedOutput(freq_histogram=np.zeros(dev.S, dtype=np.int64))
    assert tee._drain_sharded(out, cfg, dev.S, st, ted.PathHistory(), 0,
                              dev, mesh)
    assert calls == {"gather_pack": 1, "leftchar_rows": 1}


@pytest.mark.parametrize("how", ["mesh", "DSM_SHARDS"])
def test_too_many_shards_refused_before_any_table(pidx, monkeypatch, how):
    """More than MAX_SHARDS shards a process: refused with the reason
    before a table is built or uploaded (on a CUDA mesh too, which needs no
    card to be named)."""
    def build(*_a, **_k):
        raise AssertionError("tables built before the shard count was "
                             "checked")

    monkeypatch.setattr(tee.ShardedIndexes, "build", build)
    monkeypatch.setattr(DeviceIndexes, "from_host", build)  # every upload
    if how == "mesh":
        kw = dict(mesh=SamplesMesh(None, 0, 1, MAX_SHARDS + 1,
                                   torch.device("cuda")))
    else:
        monkeypatch.setenv("DSM_SHARDS", str(MAX_SHARDS + 1))
        kw = dict(device="cpu")
    with pytest.raises(ValueError, match=f"at most {MAX_SHARDS}"):
        tee.mine_device_sharded(pidx, convert.config_from_jax(CFG), **kw)
    # the limit itself passes the check and goes on to build the tables
    monkeypatch.setenv("DSM_SHARDS", str(MAX_SHARDS))
    with pytest.raises(AssertionError, match="tables built"):
        tee.mine_device_sharded(pidx, convert.config_from_jax(CFG),
                                device="cpu")


# ------------------------------------------------------- (c) the slice --

@pytest.fixture(scope="module")
def jax_sharded(indexes):
    """dsm_tpu's `mine_device_sharded` on a 4-device mesh, once."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("samples",))
    return {
        "default": jee.mine_device_sharded(indexes, CFG, mesh=mesh),
        "one": jee.mine_device_sharded(indexes, CFG_ONE, mesh=mesh),
        "gnu": jee.mine_device_sharded(indexes, CFG, mesh=mesh,
                                       reader_order="gnu"),
    }, mesh


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("config", ["default", "one"])
def test_episode_sharded_full_depth(indexes, pidx, jax_sharded, config,
                                    shards):
    cfg = {"default": CFG, "one": CFG_ONE}[config]
    got = port(pidx, cfg, shards)
    assert got.total_output > 0
    assert_same(got, mine_np(indexes, cfg), entropy_tol=ENT_FP_TOL)
    assert_same(got, jax_sharded[0][config], entropy_tol=ENT_FP_TOL)


@pytest.mark.parametrize("prefix", [b"A", b"GA"])
def test_episode_sharded_prefix(indexes, pidx, prefix):
    """8 shards of 5 samples: three of them hold no sample."""
    got = port(pidx, CFG, 8, prefix=prefix)
    assert_same(got, mine_np(indexes, CFG, prefix=prefix))


def test_episode_sharded_gnu(indexes, pidx, jax_sharded):
    got = port(pidx, CFG, 4, reader_order="gnu")
    assert_same(got, mine_np(indexes, CFG, reader_order="gnu"))
    assert_same(got, jax_sharded[0]["gnu"])


def test_episode_sharded_histfull(indexes, pidx, monkeypatch):
    """A small history: the run drains, pulls the one history a process
    and goes on, many times."""
    pulls = []
    orig = ted._pull_segment
    monkeypatch.setattr(ted, "_pull_segment",
                        lambda *a: (pulls.append(a[2].depth), orig(*a)))
    monkeypatch.setenv("DSM_HIST_CAP", "30000")
    assert_same(port(pidx, CFG, 3), mine_np(indexes, CFG),
                entropy_tol=ENT_FP_TOL)
    assert len(pulls) > 3


def test_too_many_samples_is_refused(pidx):
    with pytest.raises(ValueError, match="at most 512"):
        port([pidx[0]] * 513, CFG, 2)


class _Abort(RuntimeError):
    pass


def _keep_snapshots(monkeypatch, mod, kept: str, abort_at=None):
    """Wrap `mod.save_checkpoint`: copy every snapshot to `kept`, raise
    _Abort after the abort_at-th."""
    orig = mod.save_checkpoint
    calls = []

    def wrapped(path, *a, **kw):
        orig(path, *a, **kw)
        calls.append(path)
        shutil.copy(path, kept)
        if abort_at is not None and len(calls) >= abort_at:
            raise _Abort()

    monkeypatch.setattr(mod, "save_checkpoint", wrapped)
    return calls


def test_episode_sharded_checkpoint_resume(indexes, pidx, tmp_path,
                                           monkeypatch):
    """A run with a tiny drain threshold writes snapshots; its last
    mid-flight one is kept and resumed from."""
    want = mine_np(indexes, CFG)
    ck, kept = str(tmp_path / "shard.ckpt"), str(tmp_path / "kept.ckpt")
    calls = _keep_snapshots(monkeypatch, pckpt, kept)
    first = port(pidx, CFG, 4, checkpoint=ck, out_reserve=16)
    monkeypatch.undo()
    assert_same(first, want)
    assert len(calls) > 2, "too few snapshots were written"
    assert not os.path.exists(ck), "a finished run removes its snapshot"
    shutil.copy(kept, ck)
    assert_same(port(pidx, CFG, 4, checkpoint=ck), want)
    assert not os.path.exists(ck)


def _killed_snapshot(monkeypatch, mod, run, ck: str, abort_at: int) -> None:
    _keep_snapshots(monkeypatch, mod, ck + ".kept", abort_at)
    with pytest.raises(_Abort):
        run(checkpoint=ck, out_reserve=16)
    monkeypatch.undo()
    assert os.path.exists(ck)


def _port_single(pidx, **kw):
    return ted.mine_device(pidx, convert.config_from_jax(CFG), device="cpu",
                           **kw)


@pytest.mark.parametrize("writer,reader", [
    ("port-4", "port-1dev"), ("port-1dev", "port-3"), ("port-4", "port-3"),
    ("jax-4", "port-3"), ("port-4", "jax-4"), ("port-4", "jax-1dev"),
    ("jax-1dev", "port-3")])
def test_snapshot_resumes_elsewhere(indexes, pidx, jax_sharded, tmp_path,
                                    monkeypatch, writer, reader):
    """A snapshot holds global sample ids in (node, sample) order: killed
    after its second save, a run resumes in the other engine (sharded or
    single-device), at another shard count and in the other package."""
    jmesh = jax_sharded[1]
    runs = {
        "port-4": (pckpt, lambda **kw: port(pidx, CFG, 4, **kw)),
        "port-3": (pckpt, lambda **kw: port(pidx, CFG, 3, **kw)),
        "port-1dev": (pckpt, lambda **kw: _port_single(pidx, **kw)),
        "jax-4": (jckpt, lambda **kw: jee.mine_device_sharded(
            indexes, CFG, mesh=jmesh, **kw)),
        "jax-1dev": (jckpt, lambda **kw: jed.mine_device(indexes, CFG, **kw)),
    }
    ck = str(tmp_path / "x.ckpt")
    mod, run = runs[writer]
    _killed_snapshot(monkeypatch, mod, run, ck, 2)
    got = runs[reader][1](checkpoint=ck)
    assert_same(got, mine_np(indexes, CFG))
    assert not os.path.exists(ck)


def test_resume_mid_burst_snapshot(tmp_path, monkeypatch):
    """dsm_tpu may snapshot inside a level it emits in chunks (st_eskip >
    0: the nodes whose cumulative gated pairs end at or below it are
    drained); the sharded port resumes it, counting GLOBAL pairs a node."""
    rng = np.random.default_rng(1234)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=600)]
    idxs = [FMIndex.from_texts(
        [transform(genome[int(rng.integers(0, 500)):][:90].tobytes())
         for _ in range(14)]) for _ in range(3)]
    cfg = MiningConfig(fmin=1, emax=99, pmin=1)
    ck = str(tmp_path / "burst.ckpt")
    orig = jckpt.save_checkpoint

    def stop_mid_burst(path, *a, **kw):
        orig(path, *a, **kw)
        with np.load(path) as z:
            if int(z["st_eskip"]) > 0:
                raise _Abort()

    monkeypatch.setattr(jed, "EMIT_W", 4)   # >= the 3 pairs of a node
    jed._jitted_episode.cache_clear()
    try:
        monkeypatch.setattr(jckpt, "save_checkpoint", stop_mid_burst)
        with pytest.raises(_Abort):
            jed.mine_device(idxs, cfg, checkpoint=ck, tail_width=0)
    finally:
        monkeypatch.undo()
        jed._jitted_episode.cache_clear()
    got = port([convert.fmindex_from_jax(i) for i in idxs], cfg, 2,
               checkpoint=ck, tail_width=0)
    want = mine_np(idxs, cfg)
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_occs) == (want.total_paths,
                                                 want.total_occs)


# ------------------------------------------------ (d) two gloo processes --

def test_two_gloo_processes(indexes, tmp_path):
    """2 processes x 2 shards over gloo: the per-level all-reduce and the
    drains' all-gathers cross the process boundary, rank 0 writes the
    snapshots, and every process ends with the full output."""
    # one thread a process: two processes that each take every core for
    # their tensor operations slow each other down several times
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("DSM_SHARDS", None)
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
        assert not (tmp_path / f"{order}.ckpt").exists()


# ------------------------------------------------------------ (e) the CLI --

def test_cli_mine_sharded_matches_golden(indexes, tmp_path, monkeypatch,
                                         capsysbinary):
    """`mine --engine sharded --reader-order gnu --prefix A` with
    DSM_SHARDS=8 (a (4, 2) mesh, as `dsm mine --engine sharded` takes on
    eight devices) prints the reference server's frozen output for A."""
    paths = []
    for i, idx in enumerate(indexes):
        paths.append(str(tmp_path / f"toy{i}.dsmi"))
        idx.save(paths[-1])
    monkeypatch.setenv("DSM_SHARDS", "8")
    assert port_main(["mine", "--engine", "sharded", "--reader-order", "gnu",
                      "-f", "2", "-E", "1.2", "--prefix", "A", "--device",
                      "cpu", *paths]) == 0
    with gzip.open(os.path.join(HERE, "golden",
                                "server-output.default.A.txt.gz")) as f:
        assert capsysbinary.readouterr().out == f.read()


@pytest.mark.parametrize("engine", ["sharded-episode", "sharded"])
def test_cli_mine_sharded(indexes, tmp_path, monkeypatch, capsysbinary,
                          engine):
    """`mine --engine sharded-episode --device cpu` with DSM_SHARDS=2
    prints what `dsm mine` prints, with --checkpoint from scratch and from
    a snapshot left by an aborted dsm_tpu run of the same mine.  `mine
    --engine sharded` with DSM_SHARDS=2 runs the per-level mesh engine
    (`mine_sharded` on default_mesh_shape(2) = a (2, 1) mesh), prints what
    `dsm mine --engine sharded` prints and, as that does, takes no
    snapshot: --checkpoint leaves no file."""
    paths = []
    for i, idx in enumerate(indexes):
        paths.append(str(tmp_path / f"toy{i}.dsmi"))
        idx.save(paths[-1])
    args = ["mine", "-f", "2", "-E", "1.2", "-M", "9", *paths]
    if engine == "sharded":
        args += ["--engine", "sharded"]
    assert dsm_main(args) == 0
    want = capsysbinary.readouterr().out
    assert want
    ck = tmp_path / "cli.ckpt"
    monkeypatch.setenv("DSM_SHARDS", "2")
    if engine == "sharded":
        from dsm_tpu_torch.parallel import engine_sharded as pes

        meshes = []
        orig = pes.make_mesh
        monkeypatch.setattr(pes, "make_mesh", lambda *a, **k: (
            meshes.append(a), orig(*a, **k))[1])
        assert port_main([*args, "--device", "cpu", "--checkpoint",
                          str(ck)]) == 0
        assert capsysbinary.readouterr().out == want
        assert meshes == [(2, 1)] and not ck.exists()
        return
    seen = []
    orig = tee.global_samples_mesh
    monkeypatch.setattr(tee, "global_samples_mesh",
                        lambda n, device: (seen.append(n), orig(n, device))[1])
    port_args = [*args, "--engine", engine, "--device", "cpu",
                 "--checkpoint", str(ck)]
    assert port_main(port_args) == 0
    assert capsysbinary.readouterr().out == want
    assert seen == [2] and not ck.exists()
    cfg = MiningConfig(fmin=2, emax=1.2, maxdepth=9)
    _keep_snapshots(monkeypatch, jckpt, str(ck) + ".kept", abort_at=1)
    with pytest.raises(_Abort):
        jed.mine_device(indexes, cfg, checkpoint=str(ck), out_reserve=0)
    assert ck.exists()
    assert port_main(port_args) == 0
    assert capsysbinary.readouterr().out == want
    assert not ck.exists()
