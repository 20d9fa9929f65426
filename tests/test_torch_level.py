"""One trie level of the port (dsm_tpu_torch/mining/engine_device._level)
against dsm_tpu's `_level_single`, on the same episode state.

A JAX episode is seeded on a small 3-sample index, as
`__graft_entry__.entry()` does, and `_level_single` (jitted on the CPU)
runs level after level.  Before each level its state is converted to the
port's (convert.py) and the port's `_level` runs on it with CPU tensors
(the kernels' plain versions).  Exact: pair counts, node counts, the next
pair rows, the history entries, the node starts, the set of staged output
rows, total_paths and the exit flag.  The entropy min/max diagnostics are
float32 on the TPU path and float64 in the port: relative 1e-5.

The segstats kernel's plain version is also held against a numpy
statement of the same statistics (engine_np.node_entropy, the gates of
metaserver.cpp:403-417) and of the level's sums, and a level that ends
FLAG_HISTFULL against the state it started from.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining import engine_device as jed
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine import DeviceIndexes as JaxDeviceIndexes
from dsm_tpu.mining.engine_np import node_entropy
from dsm_tpu_torch import convert
from dsm_tpu_torch.mining import engine_device as ted
from dsm_tpu_torch.ops.segstats import (S_CHILDREN, S_ENT_MAX, S_ENT_MIN,
                                       S_GATED, S_KEPT, S_PRESENT, Gates,
                                       segstats)

HIST_CAP = 1 << 16
B = jed.DEV_MIN_CAP
CASES = {
    "default": (MiningConfig(fmin=2, emax=1.5), ()),
    "filtered": (MiningConfig(fmin=2, emax=99, pmin=1, pmax=2, mindepth=3),
                 ()),
    "prefix": (MiningConfig(fmin=2, emax=99, emin=0.3, pmin=1), (2, 0)),  # GA
}


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=700)]
    idxs = []
    for s in range(3):
        texts = [transform(genome[int(rng.integers(0, 400)):][:300].tobytes())
                 for _ in range(3)]
        texts.append(transform(bases[rng.integers(0, 4, size=500)].tobytes()))
        idxs.append(FMIndex.from_texts(texts))
    jdev = JaxDeviceIndexes.build(idxs)
    return jdev, convert.tables_from_device_indexes(jdev, "cpu")


@functools.cache
def _jax_level(s_total: int):
    def run(frowsT, state, *flat):
        return jed._level_single(B, frowsT, None, s_total,
                                 jed._Scalars(*flat), HIST_CAP, state)

    return jax.jit(run)


def _rows_sorted(a):
    return a[np.lexsort(a.T[::-1])] if a.shape[0] else a


@pytest.mark.parametrize("case", list(CASES))
def test_level_matches_jax(tiny, case):
    jdev, pdev = tiny
    cfg, prefix = CASES[case]
    jsc = jed._Scalars.build(cfg, prefix_codes=prefix)
    psc = ted._Scalars.build(convert.config_from_jax(cfg),
                             prefix_codes=prefix)
    step = _jax_level(jdev.S)
    jstate = jed._seed_episode(jdev, B, HIST_CAP)
    emitted = 0
    for level in range(14):
        pst = convert.episode_state_from_numpy(jax.device_get(jstate), "cpu")
        jstate = step(jdev.frowsT, jstate, *jsc.flat())
        jhost = jax.device_get(jstate)
        pflag = ted._level(pdev, psc, pst)
        want = convert.live_numpy(jhost)
        got = convert.episode_state_to_numpy(pst)
        where = f"{case} level {level}"
        assert pflag == int(jhost["flag"]), where
        for k in ("npairs", "nnodes", "depth", "hist_len", "nlev", "ocount",
                  "total_paths"):
            assert got[k] == want[k], f"{where}: {k}"
        for k in ("pr", "nb", "hist", "lvl_off"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=where)
        np.testing.assert_array_equal(_rows_sorted(got["out"]),
                                      _rows_sorted(want["out"]),
                                      err_msg=where)
        for k in ("ent_min", "ent_max"):
            if np.isfinite(want[k]):
                assert got[k] == pytest.approx(want[k], rel=1e-5), where
            else:
                assert got[k] == want[k], where
        emitted = want["ocount"]
        if want["nnodes"] == 0:
            break
    assert emitted > 0, "the case never emitted: it tests too little"


def _level_data(rng, S, U, lo, hi, single_share=0.3):
    """A level of U nodes of lo..hi pairs (S samples): nb, the node sizes,
    freq (a fifth of it 0, a share of the nodes with one reader of
    frequency 1 first) and cact (child bits of the active pairs)."""
    sizes = rng.integers(lo, hi + 1, size=U)
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(nb[-1])
    freq = rng.integers(0, 40, size=P).astype(np.int32)
    freq[rng.random(P) < 0.2] = 0
    freq[nb[:-1][rng.random(U) < single_share]] = 1
    cact = (rng.integers(0, 16, size=P) * (freq > 0)).astype(np.uint8)
    return nb, sizes, freq, cact


def _check_segstats(nb, sizes, freq, cact, S, g):
    """segstats (plain) against numpy: node_entropy in f64, the gates
    written out per node, and the level's sums.  -> the numpy stat mask."""
    flags, ent, pair_out, sums = segstats(torch.from_numpy(nb),
                                          torch.from_numpy(freq),
                                          torch.from_numpy(cact), g)
    U, P = sizes.size, int(nb[-1])
    node = np.repeat(np.arange(U), sizes)
    fmat = np.zeros((U, S), dtype=np.int64)
    fmat[node, np.arange(P) - nb[:-1][node]] = freq
    want_ent = node_entropy(fmat, S)
    np.testing.assert_allclose(ent.numpy(), want_ent, rtol=0, atol=1e-12)
    nact = (fmat > 0).sum(1)
    bits = (cact[:, None] >> np.arange(4)) & 1
    cnt4 = np.zeros((U, 4), dtype=np.int64)
    np.add.at(cnt4, node, bits)
    allowed = ((g.sym_mask >> np.arange(4)) & 1) > 0
    ex = (cnt4 > 0) & allowed
    single_full = (ex.sum(1) == 1) & ((cnt4 * ex).sum(1) == nact)
    present = (nact > 0) & (g.depth >= 1)
    gated = (present & (g.depth >= g.mindepth) & (nact >= g.pmin)
             & ((g.pmax == 0) | (nact <= g.pmax)) & (want_ent >= g.emin_lo)
             & (want_ent <= g.emax_hi) & ~single_full)
    stat = present & ~((nact == 1) & (g.pmin > 1))
    want_flags = (present.astype(np.int32) | (stat << 1) | (gated << 2)
                  | ((ex * (1 << np.arange(4))).sum(1) << 4))
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    np.testing.assert_array_equal(pair_out.numpy(), gated[node])
    assert sums.dtype == torch.float64 and sums.shape == (6,)
    got = sums.tolist()
    assert got[S_KEPT] == int((bits & allowed).sum())
    assert got[S_CHILDREN] == int(ex.sum())
    assert got[S_GATED] == int(gated[node].sum())
    assert got[S_PRESENT] == int(present.sum())
    assert got[S_ENT_MIN] == (want_ent[stat].min() if stat.any() else np.inf)
    assert got[S_ENT_MAX] == (want_ent[stat].max() if stat.any()
                              else -np.inf)
    return stat


def test_segstats_matches_numpy():
    """segstats (plain) against numpy: node_entropy in f64, the gates
    written out per node and the level's sums."""
    rng = np.random.default_rng(9)
    S, U = 5, 400
    nb, sizes, freq, cact = _level_data(rng, S, U, 1, S)
    for depth, sym_mask in ((0, 0b1111), (4, 0b1111), (9, 0b0100),
                            (9, 0)):
        g = Gates(depth=depth, s_total=S, mindepth=3, pmin=2, pmax=4,
                  use_egate=True, sym_mask=sym_mask, emin_lo=0.2,
                  emax_hi=1.6)
        _check_segstats(nb, sizes, freq, cact, S, g)


# (samples, nodes, pairs a node lo..hi, depth, sym_mask, pmin, pmax)
SUMS_CASES = {
    "1..5": (5, 400, 1, 5, 7, 0b1111, 2, 0),
    "1..273": (273, 60, 1, 273, 7, 0b1111, 2, 0),
    "sym_mask_0": (5, 400, 1, 5, 7, 0, 2, 0),
    "restricted": (64, 100, 1, 64, 7, 0b0100, 1, 20),
    "no_stat_node": (5, 400, 1, 5, 7, 0b1111, 2, 0),
}


@pytest.mark.parametrize("case", list(SUMS_CASES))
def test_segstats_sums_match_numpy(case):
    """The level's sums of segstats (plain) against numpy: kept lanes,
    children, gated pairs, present nodes and the entropy range, at nodes of
    1..5 and 1..273 pairs, with no symbol allowed, and at a level where no
    node counts for the entropy range (one active reader a node under
    pmin 2: +inf and -inf)."""
    S, U, lo, hi, depth, sym_mask, pmin, pmax = SUMS_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + hi)
    nb, sizes, freq, cact = _level_data(rng, S, U, lo, hi)
    if case == "no_stat_node":
        freq[:] = 0
        freq[nb[:-1][rng.random(U) < 0.7]] = 5
        cact = (rng.integers(0, 16, size=freq.size) * (freq > 0)
                ).astype(np.uint8)
    g = Gates(depth=depth, s_total=S, mindepth=3, pmin=pmin, pmax=pmax,
              use_egate=True, sym_mask=sym_mask, emin_lo=0.2, emax_hi=1.9)
    stat = _check_segstats(nb, sizes, freq, cact, S, g)
    assert stat.any() != (case == "no_stat_node")


def test_histfull_leaves_the_state_untouched(tiny, monkeypatch):
    """A level that ends FLAG_HISTFULL (a history of DSM_HIST_CAP entries)
    changes nothing of the state, the entropy range and total_paths among
    it: the level's sums are folded in only after the check."""
    _jdev, pdev = tiny
    monkeypatch.setenv("DSM_HIST_CAP", "96")
    psc = ted._Scalars.build(convert.config_from_jax(CASES["default"][0]))
    st = ted._seed_episode(pdev, ted._hist_cap(pdev))
    assert st.hist.shape[0] == 96
    for _ in range(20):
        before = convert.episode_state_to_numpy(st)
        flag = ted._level(pdev, psc, st)
        if flag == ted.FLAG_HISTFULL:
            break
        assert flag == ted.FLAG_RUN
    else:
        pytest.fail("no level ended FLAG_HISTFULL")
    assert before["hist_len"] > 0 and np.isfinite(before["ent_min"])
    after = convert.episode_state_to_numpy(st)
    for k, v in before.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(after[k], v, err_msg=k)
        else:
            assert after[k] == v, k
