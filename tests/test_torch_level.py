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
metaserver.cpp:403-417).
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
from dsm_tpu_torch.ops.segstats import Gates, segstats

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
    psc = ted._Scalars.build(cfg, prefix_codes=prefix)
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


def test_segstats_matches_numpy():
    """segstats (plain) against numpy: node_entropy in f64, and the gates
    written out per node."""
    rng = np.random.default_rng(9)
    S, U = 5, 400
    sizes = rng.integers(1, S + 1, size=U)
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(nb[-1])
    freq = rng.integers(0, 40, size=P).astype(np.int32)
    freq[rng.random(P) < 0.2] = 0
    freq[nb[:-1][rng.random(U) < 0.3]] = 1      # single-reader nodes
    cact = (rng.integers(0, 16, size=P) * (freq > 0)).astype(np.uint8)
    for depth, sym_mask in ((0, 0b1111), (4, 0b1111), (9, 0b0100),
                            (9, 0)):
        g = Gates(depth=depth, s_total=S, mindepth=3, pmin=2, pmax=4,
                  use_egate=True, sym_mask=sym_mask, emin_lo=0.2,
                  emax_hi=1.6)
        flags, ent, pair_out = segstats(torch.from_numpy(nb),
                                        torch.from_numpy(freq),
                                        torch.from_numpy(cact), g)
        node = np.repeat(np.arange(U), sizes)
        fmat = np.zeros((U, S), dtype=np.int64)
        fmat[node, np.arange(P) - nb[:-1][node]] = freq
        want_ent = node_entropy(fmat, S)
        np.testing.assert_allclose(ent.numpy(), want_ent, rtol=0,
                                   atol=1e-12)
        nact = (fmat > 0).sum(1)
        bits = (cact[:, None] >> np.arange(4)) & 1
        cnt4 = np.zeros((U, 4), dtype=np.int64)
        np.add.at(cnt4, node, bits)
        ex = (cnt4 > 0) & (((sym_mask >> np.arange(4)) & 1) > 0)
        single_full = (ex.sum(1) == 1) & ((cnt4 * ex).sum(1) == nact)
        present = (nact > 0) & (depth >= 1)
        gated = (present & (depth >= g.mindepth) & (nact >= g.pmin)
                 & (nact <= g.pmax) & (want_ent >= g.emin_lo)
                 & (want_ent <= g.emax_hi) & ~single_full)
        stat = present & ~((nact == 1) & (g.pmin > 1))
        want_flags = (present.astype(np.int32) | (stat << 1) | (gated << 2)
                      | ((ex * (1 << np.arange(4))).sum(1) << 4))
        np.testing.assert_array_equal(flags.numpy(), want_flags)
        np.testing.assert_array_equal(pair_out.numpy(), gated[node])
