"""The port across the sample axis, on the CPU: d = 64, 273 and 512
samples (the reference's MAX_READERS is 273, metaserver.cpp:19; dsm_tpu
takes up to MAX_SAMPLES = 512) mined by the port's plain path and by
dsm_tpu on the same seeded inputs.

(a) Tiny pools as in tests/test_engine_tpu.py's many-sample fixture (3
    texts of 60 bases a sample from a 400-base genome): the port's
    single-device episode (`mine_torch`) and its sharded episode
    (`mine_device_sharded`) at up to MAX_SHARDS = 128 shards against
    dsm_tpu's `mine_np`, ascending and gnu: emitted bytes, total_paths,
    total_output, total_occs and freq_histogram exactly, the entropy
    diagnostics within 5e-6.  d = 64 at full depth (1, 3 and 64 shards),
    d = 273 at maxdepth 8 (1, 2 and 128 shards), d = 512 at maxdepth 5 (1
    and 128 shards: nodes of 512 pairs, the most K3's tile holds).
(b) tests/freeze_samples_reference.py's generator at a small size: the
    port's build (`indexes_from_fasta` on the CPU) and mine against
    dsm_tpu's `FMIndex.from_texts` and `mine_np`, with lines that pass
    emax 1.2 from the planted repeats; the generator itself is seeded.
(c) A d = 64 snapshot written by the port and resumed by dsm_tpu, and the
    reverse, against `mine_np`.
(d) `distance` at d = 64 on the mined rows against dsm_tpu's accumulator:
    exact mode equal, `exact=False` (the kernel's plain version) within
    1e-9.
(e) 513 samples are refused by the single-device episode before any table
    is built, naming the limits that bind.
At 128 shards the sharded level keeps one pair list and one partial row a
node a process, the sizes of the single-shard level's; the multi-table
expand over 2 to 128 shard tables of d = 64 and 273 samples equals the
single-table expand; the gnu order's model of libstdc++'s set iterates as
dsm_tpu's at up to 512 readers.
"""

import os

import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining import checkpoint as jckpt
from dsm_tpu.mining import engine_device as jed
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_np import mine_np
from dsm_tpu.post import distance as jd
from dsm_tpu_torch import convert
from dsm_tpu_torch.index import indexes_from_fasta
from dsm_tpu_torch.mining import checkpoint as pckpt
from dsm_tpu_torch.mining import engine_device as ted
from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch
from dsm_tpu_torch.parallel import engine_episode as tee
from dsm_tpu_torch.parallel.multihost import global_samples_mesh
from dsm_tpu_torch.post import distance as pd
from freeze_samples_reference import make_samples

ENT_TOL = 5e-6      # the entropy diagnostics: f32 on dsm_tpu's device levels
ORDERS = ("ascending", "gnu")
# d -> (maxdepth, the shard counts of the sharded episode)
WIDTHS = {64: (None, (1, 3, 64)), 273: (8, (1, 2, 128)), 512: (5, (1, 128))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU episodes: the suite's
    workers share the cores, and an episode's many small ops each wait on
    every thread of the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pool_indexes(d: int, seed: int) -> list[FMIndex]:
    """d samples of 3 texts of 60 bases from one 400-base genome
    (tests/test_engine_tpu.py's many-sample fixture), dsm_tpu's FMIndex."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=400)]
    return [FMIndex.from_texts([transform(
        genome[int(rng.integers(0, 340)):][:60].tobytes()) for _ in range(3)])
        for _ in range(d)]


def config(d: int) -> MiningConfig:
    maxdepth = WIDTHS[d][0]
    return MiningConfig(fmin=2, emax=99) if maxdepth is None else \
        MiningConfig(fmin=2, emax=99, maxdepth=maxdepth)


@pytest.fixture(scope="module")
def pools():
    """d -> (dsm_tpu's indexes, the port's, {order: mine_np's output})."""
    cache = {}

    def get(d: int):
        if d not in cache:
            jidx = pool_indexes(d, seed=d)
            cache[d] = (jidx, [convert.fmindex_from_jax(i) for i in jidx],
                        {o: mine_np(jidx, config(d), reader_order=o)
                         for o in ORDERS})
        return cache[d]

    return get


def assert_same(got, want):
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
    assert got.total_output == want.total_output
    assert got.total_occs == want.total_occs
    np.testing.assert_array_equal(got.freq_histogram, want.freq_histogram)
    assert abs(got.smallest_entropy - want.smallest_entropy) < ENT_TOL
    assert abs(got.largest_entropy - want.largest_entropy) < ENT_TOL


# ------------------------------------------------------- (a) tiny pools --

CASES = [(d, shards, order) for d, (_m, counts) in WIDTHS.items()
         for shards in (0,) + counts for order in ORDERS]


@pytest.mark.parametrize(
    "d,shards,order", CASES,
    ids=[f"d{d}-{'single' if s == 0 else f'{s}shards'}-{o}"
         for d, s, o in CASES])
def test_many_samples_match_mine_np(pools, d, shards, order):
    jidx, pidx, want = pools(d)
    cfg = convert.config_from_jax(config(d))
    if shards == 0:
        got = mine_torch(pidx, cfg, reader_order=order, device="cpu")
    else:
        got = tee.mine_device_sharded(
            pidx, cfg, reader_order=order,
            mesh=global_samples_mesh(shards_per_rank=shards, device="cpu"))
    assert got.total_output > 0
    assert_same(got, want[order])


def test_nodes_hold_every_sample(pools):
    """The pools' levels hold nodes of d pairs: the d = 512 trie's first
    levels are nodes of 512 pairs, the most K3's tile holds."""
    _jidx, pidx, _want = pools(512)
    from dsm_tpu_torch.mining.config import MiningConfig as PortConfig
    from dsm_tpu_torch.mining.engine_device import (_hist_cap, _level,
                                                    _Scalars, _seed_episode)

    dev = DeviceIndexes.build(pidx, "cpu")
    sc = _Scalars.build(PortConfig(fmin=2, emax=99, maxdepth=5))
    st = _seed_episode(dev, _hist_cap(dev))
    widest = []
    for _ in range(3):
        _level(dev, sc, st)
        widest.append(int((st.nb[1:] - st.nb[:-1]).max()))
    assert max(widest) == 512


def test_sharded_level_keeps_one_partial_row_a_node(pools, monkeypatch):
    """At 128 shards a process the sharded level hands K9b one (U, 3) row a
    node and the process's one pair list: every level's rows, node starts
    and pairs have the sizes of the one-shard run's, so the level's memory
    does not grow with the shards a process."""
    _jidx, pidx, want = pools(273)
    orig = tee.node_gates

    def run(shards: int) -> list:
        seen = []

        def recording(part, g, hist, nb, P, ocount, vals):
            seen.append((tuple(part.shape), tuple(nb.shape), P))
            return orig(part, g, hist, nb, P, ocount, vals)

        monkeypatch.setattr(tee, "node_gates", recording)
        got = tee.mine_device_sharded(
            pidx, convert.config_from_jax(config(273)),
            mesh=global_samples_mesh(shards_per_rank=shards, device="cpu"))
        assert_same(got, want["ascending"])
        return seen

    many, one = run(128), run(1)
    assert many and many == one
    assert all(u == (nb[0] - 1, 3) for u, nb, _p in many)


@pytest.mark.parametrize("d,shards", [(64, 2), (64, 64), (273, 3),
                                      (273, 128)])
def test_expand_tables_over_many_samples(pools, d, shards):
    """The multi-table expand over the shard tables of d = 64 and 273
    samples (at 128 shards of 273, shards of 2 and 3 samples) against the
    single-table expand of each shard and of the unsharded tables."""
    from test_torch_sharded import expand_tables_matches_single

    _jidx, pidx, _want = pools(d)
    expand_tables_matches_single(pidx, shards, 700 + d + shards, k=20_000)


def test_gnu_hash_set_matches_dsm_tpu_at_512_readers():
    """The port's model of libstdc++'s unordered_set (an O(1) insert: a
    bucket's first node is the last key inserted into it) iterates as
    dsm_tpu's list scan does, over the reader counts of this file: the root
    order, and seeded insert sequences of up to 512 readers with
    repeats."""
    from dsm_tpu.mining import gnuorder as jgnu
    from dsm_tpu_torch.mining import gnuorder as pgnu

    for d in (64, 273, 512):
        assert pgnu.root_order(d) == jgnu.root_order(d)
    rng = np.random.default_rng(512)
    for _ in range(60):
        keys = rng.integers(0, 512, size=int(rng.integers(1, 700))).tolist()
        a, b = pgnu.GnuHashSet(), jgnu.GnuHashSet()
        for k in keys:
            a.insert(k)
            b.insert(k)
        assert a.order() == b.order() and len(a) == len(b)


# ---------------------------------------- (b) the generator's own data --

@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """make_samples at 3 samples, ~150k symbols: its FASTA files."""
    out = tmp_path_factory.mktemp("samples")
    return make_samples(str(out), 3, 150_000, seed=14)


def test_generator_is_seeded(generated, tmp_path):
    again = make_samples(str(tmp_path), 3, 150_000, seed=14)
    for a, b in zip(generated, again):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("order", ORDERS)
def test_generated_data_matches_dsm_tpu(generated, order):
    """The port's build and mine of make_samples' data against dsm_tpu's
    at emax 1.2: the planted repeats leave lines under the gate."""
    cfg = MiningConfig(fmin=2, emax=1.2)
    jidx = [FMIndex.from_texts([transform(r.seq) for r in read_fasta(f)])
            for f in generated]
    pidx = indexes_from_fasta(generated, "cpu")
    assert [i.n for i in pidx] == [i.n for i in jidx]
    want = mine_np(jidx, cfg, reader_order=order)
    got = mine_torch(pidx, convert.config_from_jax(cfg), reader_order=order,
                     device="cpu")
    assert want.total_output > 0
    assert_same(got, want)


# --------------------------------------------- (c) snapshots, d = 64 --

class _Abort(RuntimeError):
    pass


def _kill(monkeypatch, mod, run, ck: str, abort_at: int) -> None:
    """Run `run(ck)` with `mod.save_checkpoint` raising after save
    abort_at."""
    orig, calls = mod.save_checkpoint, []

    def wrapped(path, *a, **kw):
        orig(path, *a, **kw)
        calls.append(path)
        if len(calls) >= abort_at:
            raise _Abort()

    monkeypatch.setattr(mod, "save_checkpoint", wrapped)
    with pytest.raises(_Abort):
        run(ck)
    monkeypatch.undo()
    assert os.path.exists(ck)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_across_packages_at_64_samples(pools, tmp_path, monkeypatch,
                                              writer):
    jidx, pidx, want = pools(64)
    cfg = config(64)
    runs = {
        "port": (pckpt, lambda ck, **kw: mine_torch(
            pidx, convert.config_from_jax(cfg), reader_order="gnu",
            device="cpu", tail_width=0, checkpoint=ck, **kw)),
        "jax": (jckpt, lambda ck, **kw: jed.mine_device(
            jidx, cfg, reader_order="gnu", tail_width=0, checkpoint=ck,
            **kw))}
    reader = "jax" if writer == "port" else "port"
    ck = str(tmp_path / "many.ckpt")
    mod, run = runs[writer]
    _kill(monkeypatch, mod, lambda c: run(c, out_reserve=0), ck, 2)
    got = runs[reader][1](ck)
    assert got.format_lines() == want["gnu"].format_lines()
    assert got.total_paths == want["gnu"].total_paths
    assert got.total_occs == want["gnu"].total_occs
    assert not os.path.exists(ck)


# ------------------------------------------------ (d) distance, d = 64 --

def test_distance_at_64_samples_matches_dsm(pools):
    _jidx, pidx, _want = pools(64)
    rows = mine_torch(pidx, convert.config_from_jax(config(64)),
                      reader_order="gnu", device="cpu").format_lines()
    lines = rows.decode().splitlines()
    kw = dict(smpls=64, maxents=jd.entropy_steps(0.5))
    want = jd.DistanceAccumulator(**kw)
    want.add_lines(lines)
    want = want.matrices()
    assert int(want["noutput"].sum()) > 0
    exact = pd.DistanceAccumulator(**kw)
    exact.add_lines(lines)
    fast = pd.DistanceAccumulator(**kw, exact=False, device="cpu",
                                  chunk_rows=256)
    fast.add_lines(lines)
    for got, tol in ((exact.matrices(), 0), (fast.matrices(), 1e-9)):
        assert np.array_equal(got["count"], want["count"])
        assert np.array_equal(got["noutput"], want["noutput"])
        for kind in ("log", "sqrt", "lgamma"):
            np.testing.assert_allclose(got[kind], want[kind], rtol=tol,
                                       atol=tol, err_msg=kind)


# ------------------------------------------- (e) more than 512 samples --

def test_513_samples_refused_on_one_device(pools, monkeypatch):
    _jidx, pidx, _want = pools(512)

    def build(*_a, **_k):
        raise AssertionError("tables built before the sample count was "
                             "checked")

    monkeypatch.setattr(DeviceIndexes, "from_host", build)
    with pytest.raises(ValueError, match="at most 512") as e:
        mine_torch(pidx + pidx[:1], convert.config_from_jax(config(512)),
                   device="cpu")
    assert "512 pairs" in str(e.value) and "12-bit" in str(e.value)
