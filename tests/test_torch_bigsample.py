"""D4L's checks (chip_smoke.py phase 18: four metagenome samples of
2^25-2^27 symbols on the card) at a small size, on the CPU.

tests/freeze_samples_reference.py's `make_samples` at d = 4 and ~70k
symbols, built by `python -m dsm_tpu_torch build --device cpu` and mined
by the port's plain path, against dsm_tpu on the same FASTA files:

  * the CLI's .dsmi files hold dsm_tpu's index arrays; each index inverted
    (`FMIndex.extract_texts`) gives its FASTA's texts, as dsm_tpu's does;
    the host tables (`OccTable.build`, `fused_rows`) of each direction
    equal dsm_tpu's;
  * `python -m dsm_tpu_torch mine --device cpu` on the four files prints
    dsm_tpu's `mine_np` bytes in both reader orders, and so does
    `mine_torch`, with the same counters;
  * the phase's own checks: ascending and gnu carry the same lines; the
    four one-symbol prefix runs concatenated are the whole run; the
    episode under a two-symbol prefix to a maxdepth is the port's and
    dsm_tpu's `mine_np` there (gate (b)); 2 shards equal one device;
  * the size repair: `extract_texts` walks every text by one LF array
    (a stable sort of the BWT) and reads no block of the occ table a
    step, whose cost grew with texts x 128 bytes a step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform as jtransform
from dsm_tpu.index.fasta import read_fasta as jread_fasta
from dsm_tpu.index.fmindex import FMIndex as JFMIndex
from dsm_tpu.mining.config import MiningConfig as JMiningConfig
from dsm_tpu.mining.engine_np import mine_np as jmine_np
from dsm_tpu.ops import rank as jrank
from dsm_tpu_torch.index import fmindex
from dsm_tpu_torch.index.alphabet import encode, transform
from dsm_tpu_torch.index.fasta import read_fasta
from dsm_tpu_torch.index.fmindex import FMIndex
from dsm_tpu_torch.mining.config import MiningConfig
from dsm_tpu_torch.mining.engine import mine_torch
from dsm_tpu_torch.mining.engine_np import mine_np
from dsm_tpu_torch.ops import rank
from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
from dsm_tpu_torch.parallel.multihost import global_samples_mesh
from freeze_samples_reference import make_samples

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# one intra-op thread in the CLI's processes too: the suite's workers share
# the cores
ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
SYMBOLS, SEED = 70_000, 27
FMIN, PMIN, EMAX = 2, 2, 1.5
ORACLE = (b"AC", 12)       # gate (b)'s prefix and maxdepth at this size
ENT_TOL = 1e-9
SHARD_ENT_TOL = 1e-5       # K9a's fixed-point entropy range (2^-17 a pair)
ORDERS = ("ascending", "gnu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU episodes: the suite's
    workers share the cores, and an episode's many small ops each wait on
    every thread of the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(maxdepth: int | None = None) -> MiningConfig:
    kw = {} if maxdepth is None else dict(maxdepth=maxdepth)
    return MiningConfig(fmin=FMIN, pmin=PMIN, emax=EMAX, **kw)


def jcfg(maxdepth: int | None = None) -> JMiningConfig:
    kw = {} if maxdepth is None else dict(maxdepth=maxdepth)
    return JMiningConfig(fmin=FMIN, pmin=PMIN, emax=EMAX, **kw)


def cli(*args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "dsm_tpu_torch", *args],
                          env=ENV, cwd=REPO, capture_output=True, check=True)


@pytest.fixture(scope="module")
def d4(tmp_path_factory):
    """The set's FASTA files, the CLI's .dsmi files, the port's indexes
    loaded from them and dsm_tpu's built from the FASTA files."""
    out = str(tmp_path_factory.mktemp("d4"))
    fastas = make_samples(out, 4, SYMBOLS, SEED)
    cli("build", "--device", "cpu", *fastas)
    dsmi = [f + ".dsmi" for f in fastas]
    jidx = [JFMIndex.from_texts([jtransform(r.seq) for r in jread_fasta(f)])
            for f in fastas]
    return fastas, dsmi, [FMIndex.load(p) for p in dsmi], jidx


@pytest.fixture(scope="module")
def want(d4):
    """dsm_tpu's mine_np of the whole trie, by reader order."""
    cache = {}

    def get(order: str):
        if order not in cache:
            cache[order] = jmine_np(d4[3], jcfg(), reader_order=order)
        return cache[order]

    return get


@pytest.fixture(scope="module")
def whole(d4):
    """The port's mine_torch of the whole trie on the CPU, by order."""
    cache = {}

    def get(order: str):
        if order not in cache:
            cache[order] = mine_torch(d4[2], cfg(), reader_order=order,
                                      device="cpu")
        return cache[order]

    return get


def assert_same(got, exp, tol: float = ENT_TOL) -> None:
    assert got.format_lines() == exp.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == (
        exp.total_paths, exp.total_output, exp.total_occs)
    np.testing.assert_array_equal(got.freq_histogram, exp.freq_histogram)
    assert abs(got.smallest_entropy - exp.smallest_entropy) <= tol
    assert abs(got.largest_entropy - exp.largest_entropy) <= tol


def test_cli_build_writes_dsm_tpus_index(d4):
    _fastas, _dsmi, pidx, jidx = d4
    assert [i.n for i in pidx] == [i.n for i in jidx]
    for got, exp in zip(pidx, jidx):
        for a, b in ((got.table, exp.table), (got.rtable, exp.rtable)):
            for field in ("blocks", "occ", "counts", "C"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
        assert (got.number_of_texts, got.max_text_length) == (
            exp.number_of_texts, exp.max_text_length)


def test_each_index_inverts_to_its_fasta(d4):
    """Gate (a)'s round trip, and dsm_tpu's walk in the same order."""
    fastas, _dsmi, pidx, jidx = d4
    for path, idx, jx in zip(fastas, pidx, jidx):
        got = idx.extract_texts()
        texts = [transform(r.seq) for r in read_fasta(path)]
        assert sorted(g.tobytes() for g in got) == sorted(
            encode(t).tobytes() for t in texts)
        exp = jx.extract_texts()
        assert len(got) == len(exp) == idx.number_of_texts
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)


def test_extract_texts_reads_no_occ_block_a_step(d4, monkeypatch):
    """The walk's steps come from one LF array, not from a rank on the
    occ blocks a step ((texts x 128) bytes a step)."""
    idx, jx = d4[2][1], d4[3][1]

    def refuse(*_a, **_k):
        raise AssertionError("extract_texts ranked on the occ blocks")

    monkeypatch.setattr(fmindex, "occ_prefix_np", refuse)
    for a, b in zip(idx.extract_texts(), jx.extract_texts()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["table", "rtable"])
def test_host_tables_match_dsm_tpu(d4, direction):
    """OccTable.build and fused_rows (both without their one-hot
    temporaries now) on each sample's BWT, against dsm_tpu's."""
    for idx, jx in zip(d4[2], d4[3]):
        t = getattr(idx, direction)
        bwt = t.blocks.reshape(-1)[:t.n]
        got, exp = rank.OccTable.build(bwt), jrank.OccTable.build(bwt)
        for field in ("blocks", "occ", "counts", "C"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(exp, field))
        c4 = [int(exp.C[c]) for c in (2, 3, 4, 6)]
        for kw in ({}, {"c4": c4}):
            np.testing.assert_array_equal(rank.fused_rows(got, **kw),
                                          jrank.fused_rows(exp, **kw))


@pytest.mark.parametrize("order", ORDERS)
def test_cli_mine_prints_dsm_tpus_bytes(d4, want, whole, order):
    """`build` then `mine` through the CLI, against dsm_tpu's mine_np on
    the same FASTA files; mine_torch in process too, with the counters."""
    p = cli("mine", "--device", "cpu", "-f", str(FMIN), "-P", str(PMIN),
            "-E", str(EMAX), "--reader-order", order, *d4[1])
    exp = want(order)
    assert exp.total_output > 0
    assert p.stdout == exp.format_lines()
    assert_same(whole(order), exp, 5e-6)


def test_orders_carry_the_same_lines(whole):
    a, g = whole("ascending"), whole("gnu")
    assert a.total_paths == g.total_paths
    la = sorted((p, frozenset(o), e) for p, e, o in a.lines)
    lg = sorted((p, frozenset(o), e) for p, e, o in g.lines)
    assert [x[:2] for x in la] == [x[:2] for x in lg]
    assert max(abs(x[2] - y[2]) for x, y in zip(la, lg)) <= ENT_TOL


@pytest.mark.parametrize("order", ORDERS)
def test_prefix_runs_concatenate_to_the_whole_run(d4, whole, order):
    outs = [mine_torch(d4[2], cfg(), prefix=bytes([p]), reader_order=order,
                       device="cpu") for p in b"ACGT"]
    exp = whole(order)
    assert b"".join(o.format_lines() for o in outs) == exp.format_lines()
    assert sum(o.total_paths for o in outs) == exp.total_paths


@pytest.mark.parametrize("order", ORDERS)
def test_prefix_cut_matches_mine_np(d4, order):
    """Gate (b): the episode under a two-symbol prefix to a maxdepth
    against the port's host engine, and that against dsm_tpu's."""
    prefix, maxdepth = ORACLE
    got = mine_torch(d4[2], cfg(maxdepth), prefix=prefix, reader_order=order,
                     device="cpu")
    exp = mine_np(d4[2], cfg(maxdepth), prefix=prefix, reader_order=order)
    assert exp.total_output > 0
    assert_same(got, exp)
    assert_same(exp, jmine_np(d4[3], jcfg(maxdepth), prefix=prefix,
                              reader_order=order), 5e-6)


@pytest.mark.parametrize("order", ORDERS)
def test_two_shards_equal_one_device(d4, whole, order):
    got = mine_device_sharded(d4[2], cfg(), mesh=global_samples_mesh(
        2, torch.device("cpu")), reader_order=order)
    assert_same(got, whole(order), SHARD_ENT_TOL)
