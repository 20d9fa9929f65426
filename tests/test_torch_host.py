"""The port's own copies of the host modules, each against its original
in dsm_tpu, on the CPU.

dsm_tpu_torch imports nothing of dsm_tpu, so the FM-index, the occ
tables, the NumPy suffix sort and engine, the gnu-order models, the index
file formats and the snapshot codec exist twice.  Here the same inputs go
through both and everything is equal: arrays, file bytes (.fmi) and file
contents (.dsmi, snapshots), mined lines byte for byte.  `convert` carries
a dsm_tpu FMIndex and MiningConfig over to the port's classes.  The
samples axis (parallel/mesh, parallel/multihost without a process group)
and the sharded tables (parallel/engine_sharded) are held against
dsm_tpu's axis name and its `ShardedIndexes` host arrays, row for row.
"""

import glob
import os

import numpy as np
import pytest
import torch

from dsm_tpu.index import alphabet as jalphabet
from dsm_tpu.index import fasta as jfasta
from dsm_tpu.index import fmi_compat as jfmi
from dsm_tpu.index import incremental as jinc
from dsm_tpu.index.build import libname as jlibname
from dsm_tpu.index.fmindex import FMIndex as JFMIndex
from dsm_tpu.mining import checkpoint as jckpt
from dsm_tpu.mining import engine_np as jnp_engine
from dsm_tpu.mining import gnuorder as jgnu
from dsm_tpu.mining.config import MiningConfig as JMiningConfig
from dsm_tpu.mining.gnulazy import LazyGnuOrder as JLazyGnuOrder
from dsm_tpu.ops import rank as jrank
from dsm_tpu.ops import sa as jsa
from dsm_tpu.parallel import mesh as jmesh
from dsm_tpu.parallel.engine_sharded import ShardedIndexes as JShardedIndexes
from dsm_tpu_torch import convert
from dsm_tpu_torch.index import alphabet, fasta, fmi_compat, incremental
from dsm_tpu_torch.index.build import libname
from dsm_tpu_torch.index.fmindex import FMIndex
from dsm_tpu_torch.mining import checkpoint as pckpt
from dsm_tpu_torch.mining import engine_np, gnuorder
from dsm_tpu_torch.mining.config import MiningConfig
from dsm_tpu_torch.mining.gnulazy import LazyGnuOrder
from dsm_tpu_torch.ops import rank, sa
from dsm_tpu_torch.parallel import mesh as pmesh
from dsm_tpu_torch.parallel.engine_sharded import ShardedIndexes
from dsm_tpu_torch.parallel.multihost import (global_samples_mesh,
                                              shards_from_env)

HERE = os.path.dirname(os.path.abspath(__file__))
TOYDATA = os.path.join(HERE, "data", "toydata")
FASTAS = sorted(glob.glob(os.path.join(TOYDATA, "toy*.fasta.gz")))

# tests/oracle.py's configurations, as mining configs ("filtered" with its
# entropy window opened to 2.0, so that 40 records a sample emit lines)
CONFIGS = {
    "default": dict(fmin=2, emax=1.2),
    "specific": dict(fmin=5, emax=10, pmin=1, pmax=1),
    "wide": dict(fmin=2, emax=99),
    "filtered": dict(fmin=2, emax=2.0, emin=0.4, pmin=2, pmax=4, mindepth=8),
    "shallow": dict(fmin=2, emax=1.2, maxdepth=12),
    "deep1": dict(fmin=7, emax=99, pmin=1),
}


@pytest.fixture(scope="module")
def texts():
    """60 records of toy1, transformed by dsm_tpu."""
    recs = list(jfasta.read_fasta(FASTAS[1]))[:60]
    return [jalphabet.transform(r.seq) for r in recs], [r.name for r in recs]


@pytest.fixture(scope="module")
def jindex(texts):
    return JFMIndex.from_texts(texts[0], texts[1], samplerate=16,
                               sample_sa=True)


@pytest.fixture(scope="module")
def jindexes():
    """The five toydata samples, 40 records each, built by dsm_tpu."""
    return [JFMIndex.from_texts(
        [jalphabet.transform(r.seq)
         for r in list(jfasta.read_fasta(p))[:40]]) for p in FASTAS]


@pytest.fixture(scope="module")
def pindexes(jindexes):
    return [convert.fmindex_from_jax(i) for i in jindexes]


def assert_tables_equal(a, b):
    assert a.n == b.n
    for f in ("blocks", "occ", "counts", "C"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def assert_index_equal(got, want):
    assert_tables_equal(got.table, want.table)
    assert_tables_equal(got.rtable, want.rtable)
    assert (got.n, got.number_of_texts, got.max_text_length, got.samplerate,
            got.names) == (want.n, want.number_of_texts,
                           want.max_text_length, want.samplerate, want.names)
    assert (got.sa_samples is None) == (want.sa_samples is None)
    if want.sa_samples is not None:
        for f in ("rows", "vals", "text_starts"):
            np.testing.assert_array_equal(getattr(got.sa_samples, f),
                                          getattr(want.sa_samples, f))


def test_alphabet_and_fasta_equal():
    for p in FASTAS[:2]:
        got, want = list(fasta.read_fasta(p)), list(jfasta.read_fasta(p))
        assert [(r.name, r.seq) for r in got] == \
            [(r.name, r.seq) for r in want]
        for r in want[:20]:
            t = alphabet.transform(r.seq)
            np.testing.assert_array_equal(t, jalphabet.transform(r.seq))
            np.testing.assert_array_equal(alphabet.encode(t),
                                          jalphabet.encode(t))
    odd = b"acgtnNxyz0123.-ACGT"
    np.testing.assert_array_equal(alphabet.normalize(odd),
                                  jalphabet.normalize(odd))
    assert alphabet.decode(np.arange(7)) == jalphabet.decode(np.arange(7))
    assert alphabet.EXT_CHARS == jalphabet.EXT_CHARS
    with pytest.raises(ValueError):
        alphabet.encode(np.frombuffer(b"AC0", dtype=np.uint8))


def test_libname_equal():
    for path in ("a/b/toy0.fasta.gz.dsmi", "toy1", "x\\y\\s.z", ".hidden"):
        assert libname(path) == jlibname(path)


def test_suffix_array_np_and_bwt_equal(rng):
    for n in (0, 1, 2, 777):
        codes = rng.integers(0, 7, size=n).astype(np.int8)
        got, want = sa.suffix_array_np(codes), jsa.suffix_array_np(codes)
        np.testing.assert_array_equal(got, want)
        if n:
            np.testing.assert_array_equal(sa.bwt_from_sa(codes, got),
                                          jsa.bwt_from_sa(codes, want))


def test_occ_table_and_fused_rows_equal(jindex, rng):
    bwt = jindex.table.blocks.reshape(-1)[:jindex.n]
    got, want = rank.OccTable.build(bwt), jrank.OccTable.build(bwt)
    assert_tables_equal(got, want)
    c4 = [int(want.C[c]) for c in (2, 3, 4, 6)]
    for kw in ({}, {"c4": c4}):
        np.testing.assert_array_equal(rank.fused_rows(got, **kw),
                                      jrank.fused_rows(want, **kw))
    pos = rng.integers(0, jindex.n + 1, size=500)
    syms = rng.integers(0, 7, size=500).astype(np.int8)
    np.testing.assert_array_equal(rank.occ_prefix_np(got, syms, pos),
                                  jrank.occ_prefix_np(want, syms, pos))
    np.testing.assert_array_equal(rank.occ_cum_np(got, pos),
                                  jrank.occ_cum_np(want, pos))
    assert (rank.BLOCK, rank.LOG2_BLOCK, rank.ROWW) == \
        (jrank.BLOCK, jrank.LOG2_BLOCK, jrank.ROWW)


def test_fmindex_from_jax_round_trip(jindex):
    got = convert.fmindex_from_jax(jindex)
    assert isinstance(got, FMIndex) and not isinstance(got, JFMIndex)
    assert_index_equal(got, jindex)
    assert got.table.blocks is jindex.table.blocks    # shared, not copied


def test_fmindex_host_build_and_queries_equal(texts, jindex, rng):
    got = FMIndex.from_texts(texts[0], texts[1], samplerate=16,
                             device="cpu", sample_sa=True)
    assert_index_equal(got, jindex)
    assert got.check() and jindex.check()
    for pat in (b"ACG", b"TTTT", b"GATTACA", b"N"):
        assert got.count(pat) == jindex.count(pat)
        assert got.search(pat) == jindex.search(pat)
        assert got.occurrences(pat) == jindex.occurrences(pat)
        assert got.reads_containing(pat) == jindex.reads_containing(pat)
    rows = rng.integers(0, got.n, size=200)
    np.testing.assert_array_equal(got.locate(rows), jindex.locate(rows))
    for a, b in zip(got.extract_texts(), jindex.extract_texts()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.dcum, jindex.dcum)
    np.testing.assert_array_equal(got.rdcum, jindex.rdcum)
    assert got.access_bwt(17) == jindex.access_bwt(17)
    assert got.lf_ref(3, 40) == jindex.lf_ref(3, 40)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_dsmi_files_equal_and_cross_load(jindex, tmp_path):
    pidx = convert.fmindex_from_jax(jindex)
    jpath, ppath = str(tmp_path / "j.dsmi"), str(tmp_path / "p.dsmi")
    jindex.save(jpath)
    pidx.save(ppath)
    want, got = _npz(jpath), _npz(ppath)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert_index_equal(FMIndex.load(jpath), jindex)
    assert_index_equal(JFMIndex.load(ppath), jindex)


def test_fmi_bytes_equal_and_cross_load(jindex, tmp_path):
    pidx = convert.fmindex_from_jax(jindex)
    jpath = jfmi.save_fmi(jindex, str(tmp_path / "j"))
    ppath = fmi_compat.save_fmi(pidx, str(tmp_path / "p"))
    with open(jpath, "rb") as f1, open(ppath, "rb") as f2:
        assert f2.read() == f1.read()
    got, want = FMIndex.load(jpath), JFMIndex.load(ppath)
    assert_tables_equal(got.table, want.table)
    # the reverse table of a .fmi is rebuilt by BWT inversion in both
    assert_tables_equal(got.rtable, want.rtable)
    assert (got.n, got.number_of_texts, got.max_text_length,
            got.samplerate) == (want.n, want.number_of_texts,
                                want.max_text_length, want.samplerate)


def test_incremental_helpers_equal(texts, jindex):
    seqs = texts[0][:25]
    got = incremental._batch_codes(seqs)
    want = jinc._batch_codes(seqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ptab = convert.fmindex_from_jax(jindex).table
    np.testing.assert_array_equal(
        incremental.batch_gaps(ptab, ptab.C, jindex.number_of_texts, *got[:2]),
        jinc.batch_gaps(jindex.table, jindex.C, jindex.number_of_texts,
                        *want[:2]))
    merged = incremental.merge_indexes(convert.fmindex_from_jax(jindex), seqs,
                                       device=None)
    assert_index_equal(merged, jinc.merge_indexes(jindex, seqs))


def test_config_from_jax():
    jcfg = JMiningConfig(fmin=3, maxdepth=17, pmin=1, pmax=4, emin=0.25,
                         emax=1.5, mindepth=2, verbose=True)
    got = convert.config_from_jax(jcfg)
    assert isinstance(got, MiningConfig) and not isinstance(got, JMiningConfig)
    assert repr(got) == repr(jcfg)
    for bad in (dict(), dict(emax=1.0, emin=2.0), dict(emax=1.0, fmin=0)):
        with pytest.raises(ValueError):
            MiningConfig(**bad).validate()


@pytest.mark.parametrize("order", ["ascending", "gnu"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_mine_np_equals_dsm(jindexes, pindexes, config, order):
    kw = CONFIGS[config]
    want = jnp_engine.mine_np(jindexes, JMiningConfig(**kw),
                              reader_order=order)
    got = engine_np.mine_np(pindexes, MiningConfig(**kw), reader_order=order)
    assert got.format_lines() == want.format_lines()
    assert got.total_output == want.total_output > 0
    assert (got.total_paths, got.total_occs, got.smallest_entropy,
            got.largest_entropy) == (want.total_paths, want.total_occs,
                                     want.smallest_entropy,
                                     want.largest_entropy)
    np.testing.assert_array_equal(got.freq_histogram, want.freq_histogram)


def test_mine_np_prefix_equals_dsm(jindexes, pindexes):
    kw = dict(fmin=2, emax=99)
    want = jnp_engine.mine_np(jindexes, JMiningConfig(**kw), prefix=b"GA",
                              reader_order="gnu")
    got = engine_np.mine_np(pindexes, MiningConfig(**kw), prefix=b"GA",
                            reader_order="gnu")
    assert got.format_lines() == want.format_lines() and got.lines


def test_gnu_hash_set_and_lazy_order_equal(jindexes, pindexes, rng):
    for d in (1, 5, 13, 14, 30, 300):
        assert gnuorder.root_order(d) == jgnu.root_order(d)
    a, b = gnuorder.GnuHashSet(), jgnu.GnuHashSet()
    for k in rng.integers(0, 5000, size=400).tolist():
        a.insert(k)
        b.insert(k)
    assert a.order() == b.order() and len(a) == len(b)
    lines = jnp_engine.mine_np(jindexes, JMiningConfig(fmin=2, emax=99)).lines
    got = LazyGnuOrder(pindexes, 2, len(pindexes))
    want = JLazyGnuOrder(jindexes, 2, len(jindexes))
    assert lines
    for path, _ent, occs in lines[:60]:
        assert got.order_for(path) == want.order_for(path)
        freq = np.zeros(len(jindexes), dtype=np.int64)
        for r, f in occs:
            freq[r] = f
        assert got.entropy_for(path, freq, 5) == want.entropy_for(path, freq,
                                                                  5)
    with pytest.raises(KeyError):
        got.order_for(b"ACGTNACGT")


def test_snapshot_codec_equal_both_ways(jindexes, tmp_path):
    """The port's codec writes what dsm_tpu's load_checkpoint reads, and
    reads what dsm_tpu's writer wrote (`_encode_output`, `_fingerprint` and
    the key set are equal)."""
    out = jnp_engine.mine_np(jindexes, JMiningConfig(fmin=2, emax=1.2))
    jcfg, pcfg = JMiningConfig(fmin=2, emax=1.2), MiningConfig(fmin=2,
                                                               emax=1.2)
    ns = [i.n for i in jindexes]
    assert pckpt._STATE_KEYS == jckpt._STATE_KEYS
    assert pckpt.FORMAT == jckpt.FORMAT
    np.testing.assert_array_equal(pckpt._fingerprint(pcfg, b"A", ns),
                                  jckpt._fingerprint(jcfg, b"A", ns))
    got, want = pckpt._encode_output(out), jckpt._encode_output(out)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    paths = [b"ACG", b"TTA"]
    state = dict(pairs=np.arange(16, dtype=np.int32).reshape(2, 8),
                 nvalid=np.int32(2), depth=np.int32(3),
                 total_paths=np.int32(99), ent_min=np.float32(0.5),
                 ent_max=np.float32(1.5), eskip=np.int32(0))
    ck = str(tmp_path / "s.ckpt")
    pckpt.save_checkpoint(ck, state, out, pcfg, b"A", ns,
                          jckpt._pack_paths(paths, 3))
    for mod, cfg in ((jckpt, jcfg), (pckpt, pcfg)):
        st, back, live = mod.load_checkpoint(ck, cfg, b"A", ns)
        assert live == paths
        assert back.format_lines() == out.format_lines()
        assert (back.total_paths, back.total_output, back.total_occs) == \
            (out.total_paths, out.total_output, out.total_occs)
        for k in state:
            np.testing.assert_array_equal(st[k], state[k])
        with pytest.raises(ValueError):
            mod.load_checkpoint(ck, cfg, b"C", ns)
    with pytest.raises(ValueError):
        pckpt.save_checkpoint(ck, state, out, pcfg, b"A", ns,
                              np.zeros((3, 3), dtype=np.uint8))


def test_rlcsa_artifact_loads_equal():
    """The committed RLE-codec artifact of tests/test_rlcsa.py through both
    readers: the same BWT, the same index, the same mined lines."""
    from dsm_tpu.index.rlcsa import read_bwt as jread_bwt
    from dsm_tpu_torch.index.rlcsa import read_bwt

    path = os.path.join(HERE, "data", "rlcsa", "seqs-rle.rlcsa.array")
    (gb, gn, ge), (wb, wn, we) = read_bwt(path), jread_bwt(path)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(ge, we)
    assert gn == wn
    got, want = FMIndex.load(path), JFMIndex.load(path)
    assert_index_equal(got, want)
    assert got.sa_samples is None      # searches and mines; locate() raises
    with pytest.raises(ValueError):
        got.locate([0])
    kw = dict(fmin=1, emax=99, pmin=1)
    assert engine_np.mine_np([got], MiningConfig(**kw)).format_lines() == \
        jnp_engine.mine_np([want], JMiningConfig(**kw)).format_lines()


def test_samples_axis_without_a_group(monkeypatch):
    """No process group: one process that holds every shard."""
    assert pmesh.SAMPLES_AXIS == jmesh.SAMPLES_AXIS
    mesh = global_samples_mesh(3, "cpu")
    assert (mesh.group, mesh.rank, mesh.world, mesh.n_shards,
            mesh.first_shard) == (None, 0, 1, 3, 0)
    assert pmesh.SamplesMesh(None, 2, 4, 3, mesh.device).first_shard == 6
    with pytest.raises(ValueError):
        global_samples_mesh(0, "cpu")
    monkeypatch.delenv("DSM_SHARDS", raising=False)
    assert shards_from_env() == 1
    monkeypatch.setenv("DSM_SHARDS", "5")
    assert shards_from_env() == 5


@pytest.mark.parametrize("shards", [1, 2, 4, 5, 8])
def test_sharded_tables_equal(jindexes, pindexes, shards):
    """Every sample's forward and reverse table rows and length in the
    port's shard that holds it equal dsm_tpu's (which pads every sample to
    one row count and the set with dummy samples); with 8 shards three of
    the port's are empty.  `convert.sharded_tables_from_jax` stacks
    dsm_tpu's padded rows and answers the same rank queries."""
    jdev = JShardedIndexes.build(jindexes, pad_to=8)
    mesh = global_samples_mesh(shards, "cpu")
    pdev = ShardedIndexes.build(pindexes, mesh)
    cdev = convert.sharded_tables_from_jax(jdev, mesh, len(jindexes))
    assert pdev.S == cdev.S == len(jindexes)
    np.testing.assert_array_equal(pdev.ns, jdev.ns[:pdev.S])
    assert list(pdev.bounds) == list(cdev.bounds) == \
        [k * pdev.S // shards for k in range(shards + 1)]
    assert sum(sd.S for sd in pdev.shards) == pdev.S
    rng = np.random.default_rng(shards)
    for k, (sd, cd) in enumerate(zip(pdev.shards, cdev.shards)):
        assert sd.S == cd.S == pdev.bounds[k + 1] - pdev.bounds[k]
        soff = np.append(sd.soff.numpy(), sd.frows.shape[0])
        for loc in range(sd.S):
            g = pdev.base(k) + loc
            assert sd.ns[loc] == jindexes[g].n
            for got, want in ((sd.frows, jdev.fnp), (sd.rrows, jdev.rnp)):
                rows = got.numpy()[soff[loc]:soff[loc + 1]].view(np.uint32)
                np.testing.assert_array_equal(rows, want[g, :rows.shape[0]])
                assert not want[g, rows.shape[0]:].any()
            pos = torch.as_tensor(rng.integers(0, sd.ns[loc] + 1, size=50),
                                  dtype=torch.int32)
            for a, b in ((sd.frows, cd.frows), (sd.rrows, cd.rrows)):
                assert torch.equal(
                    rank.occ_cum8(a, pos, sd.soff[loc].expand(50)),
                    rank.occ_cum8(b, pos, cd.soff[loc].expand(50)))
