"""The port at the JAX package's topology for large tries, on the CPU: the
runs that the scale-1000 phase of chip_smoke.py drives on the card, at the
toydata's scale 1 (tests/data/toydata: 5 samples, 216,206 symbols).

(a) One enforced-prefix run a prefix A, C, G, T over ONE shared upload
    (`mine_torch(..., dev=dev, prefix=p)`, bench.py:240-281), ascending
    and gnu, each against dsm_tpu's `mine_tpu(dev=..., prefix=p)` on one
    shared JAX upload (lines in bytes and every counter; the entropy range
    within 5e-6, dsm_tpu's f32), and in gnu order against the reference
    server's frozen stdout for the prefix.  The four runs in sequence over
    the upload, then A again, concatenate to the port's whole-trie run in
    either order, sum to its paths, and leave A's bytes as they were.
(b) The same under a small DSM_HIST_CAP, so that every prefix run takes
    HISTFULL exits and decodes paths across pulled segments, against
    dsm_tpu under the same cap.
(c) The snapshot's total_paths past 2^31 - 1: a run whose count starts at
    2^31 + 5 is killed at a save and resumed to the exact count, the file
    holding INT32_MAX in its int32 state and the rest in its int64 output
    counter (no wrapped value, no OverflowError); below 2^31 the port's
    snapshot is what dsm_tpu's `load_checkpoint` reads as before.
(d) Every size refusal of a kernel wrapper (ops/limits.py), on tensors of
    the "meta" device, which have a shape and no storage: the wrapper
    raises ValueError naming the limit before it dispatches; and an episode
    that the budget cannot hold is refused before its first level, where a
    prefix run under the same budget mines.
(e) tests/freeze_scale_reference.py, which froze chip_smoke.S1000 with
    dsm_tpu, run at scale 1: its whole-trie entries are the port's run's.
"""

import glob
import gzip
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining import checkpoint as jckpt
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine import DeviceIndexes as JaxDeviceIndexes
from dsm_tpu.mining.engine import mine_tpu
from dsm_tpu_torch import convert
from dsm_tpu_torch.mining import bigindex
from dsm_tpu_torch.mining import checkpoint as pckpt
from dsm_tpu_torch.mining import engine_device as ted
from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch
from dsm_tpu_torch.ops import limits
from dsm_tpu_torch.ops.children import children, children_ids
from dsm_tpu_torch.ops.compact import compact_rows, stage_rows
from dsm_tpu_torch.ops.decode import decode
from dsm_tpu_torch.ops.gatherpack import gather_pack
from dsm_tpu_torch.ops.segstats import segstats
from dsm_tpu_torch.ops.shardstats import node_gates, shard_partials

HERE = os.path.dirname(os.path.abspath(__file__))
TOYDATA = os.path.join(HERE, "data", "toydata")
GOLDEN = os.path.join(HERE, "golden")
CFG = MiningConfig(fmin=2, emax=1.2)
PREFIXES = "ACGT"
ORDERS = ("ascending", "gnu")
HIST_CAP = "20000"   # a prefix run takes several HISTFULL exits


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


@pytest.fixture(scope="module")
def pcfg():
    return convert.config_from_jax(CFG)


@pytest.fixture(scope="module")
def pdev(pidx):
    """The port's one upload that every run of this file shares."""
    return DeviceIndexes.build(pidx, "cpu")


@pytest.fixture(scope="module")
def jdev(indexes):
    """dsm_tpu's one upload, shared the same way."""
    return JaxDeviceIndexes.build(indexes)


@pytest.fixture(scope="module")
def whole(pidx, pcfg, pdev):
    """The port's whole-trie run in each order, over the shared upload."""
    return {order: mine_torch(pidx, pcfg, dev=pdev, device="cpu",
                              reader_order=order) for order in ORDERS}


def assert_same(got, want, entropy_tol=5e-6):
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
    assert got.total_output == want.total_output
    assert got.total_occs == want.total_occs
    np.testing.assert_array_equal(got.freq_histogram, want.freq_histogram)
    assert abs(got.smallest_entropy - want.smallest_entropy) < entropy_tol
    assert abs(got.largest_entropy - want.largest_entropy) < entropy_tol


def golden(prefix: str) -> bytes:
    with gzip.open(os.path.join(
            GOLDEN, f"server-output.default.{prefix}.txt.gz")) as f:
        return f.read()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("prefix", PREFIXES)
def test_shared_upload_prefix_matches_dsm_tpu(indexes, pidx, pcfg, pdev,
                                              jdev, prefix, order):
    prof = {}
    got = mine_torch(pidx, pcfg, prefix=prefix.encode(), dev=pdev,
                     device="cpu", reader_order=order, profile=prof)
    assert got.total_output > 0 and prof["histfull"] == 0
    assert_same(got, mine_tpu(indexes, CFG, prefix=prefix.encode(),
                              reader_order=order, dev=jdev))
    if order == "gnu":
        assert got.format_lines() == golden(prefix)


def test_prefixes_in_sequence_concatenate_to_the_whole(pidx, pcfg, pdev,
                                                       whole):
    for order in ORDERS:
        runs = [mine_torch(pidx, pcfg, prefix=p.encode(), dev=pdev,
                           device="cpu", reader_order=order)
                for p in PREFIXES + "A"]
        assert b"".join(r.format_lines() for r in runs[:4]) \
            == whole[order].format_lines()
        assert sum(r.total_paths for r in runs[:4]) \
            == whole[order].total_paths
        assert sum(r.total_output for r in runs[:4]) \
            == whole[order].total_output
        assert runs[4].format_lines() == runs[0].format_lines()
        assert runs[4].total_paths == runs[0].total_paths


@pytest.mark.parametrize("prefix", PREFIXES)
def test_histfull_prefix_matches_dsm_tpu(indexes, pidx, pcfg, pdev, jdev,
                                         prefix, monkeypatch):
    monkeypatch.setenv("DSM_HIST_CAP", HIST_CAP)
    prof = {}
    got = mine_torch(pidx, pcfg, prefix=prefix.encode(), dev=pdev,
                     device="cpu", reader_order="gnu", profile=prof)
    assert prof["histfull"] >= 2 and prof["pulled_levels"] > 0
    assert got.format_lines() == golden(prefix)
    assert_same(got, mine_tpu(indexes, CFG, prefix=prefix.encode(),
                              reader_order="gnu", dev=jdev))


class _Abort(RuntimeError):
    pass


def _kill_at_first_save(monkeypatch, run, path: str) -> None:
    """Run `run()` with save_checkpoint wrapped to raise after one save."""
    orig = pckpt.save_checkpoint

    def once(*a, **k):
        orig(*a, **k)
        raise _Abort()

    monkeypatch.setattr(pckpt, "save_checkpoint", once)
    with pytest.raises(_Abort):
        run()
    monkeypatch.setattr(pckpt, "save_checkpoint", orig)
    assert os.path.exists(path)


def test_snapshot_total_paths_past_int32_resumes_exactly(
        pidx, pcfg, pdev, whole, tmp_path, monkeypatch):
    offset = 2**31 + 5
    seed = ted._seed_episode

    def seeded(dev, hist_cap):
        st = seed(dev, hist_cap)
        st.total_paths = offset
        return st

    ck = str(tmp_path / "big.ckpt")
    monkeypatch.setattr(ted, "_seed_episode", seeded)
    _kill_at_first_save(monkeypatch, lambda: mine_torch(
        pidx, pcfg, dev=pdev, device="cpu", reader_order="gnu",
        out_reserve=100, checkpoint=ck), ck)
    with np.load(ck) as z:
        held = z["st_total_paths"]
        rest = int(z["o_counters"][0])
    assert held.dtype == np.int32 and int(held) == limits.INT32_MAX
    assert int(held) + rest > offset
    monkeypatch.undo()
    got = mine_torch(pidx, pcfg, dev=pdev, device="cpu", reader_order="gnu",
                     checkpoint=ck)
    assert not os.path.exists(ck)
    assert got.total_paths == whole["gnu"].total_paths + offset
    assert got.format_lines() == whole["gnu"].format_lines()


def test_snapshot_below_int32_reads_in_dsm_tpu(indexes, pidx, pcfg, pdev,
                                               tmp_path, monkeypatch):
    ck = str(tmp_path / "small.ckpt")
    counts = []
    seed = ted._snapshot_state

    def keeping(st, out, live):
        counts.append(st.total_paths)
        return seed(st, out, live)

    monkeypatch.setattr(ted, "_snapshot_state", keeping)
    _kill_at_first_save(monkeypatch, lambda: mine_torch(
        pidx, pcfg, dev=pdev, device="cpu", out_reserve=100,
        checkpoint=ck), ck)
    state, out, paths = jckpt.load_checkpoint(
        ck, CFG, b"", [i.n for i in indexes])
    assert state["total_paths"].dtype == np.int32
    assert int(state["total_paths"]) == counts[0] > 0
    assert out.total_paths == 0
    assert len(paths) == int(state["nvalid"])


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


I32, U8, I64 = torch.int32, torch.uint8, torch.int64
BIG_P = limits.MAX_PAIRS + 1
BIG_U = limits.MAX_NODES + 1
REFUSALS = {
    "segstats pairs": lambda: segstats(
        _meta(3, I32), _meta(BIG_P, I32), _meta(BIG_P, U8), None),
    "shard_partials pairs": lambda: shard_partials(
        _meta(3, I32), _meta(BIG_P, I32), _meta(BIG_P, U8), 15,
        _meta((2, 3), I64), _meta(1, torch.float64)),
    "node_gates nodes": lambda: node_gates(
        _meta((BIG_U, 3), I64), None, _meta(4, I32), None, 0, 0, None),
    "children nodes": lambda: children(
        _meta(BIG_U + 1, I32), _meta((4, 6), I32), None, None, None, 4, 4,
        _meta(4, I32)),
    "children kept lanes": lambda: children(
        _meta(3, I32), _meta((4, 6), I32), None, None, None, BIG_P, 4,
        _meta(4, I32)),
    "children children": lambda: children(
        _meta(3, I32), _meta((4, 6), I32), None, None, None, 4, BIG_P,
        _meta(4, I32)),
    "children_ids kept lanes": lambda: children_ids(
        _meta(3, I32), _meta((4, 6), I32), None, None, None, None, None,
        BIG_P, 4),
    "compact_rows rows": lambda: compact_rows(
        _meta(limits.MAX_COMPACT_ROWS + 1, torch.bool),
        _meta((limits.MAX_COMPACT_ROWS + 1, 2), I32), 4),
    "compact_rows columns": lambda: compact_rows(
        _meta(4, torch.bool), _meta((4, limits.MAX_COMPACT_COLS + 1), I32),
        4),
    "stage_rows rows": lambda: stage_rows(
        _meta(limits.MAX_COMPACT_ROWS + 1, torch.bool),
        _meta((limits.MAX_COMPACT_ROWS + 1, 6), I32), 3, 4),
    "decode levels": lambda: decode(
        _meta(8, I32), _meta(8, I32), _meta(4, I32), _meta(4, I32),
        limits.MAX_DECODE_LEVELS + 1),
    "decode history": lambda: decode(
        _meta(limits.INT32_MAX + 1, I32), _meta(8, I32), _meta(4, I32),
        _meta(4, I32), 8),
    "gather_pack columns": lambda: gather_pack(
        [_meta((4, limits.MAX_GATHER_COLS + 1), I32)], [0], 0),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_past_its_int32_limit(case):
    with pytest.raises(ValueError, match="is past the limit"):
        REFUSALS[case]()


def test_limits_hold_the_largest_accepted_sizes():
    """At each limit itself the refusal stays silent."""
    for limit in (limits.MAX_PAIRS, limits.MAX_NODES,
                  limits.MAX_COMPACT_ROWS, limits.MAX_COMPACT_COLS,
                  limits.MAX_DECODE_LEVELS, limits.MAX_GATHER_COLS,
                  limits.INT32_MAX):
        limits.refuse_past("who", "what", limit, limit, "why")
    # a history entry of the last node of a level at the node limit fits
    assert (limits.MAX_NODES - 1) * 4 + 3 == limits.INT32_MAX


def test_episode_past_the_budget_is_refused_before_its_first_level(
        pidx, pcfg, pdev, monkeypatch):
    whole_bytes = bigindex.episode_bytes(pidx, pcfg.fmin)
    a_bytes = bigindex.episode_bytes(pidx, pcfg.fmin, b"A")
    assert a_bytes < whole_bytes
    monkeypatch.setenv("DSM_HBM_BYTES", str((a_bytes + whole_bytes) // 2))
    levels = []
    level = ted._level
    monkeypatch.setattr(ted, "_level",
                        lambda *a, **k: levels.append(1) or level(*a, **k))
    with pytest.raises(ValueError, match="partition the trie by prefix"):
        mine_torch(pidx, pcfg, dev=pdev, device="cpu")
    assert not levels
    got = mine_torch(pidx, pcfg, prefix=b"A", dev=pdev, device="cpu",
                     reader_order="gnu")
    assert levels and got.format_lines() == golden("A")


def test_level_pairs_bound_the_prefix_levels(pidx, pcfg, pdev):
    """The prefix's bound holds every level of its run (the widest one
    measured with the port's own level loop on the CPU)."""
    for prefix in (b"", b"A", b"GA"):
        bound = bigindex.level_pairs(pidx, pcfg.fmin, prefix)
        sc = ted._Scalars.build(pcfg, prefix_codes=tuple(
            b"ACGT".index(c) for c in prefix))
        st = ted._seed_episode(pdev, ted._hist_cap(pdev))
        widest = 0
        while True:
            widest = max(widest, st.npairs)
            flag = ted._level(pdev, sc, st)
            st.out, st.ocount = [], 0
            if flag == ted.FLAG_HISTFULL:
                st.hist_len, st.lvl_off = 0, []
            elif flag in (ted.FLAG_DONE, ted.FLAG_TAIL):
                break
        assert 0 < widest <= bound


def test_freeze_script_at_scale_1_matches_the_whole_trie(pidx, whole,
                                                         tmp_path):
    """tests/freeze_scale_reference.py, which froze chip_smoke.S1000 with
    dsm_tpu at scale 1000, at the toydata's scale: its whole-trie entries
    (the prefixes concatenated and summed) are the port's whole-trie run."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "freeze_scale_reference.py"),
         str(tmp_path), "--scale", "1", "--jobs", "2"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout[proc.stdout.index("{"):])
    for order in ORDERS:
        out = whole[order]
        assert hashlib.sha256(out.format_lines()).hexdigest() == ref[order]
        assert (out.total_paths, out.total_output, out.total_occs) == \
            (ref["paths"], ref["lines"], ref["occs"])
    assert ref["symbols"] == sum(i.n for i in pidx)
