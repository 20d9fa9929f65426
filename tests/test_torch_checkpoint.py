"""Checkpoint/resume of the port (dsm_tpu_torch/mining/checkpoint.py,
`mine_device(checkpoint=)`) against dsm_tpu's and `mine_np`.

A run is killed by raising from a wrapped `save_checkpoint` after its
k-th save, as tests/test_checkpoint.py does for dsm_tpu, and resumed from
the file.  Held exactly: the resumed output against `mine_np` (lines,
paths, occs; ascending and gnu order), the port's snapshots against
dsm_tpu's array for array (the float32 entropy min/max diagnostics at
relative 1e-5: the port's are f64 sums), snapshots carried between the
packages both ways, a dsm_tpu snapshot taken in the middle of a chunked
emission (eskip > 0), a resume after a pulled history segment, the
fingerprint check, the `out_reserve` clamp, and the CLI's `--checkpoint`
against `dsm mine`.
"""

import os

import numpy as np
import pytest

from dsm_tpu.cli.main import main as dsm_main
from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining import checkpoint as jckpt
from dsm_tpu.mining import engine_device as jed
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_np import mine_np
from dsm_tpu_torch import convert
from dsm_tpu_torch.cli.main import main as port_main
from dsm_tpu_torch.mining import checkpoint as pckpt
from dsm_tpu_torch.mining import engine_device as ted

CFG = MiningConfig(fmin=1, emax=99, pmin=1)


@pytest.fixture(scope="module")
def small_indexes():
    """tests/test_checkpoint.py's index set."""
    rng = np.random.default_rng(1234)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=600)]
    idxs = []
    for _ in range(3):
        texts = [transform(genome[int(rng.integers(0, 500)):][:90].tobytes())
                 for _ in range(14)]
        idxs.append(FMIndex.from_texts(texts))
    return idxs


@pytest.fixture(scope="module")
def want(small_indexes):
    return mine_np(small_indexes, CFG)


class _Abort(RuntimeError):
    pass


def _port(idxs, cfg=CFG, **kw):
    """The port's engine on its own FMIndex and MiningConfig classes."""
    return ted.mine_device([convert.fmindex_from_jax(i) for i in idxs],
                           convert.config_from_jax(cfg), device="cpu", **kw)


def _jax(idxs, cfg=CFG, **kw):
    return jed.mine_device(idxs, cfg, **kw)


ENGINES = {"port": (_port, pckpt), "jax": (_jax, jckpt)}
SAVE = {"port": pckpt.save_checkpoint, "jax": jckpt.save_checkpoint}


def _saves(monkeypatch, engine: str, abort_at=None, on_save=None):
    """Wrap `engine`'s save_checkpoint: call on_save(path) after each save,
    raise _Abort after the abort_at-th."""
    mod = ENGINES[engine][1]
    orig = SAVE[engine]
    calls = []

    def wrapped(path, *a, **kw):
        orig(path, *a, **kw)
        calls.append(path)
        if on_save is not None:
            on_save(path)
        if abort_at is not None and len(calls) >= abort_at:
            raise _Abort()

    monkeypatch.setattr(mod, "save_checkpoint", wrapped)
    return calls


def _kill(monkeypatch, engine, idxs, ck, abort_at, cfg=CFG, **kw):
    """Run `engine` with a checkpoint and kill it after save abort_at."""
    _saves(monkeypatch, engine, abort_at=abort_at)
    with pytest.raises(_Abort):
        ENGINES[engine][0](idxs, cfg, checkpoint=ck, **kw)
    monkeypatch.undo()
    assert os.path.exists(ck)


def _assert_equal(got, want):
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
    assert got.total_occs == want.total_occs


@pytest.mark.parametrize("abort_at", [1, 3])
def test_kill_and_resume(small_indexes, want, tmp_path, monkeypatch,
                         abort_at):
    ck = str(tmp_path / "mine.ckpt")
    kw = dict(out_reserve=0, tail_width=0)
    _kill(monkeypatch, "port", small_indexes, ck, abort_at, **kw)
    _assert_equal(_port(small_indexes, checkpoint=ck, **kw), want)
    assert not os.path.exists(ck)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_resume_across_packages(small_indexes, want, tmp_path, monkeypatch,
                                writer, reader):
    """The resumed run drains at the default out_reserve (which the
    fingerprint does not cover): dsm_tpu's saves cost seconds on the CPU."""
    ck = str(tmp_path / "cross.ckpt")
    _kill(monkeypatch, writer, small_indexes, ck, 2, out_reserve=0,
          tail_width=0)
    _assert_equal(ENGINES[reader][0](small_indexes, checkpoint=ck,
                                     tail_width=0), want)
    assert not os.path.exists(ck)


def _load(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# small enough that the set's drain and history-pull exits save often
SNAP_RESERVE = 1000
SNAP_HIST_CAP = "20000"


def _snapshot_run(engine, idxs, path, out_reserve):
    """Run `engine` with OUT_RESERVE = SNAP_RESERVE and DSM_HIST_CAP =
    SNAP_HIST_CAP; -> (its snapshots, the number of the port's history
    pulls)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSM_HIST_CAP", SNAP_HIST_CAP)
        mp.setattr(jed, "OUT_RESERVE", SNAP_RESERVE)
        mp.setattr(ted, "OUT_RESERVE", SNAP_RESERVE)
        pulls = []
        orig = ted._pull_segment
        mp.setattr(ted, "_pull_segment",
                   lambda *a: (pulls.append(1), orig(*a)))
        snaps = []
        _saves(mp, engine, on_save=lambda p: snaps.append(_load(p)))
        ENGINES[engine][0](idxs, checkpoint=path, out_reserve=out_reserve,
                           tail_width=0)
    return snaps, len(pulls)


@pytest.fixture(scope="module")
def jax_snapshots(small_indexes, tmp_path_factory):
    """dsm_tpu's snapshots of the set, given an out_reserve above
    OUT_RESERVE (clamped to it)."""
    path = str(tmp_path_factory.mktemp("snap") / "jax.ckpt")
    return _snapshot_run("jax", small_indexes, path, 10**6)[0]


def test_snapshots_equal(small_indexes, jax_snapshots, tmp_path):
    """The port's k-th snapshot equals dsm_tpu's, at drain exits and at
    exits that pulled the history to the host."""
    snaps, pulls = _snapshot_run("port", small_indexes,
                                 str(tmp_path / "port.ckpt"), 10**6)
    assert pulls
    assert len(snaps) == len(jax_snapshots) > pulls
    for k, (got, want) in enumerate(zip(snaps, jax_snapshots)):
        assert sorted(got) == sorted(want), k
        for key in want:
            where = f"snapshot {k}: {key}"
            assert got[key].dtype == want[key].dtype, where
            if key in ("st_ent_min", "st_ent_max") and np.isfinite(want[key]):
                assert float(got[key]) == pytest.approx(float(want[key]),
                                                        rel=1e-5), where
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=where)


def test_out_reserve_is_clamped(small_indexes, jax_snapshots, tmp_path):
    """out_reserve above OUT_RESERVE: both engines save where they would
    at OUT_RESERVE itself."""
    depths = {}
    for reserve in (10**6, SNAP_RESERVE):
        snaps, _ = _snapshot_run("port", small_indexes,
                                 str(tmp_path / f"{reserve}.ckpt"), reserve)
        depths[reserve] = [int(z["st_depth"]) for z in snaps]
    assert depths[10**6] == depths[SNAP_RESERVE] == \
        [int(z["st_depth"]) for z in jax_snapshots]


def test_resume_mid_burst_snapshot(small_indexes, want, tmp_path,
                                   monkeypatch):
    """dsm_tpu drains a level gated past EMIT_W rows in node-aligned chunks
    and may snapshot between them (st_eskip > 0); the port resumes it."""
    ck = str(tmp_path / "burst.ckpt")

    def stop_mid_burst(path):
        if int(_load(path)["st_eskip"]) > 0:
            raise _Abort()

    monkeypatch.setattr(jed, "EMIT_W", 4)   # >= the 3 pairs of a node
    jed._jitted_episode.cache_clear()
    try:
        _saves(monkeypatch, "jax", on_save=stop_mid_burst)
        with pytest.raises(_Abort):
            _jax(small_indexes, checkpoint=ck, tail_width=0)
    finally:
        monkeypatch.undo()
        jed._jitted_episode.cache_clear()
    _assert_equal(_port(small_indexes, checkpoint=ck, tail_width=0), want)
    assert not os.path.exists(ck)


def test_resume_after_pulled_segment(small_indexes, want, tmp_path,
                                     monkeypatch):
    """Killed after history pulls (small DSM_HIST_CAP): the snapshot's
    paths cross pulled segments, and the resumed run pulls again."""
    ck = str(tmp_path / "hist.ckpt")
    pulls = []
    orig = ted._pull_segment

    def counted(*a):
        pulls.append(a[2].depth)
        orig(*a)

    kw = dict(out_reserve=0, tail_width=0)
    for run in ("killed", "resumed"):
        monkeypatch.setenv("DSM_HIST_CAP", "1500")
        monkeypatch.setattr(ted, "_pull_segment", counted)
        if run == "killed":
            _kill(monkeypatch, "port", small_indexes, ck, 12, **kw)
            assert pulls, "no history segment was pulled before the kill"
            pulls.clear()
        else:
            _assert_equal(_port(small_indexes, checkpoint=ck, **kw), want)
            assert pulls, "the resumed run pulled no history segment"
    assert not os.path.exists(ck)


def test_fingerprint_drift_is_refused(small_indexes, tmp_path, monkeypatch):
    ck = str(tmp_path / "fp.ckpt")
    _kill(monkeypatch, "port", small_indexes, ck, 1, out_reserve=0)
    with pytest.raises(ValueError, match="different"):
        _port(small_indexes, MiningConfig(fmin=2, emax=99, pmin=1),
              checkpoint=ck)
    with pytest.raises(ValueError, match="different"):
        _port(small_indexes, prefix=b"A", checkpoint=ck)


def test_gnu_order_resume(small_indexes, tmp_path, monkeypatch):
    ck = str(tmp_path / "gnu.ckpt")
    _kill(monkeypatch, "port", small_indexes, ck, 2, out_reserve=0,
          reader_order="gnu")
    _assert_equal(_port(small_indexes, checkpoint=ck, reader_order="gnu"),
                  mine_np(small_indexes, CFG, reader_order="gnu"))


@pytest.fixture(scope="module")
def dsmi_files(small_indexes, tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_cli")
    paths = []
    for i, idx in enumerate(small_indexes):
        paths.append(str(out / f"s{i}.dsmi"))
        idx.save(paths[-1])
    return paths


def test_cli_mine_checkpoint(small_indexes, dsmi_files, tmp_path,
                             monkeypatch, capsysbinary):
    """`python -m dsm_tpu_torch mine --device cpu --checkpoint F` prints
    what `dsm mine` prints, from scratch and from a snapshot left by an
    aborted dsm_tpu run of the same mine."""
    args = ["mine", "-f", "2", "-E", "1.2", "-M", "8", *dsmi_files]
    assert dsm_main(args) == 0
    want = capsysbinary.readouterr().out
    assert want
    ck = tmp_path / "cli.ckpt"
    port_args = [*args, "--device", "cpu", "--checkpoint", str(ck)]
    assert port_main(port_args) == 0
    assert capsysbinary.readouterr().out == want
    assert not ck.exists()
    _kill(monkeypatch, "jax", small_indexes, str(ck), 1,
          cfg=MiningConfig(fmin=2, emax=1.2, maxdepth=8), out_reserve=0)
    assert port_main(port_args) == 0
    assert capsysbinary.readouterr().out == want
    assert not ck.exists()
