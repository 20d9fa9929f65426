"""The port's spans and counters (dsm_tpu_torch/utils/trace.py) on the CPU.

A job's `profile` counters are held against independent counts: the
level loop's pairs, the history pull's bytes and the host tail's levels
against the trie's levels as the host miner (engine_np) walks them, the drained rows against the rows the drains
hand to their host half.  The old keys and the lines stay as they were,
each child span is within its parent, and the set-up spans land in
`trace.PROCESS`.  Under a CPU `torch.profiler` with the annotations on,
a job is one `dsm.job` span holding a `dsm.level` a level, a `dsm.drain`
a drain call, a `dsm.pull` a HISTFULL exit and at most one `dsm.tail`;
with them off, `record_function` is never called and no `dsm.*` event is
recorded.  A gnu job's reader-order tracker fills `gnu_s` (within the
drains' and the tail's host spans, a `dsm.gnu` span an answer),
`gnu_nodes` and `gnu_lines` (its output's lines); an ascending job's read
0.  The CLI's DSM_TRACE writes a Chrome trace of the spans.  The
benchmark's readers of these keys (dsmbench/metrics/) read a hand-made
run.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsm_tpu_torch.cli.main import main as port_main
from dsm_tpu_torch.index.alphabet import transform
from dsm_tpu_torch.index.fmindex import FMIndex
from dsm_tpu_torch.mining import engine_device as ted
from dsm_tpu_torch.mining import engine_np
from dsm_tpu_torch.mining.config import MiningConfig
from dsm_tpu_torch.mining.engine import DeviceIndexes, mine_torch
from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
from dsm_tpu_torch.parallel.multihost import global_samples_mesh
from dsm_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
CFG = MiningConfig(fmin=1, emax=99, pmin=1)
# small enough that a run takes several HISTFULL exits
HIST_CAP = "1500"
OLD_KEYS = {"level_s", "drain_s", "tail_s", "pull_s", "save_s", "levels",
            "drains", "saves", "histfull", "pulled_levels", "tail_depth"}
CHILDREN = {"level_wait_s": "level_s", "emit_s": "drain_s",
            "pull_copy_s": "pull_s", "wavefront_s": "tail_s"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU episodes: the suite's
    workers share the cores, and an episode's many small ops each wait on
    every thread of the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indexes() -> list[FMIndex]:
    """Three samples of 14 reads of one 600-base genome (the checkpoint
    tests' set), fresh: their dense tables not built yet."""
    rng = np.random.default_rng(1234)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=600)]
    idxs = []
    for _ in range(3):
        texts = [transform(genome[int(rng.integers(0, 500)):][:90].tobytes())
                 for _ in range(14)]
        idxs.append(FMIndex.from_texts(texts, device="cpu"))
    return idxs


@pytest.fixture(scope="module")
def idxs():
    return _indexes()


@pytest.fixture(scope="module")
def trie(idxs):
    """The trie's levels as the host miner walks them: depth -> (nodes,
    (node, sample) pairs with a nonempty interval), and its output."""
    levels = {0: (1, len(idxs))}
    orig = engine_np.emit_level

    def record(out, cfg, d, depth, paths, freq, *a):
        levels[depth] = (freq.shape[0], int((freq > 0).sum()))
        return orig(out, cfg, d, depth, paths, freq, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_np, "emit_level", record)
        want = engine_np.mine_np(idxs, CFG)
    return levels, want


def _run(engine, idxs, mp, **kw):
    """One job of `engine` under DSM_HIST_CAP = HIST_CAP, recording each
    pull's (depth, levels) and each drain's rows -> (output, profile,
    pulls, drained rows)."""
    mp.setenv("DSM_HIST_CAP", HIST_CAP)
    pulls, rows = [], []
    pull0, emit0 = ted._pull_segment, ted._emit_drained
    mp.setattr(ted, "_pull_segment", lambda *a: (
        pulls.append((a[2].depth, len(a[2].lvl_off))), pull0(*a))[1])

    def emit(*a):
        rows.append(a[6].shape[0])
        return emit0(*a)

    mp.setattr(ted, "_emit_drained", emit)
    if engine == "sharded":
        from dsm_tpu_torch.parallel import engine_episode

        mp.setattr(engine_episode, "_emit_drained", emit)
    prof = {}
    if engine == "sharded":
        out = mine_device_sharded(idxs, CFG, mesh=global_samples_mesh(
            2, "cpu"), profile=prof, **kw)
    else:
        out = mine_torch(idxs, CFG, device="cpu", profile=prof, **kw)
    return out, prof, pulls, rows


@pytest.mark.parametrize("engine,tail_width", [
    ("single", 0), ("single", 768), ("sharded", 768)])
def test_counters_match_the_trie(idxs, trie, monkeypatch, engine,
                                 tail_width):
    levels, want = trie
    out, prof, pulls, rows = _run(engine, idxs, monkeypatch, out_reserve=50,
                                  tail_width=tail_width)
    assert out.format_lines() == want.format_lines()
    assert out.total_paths == want.total_paths
    assert OLD_KEYS <= set(prof) and "halt_s" not in prof
    assert prof["histfull"] == len(pulls) > 2
    assert prof["pulled_levels"] == sum(k for _d, k in pulls)

    last = max(levels) + 1 if prof["tail_depth"] is None else \
        prof["tail_depth"]
    if tail_width:
        assert prof["tail_depth"] is not None
    run = list(range(last)) + [d for d, _k in pulls]   # redone levels too
    assert prof["levels"] == len(run)
    assert prof["pairs"] == sum(levels[d][1] for d in run)
    # a pull moves one int32 a node of each level of its segment
    assert prof["pull_bytes"] == 4 * sum(
        levels[e][0] for d, k in pulls for e in range(d - k + 1, d + 1))
    assert prof["drain_rows"] == sum(rows) > 0
    host = [d for d in levels if d >= last]
    assert prof["tail_levels"] == len(host)

    for child, parent in CHILDREN.items():
        assert 0 <= prof[child] <= prof[parent]
    assert prof["level_wait_s"] > 0 and prof["pull_copy_s"] > 0
    assert prof["emit_s"] > 0
    assert (prof["wavefront_s"] > 0) == bool(host)


@pytest.mark.parametrize("order", ["gnu", "ascending"])
@pytest.mark.parametrize("engine,tail_width", [
    ("single", 0), ("single", 768), ("sharded", 768)])
def test_gnu_counters(idxs, monkeypatch, engine, tail_width, order):
    out, prof, _pulls, _rows = _run(engine, idxs, monkeypatch,
                                    out_reserve=50, tail_width=tail_width,
                                    reader_order=order)
    plain = mine_torch(idxs, CFG, device="cpu", reader_order=order)
    assert out.format_lines() == plain.format_lines()
    if order == "ascending":
        assert prof["gnu_s"] == prof["gnu_nodes"] == prof["gnu_lines"] == 0
        return
    assert out.format_lines() == engine_np.mine_np(
        idxs, CFG, reader_order="gnu").format_lines()
    assert 0 < prof["gnu_s"] <= prof["emit_s"] + prof["wavefront_s"]
    assert prof["gnu_nodes"] > 0
    assert prof["gnu_lines"] == len(out.lines) > 0


def test_set_up_spans():
    """The dense tables' first build is the process's `tables_s`, within
    the first job's host wavefront; the upload's packing and copies are
    the process's `pack_s` and `copy_s`."""
    p = trace.PROCESS
    was = {k: p.get(k, 0) for k in ("pack_s", "copy_s", "tables_s")}
    fresh = _indexes()
    dev = DeviceIndexes.build(fresh, "cpu")
    assert p["pack_s"] > was["pack_s"] and p["copy_s"] > was["copy_s"]
    first, again = {}, {}
    mine_torch(fresh, CFG, device="cpu", dev=dev, profile=first)
    assert first["tail_depth"] is not None
    built = p["tables_s"] - was["tables_s"]
    assert 0 < built <= first["wavefront_s"] <= first["tail_s"]
    mine_torch(fresh, CFG, device="cpu", dev=dev, profile=again)
    assert again["tail_depth"] is not None
    assert p["tables_s"] - was["tables_s"] == built


def test_timed_is_a_span_around_one_call():
    prof = {}
    assert trace.timed(prof, "x_s", divmod, 7, 2) == (3, 1)
    assert trace.timed(prof, "x_s", len, "abc") == 3
    assert trace.timed(None, "x_s", len, "ab") == 2
    assert set(prof) == {"x_s"} and prof["x_s"] > 0
    trace.annotate(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
            assert trace.timed(prof, "x_s", len, "abcd") == 4
    finally:
        trace.annotate(False)
    assert [e[0] for e in _events(tp) if e[0].startswith("dsm.")] == ["dsm.x"]


def _events(prof) -> list:
    """(name, start ns, end ns) of a profile's events, from the profiler's
    own results (building `prof.events()` takes seconds here)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _annotated(idxs, monkeypatch, order):
    """One single-device job in `order` under a CPU profiler with the
    annotations on -> (its `dsm.*` events, its profile, its drain
    calls)."""
    drains = []
    drain0 = ted._drain
    monkeypatch.setattr(ted, "_drain", lambda *a: (drains.append(1),
                                                   drain0(*a))[1])
    trace.annotate(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _out, job, _pulls, _rows = _run("single", idxs, monkeypatch,
                                            out_reserve=50,
                                            reader_order=order)
    finally:
        trace.annotate(False)
    return [e for e in _events(prof) if e[0].startswith("dsm.")], job, drains


def test_annotations_nest_in_the_job(idxs, monkeypatch):
    ev, job, drains = _annotated(idxs, monkeypatch, "ascending")
    names = [e[0] for e in ev]
    assert names.count("dsm.job") == 1
    assert names.count("dsm.level") == job["levels"]
    assert names.count("dsm.level_wait") == job["levels"]
    assert names.count("dsm.drain") == len(drains) > 2
    assert names.count("dsm.pull") == job["histfull"] > 2
    assert names.count("dsm.tail") == 1
    assert "dsm.gnu" not in names
    j0, j1 = next((s, t) for n, s, t in ev if n == "dsm.job")
    assert all(j0 <= s <= t <= j1 for _n, s, t in ev)


def test_gnu_annotations_nest_in_the_host_halves(idxs, monkeypatch):
    """A gnu job's tracker opens a `dsm.gnu` span for each line's order
    and for its entropy sum, each within a drain's host half (`dsm.emit`)
    or the tail's wavefront (`dsm.wavefront`)."""
    ev, job, _drains = _annotated(idxs, monkeypatch, "gnu")
    gnu = [(s, t) for n, s, t in ev if n == "dsm.gnu"]
    hosts = [(s, t) for n, s, t in ev if n in ("dsm.emit", "dsm.wavefront")]
    assert len(gnu) == 2 * job["gnu_lines"] > 0
    assert all(any(h0 <= s <= t <= h1 for h0, h1 in hosts) for s, t in gnu)


def test_annotations_off_call_no_record_function(idxs, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with annotations off")

    assert not trace.ANNOTATE
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tables0 = trace.PROCESS.get("tables_s", 0.0)
        fresh = _indexes()
        out, job, pulls, _rows = _run("single", fresh, monkeypatch,
                                      out_reserve=50)
    assert job["histfull"] and out.total_output
    assert trace.PROCESS["tables_s"] > tables0
    assert not [e for e in _events(prof) if e[0].startswith("dsm.")]


def test_cli_trace_file(idxs, tmp_path, monkeypatch, capsysbinary):
    paths = []
    for i, idx in enumerate(idxs):
        paths.append(str(tmp_path / f"s{i}.dsmi"))
        idx.save(paths[-1])
    args = ["mine", "--device", "cpu", "-f", "2", "-E", "1.2", *paths]
    assert port_main(args) == 0
    plain = capsysbinary.readouterr().out
    monkeypatch.setenv("DSM_TRACE", str(tmp_path / "trace"))
    assert port_main(args) == 0
    assert capsysbinary.readouterr().out == plain
    assert not trace.ANNOTATE
    with open(tmp_path / "trace" / f"mine-{os.getpid()}.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dsm.job", "dsm.level", "dsm.drain"} <= names


def _readers():
    sys.path.insert(0, str(ROOT))
    from dsmbench import run as runner

    return runner


def _job(runner, **prof):
    return runner.Job(b"", 0.1, 100, prof)


@pytest.mark.parametrize("name,want", [
    ("level_wait_ms", 1e3 * (0.002 + 0.004) / 2),
    ("level_ns_per_pair", 1e9 * (0.01 + 0.03) / (1000 + 3000)),
    ("pull_gbps", (4e8 + 0) / (0.2 + 0) / 1e9),
    ("emit_ms", 1e3 * (0.001 + 0.003) / 2),
    ("wavefront_ms", 1e3 * (0.02 + 0.04) / 2),
    ("emit_us_per_row", 1e6 * (0.001 + 0.003) / (10 + 30)),
    ("wavefront_us_per_level", 1e6 * (0.02 + 0.04) / (20 + 40)),
    ("tables_s", 12.5),
    ("pack_s", 1.5),
    ("gnu_ms", 1e3 * (0.5 + 1.5) / 2),
    ("gnu_us_per_node", 1e6 * (0.5 + 1.5) / (100 + 300))])
def test_benchmark_readers(monkeypatch, name, want):
    runner = _readers()
    run = runner.Run(cell="s1000.whole.asc", jobs=[
        _job(runner, level_s=0.01, level_wait_s=0.002, pairs=1000,
             pull_copy_s=0.2, pull_bytes=400_000_000, emit_s=0.001,
             drain_rows=10, wavefront_s=0.02, tail_levels=20, gnu_s=0.5,
             gnu_nodes=100),
        _job(runner, level_s=0.03, level_wait_s=0.004, pairs=3000,
             pull_copy_s=0.0, pull_bytes=0, emit_s=0.003,
             drain_rows=30, wavefront_s=0.04, tail_levels=40, gnu_s=1.5,
             gnu_nodes=300)])
    monkeypatch.setattr(trace, "PROCESS", {"tables_s": 12.5, "pack_s": 1.5})
    reader = runner.load_metric(name)
    assert reader.read(run) == pytest.approx(want)
    # a program without these keys reads nothing, and does not raise
    monkeypatch.setattr(trace, "PROCESS", {})
    assert reader.read(runner.Run(cell="s1000.whole.asc", jobs=[
        _job(runner, level_s=0.01)])) is None


def test_pull_gbps_without_a_pull():
    runner = _readers()
    run = runner.Run(cell="s1000.prefix2.asc", jobs=[
        _job(runner, pull_copy_s=0.0, pull_bytes=0)])
    assert runner.load_metric("pull_gbps").read(run) is None


def test_gnu_us_per_node_without_a_node():
    """An ascending job's tracker keys read 0: no rate a node."""
    runner = _readers()
    run = runner.Run(cell="d64.whole.gnu", jobs=[
        _job(runner, gnu_s=0.0, gnu_nodes=0)])
    assert runner.load_metric("gnu_us_per_node").read(run) is None
    assert runner.load_metric("gnu_ms").read(run) == 0.0
