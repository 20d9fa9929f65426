"""CPU tests of the benchmark harness (run them with
`python -m pytest dsmbench/ -q`; the repository's `pytest tests/` does
not collect them).

They hold the manifest to its contract's names and cross-references, show
that a new configuration, cell, traffic mix and metric are found by name
as new files, hold the frozen generators to the originals, the plain
reference to the port's host miner, its ascending answers to what they
were before it took a reader order, its gnu order to the reference
server's frozen outputs (tests/golden) and its set model to libstdc++'s
`unordered_set`, and the comparison to its control and to faults planted
in the timed path, in both reader orders, and check that the runner loads
no JAX and refuses to run without a card.
"""

from __future__ import annotations

import gzip
import hashlib
import importlib.util
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "dsmbench"
sys.path.insert(0, str(ROOT))

from dsmbench import check, control, datagen, reference  # noqa: E402
from dsmbench import run as runner  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a tiny configuration of the many-sample generator, for CPU runs
TINY = {"name": "tiny", "generator": "samples", "samples": 6,
        "symbols_asked": 60000, "mining": {"fmin": 2, "pmin": 2,
                                           "emax": 2.0}, "reduced": []}


# the configurations the frozen server outputs were made with
# (tests/oracle.py), in the reference's keywords
GOLDEN_CONFIGS = {
    "default": {"fmin": 2, "emax": 1.2},
    "specific": {"fmin": 5, "emax": 10.0, "pmin": 1, "pmax": 1},
    "wide": {"fmin": 2, "emax": 99.0},
    "filtered": {"fmin": 2, "emax": 1.5, "emin": 0.4, "pmin": 2, "pmax": 4,
                 "mindepth": 8},
    "shallow": {"fmin": 2, "emax": 1.2, "maxdepth": 12},
    "deep1": {"fmin": 7, "emax": 99.0, "pmin": 1}}
TINY_SEED = 2**31 + 5
TINY_JOBS = [b""] + [bytes(p) for p in itertools.product(b"ACGT", repeat=2)]
# sha256 (`digest`) of the reference's answers before it took a reader
# order, at TINY's data from TINY_SEED, for TINY_JOBS
ASCENDING_DIGESTS = [
    ({"fmin": 2, "pmin": 2, "emax": 2.0},
     "fdd8230886131114d5e1709d99f132c1e0e1fa05d207bd28cbcb24f1c940c318"),
    ({"fmin": 2, "pmin": 1, "emax": 99.0},
     "4cad16ab99d4b978ca304d36c741829978bbae9c7d2897dba42966164b888300")]


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line_text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_names_units_and_shape():
    m = manifest()
    assert set(m) == TOP_KEYS
    assert len(json.dumps(m)) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32
    assert all(line_text(w) and not w.startswith("/") and ".." not in w
               for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # the full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s of compile a cell, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_text(c["source"])
        assert line_text(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        names.append(c["name"])
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line_text(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(m["workloads"]) <= 24
    assert {w["config"] for w in m["workloads"]} == set(names)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert p["source"] in SOURCES and line_text(p["layer"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        names.append(x["name"])
    names += [w["name"] for w in m["workloads"]]
    assert len(names) == len(set(names))
    # a layer's metrics name it letter for letter, once
    layers = {p["layer"] for p in m["per_layer"]}
    assert all(layers)


def reports(m: dict, kind: str, metric: str, cell: str) -> bool:
    e = next(x for x in m[kind] if x["name"] == metric)
    return "workloads" not in e or cell in e["workloads"]


def test_every_cell_reports_and_moves_are_reported():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    for cell in cells:
        e2e = [e["name"] for e in m["end_to_end"]
               if reports(m, "end_to_end", e["name"], cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m, "per_layer", p["name"], cell)
                   for p in m["per_layer"])
    for p in m["per_layer"]:
        assert p["moves"] in {e["name"] for e in m["end_to_end"]}
        for cell in p.get("workloads", cells):
            assert cell in cells
            assert reports(m, "end_to_end", p["moves"], cell), (p, cell)


def test_files_match_the_manifest():
    m = manifest()
    for kind in ("end_to_end", "per_layer"):
        for e in m[kind]:
            mod = runner.load_metric(e["name"])
            assert mod.KIND == kind and mod.UNIT == e["unit"]
            assert mod.BETTER == e["better"] and mod.SOURCE == e["source"]
            if kind == "per_layer":
                assert mod.LAYER == e["layer"] and mod.MOVES == e["moves"]
                assert set(mod.WORKLOADS) <= set(e.get("workloads", []))
    for w in m["workloads"]:
        cell = runner.load_json(BENCH / "cells" / f"{w['name']}.json")
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert set(cell["limits"]) == set(check.NAMES)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for c in m["configs"]:
        conf = runner.load_json(ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["generator"] in datagen.GENERATORS


def tiny_copy(tmp_path: Path, traffic: str = "whole.asc",
              name: str = "tiny.whole.asc"):
    """A copy of the benchmark's files with a configuration, a cell and a
    per-layer metric added as new files and manifest entries (no file of
    the copy changed); -> (its dsmbench directory, its manifest)."""
    bench = tmp_path / "dsmbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    m = manifest()
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY))
    limits = runner.load_json(BENCH / "cells" / "d64.whole.asc.json")["limits"]
    (bench / "cells" / f"{name}.json").write_text(json.dumps(
        {"config": "tiny", "traffic": traffic, "chips": 1,
         "limits": limits}))
    (bench / "metrics" / "jobs_done.py").write_text(
        'KIND = "per_layer"\nUNIT = "jobs"\nBETTER = "higher"\n'
        'SOURCE = "host_clock"\nLAYER = "front door, mining.engine.'
        'mine_torch"\nMOVES = "paths_per_s"\nWORKLOADS = []\n\n\n'
        'def read(run):\n    return float(len(run.jobs))\n')
    m["configs"].append({"name": "tiny", "source": "a test", "reduced": [],
                         "file": "dsmbench/configs/tiny.json", "why": "t"})
    m["workloads"].append({"name": name, "config": "tiny",
                           "traffic": traffic, "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "front door, mining.engine.mine_torch",
                           "moves": "paths_per_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    after = {p: p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and p in before}
    assert after == before
    return bench, m


@pytest.mark.parametrize("traffic", ["prefix2.asc", "whole.gnu"])
def test_addition_found_by_name(tmp_path, traffic):
    """A new cell of either traffic runs through run_cell and is correct:
    prefix jobs in ascending order, whole-trie jobs in gnu order."""
    name = f"tiny.{traffic}"
    bench, m = tiny_copy(tmp_path, traffic, name)
    res, run = runner.run_cell(name, 2**31 + 5, 0.5, False, "cpu", bench, m)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"paths_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    # a shuffle of the 16 prefixes, or the whole trie again and again
    assert len({j.prefix for j in run.jobs}) == (
        len(run.jobs) if traffic == "prefix2.asc" else 1)
    # the new per-layer metric is read where the manifest lists it
    mod = runner.load_metric("jobs_done", bench)
    assert mod.read(run) == len(run.jobs)
    assert [e["name"] for e in runner.cell_metrics(
        m, "per_layer", name)] == ["jobs_done"]


def test_job_order_shuffled_by_seed():
    import itertools

    t = {"scope": "prefix", "prefix_depth": 2, "job_order": "shuffled_cycle"}
    a = list(itertools.islice(runner.job_prefixes(t, 3), 32))
    b = list(itertools.islice(runner.job_prefixes(t, 4), 32))
    assert sorted(a[:16]) == sorted(b[:16]) and a[:16] == a[16:]
    assert len(set(a[:16])) == 16 and a != b


def load_tests_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"orig_{name}", ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_recorded_layout_fixes_the_sizes(tmp_path):
    """A layout recorded at one seed and given with two others: the same
    records a sample, of the same lengths but for the repeats' start
    jitter, with other sequences; and the same layout recorded again."""
    rec, again = {}, {}
    datagen.make_samples(str(tmp_path / "r"), 9, 90000, 14, record=rec)
    a = datagen.make_samples(str(tmp_path / "a"), 9, 90000, 1, rec, again)
    b = datagen.make_samples(str(tmp_path / "b"), 9, 90000, 2, rec)
    assert again == rec
    for x, y in zip(a, b):
        rx = reference.fasta_records(x)
        ry = reference.fasta_records(y)
        assert len(rx) == len(ry) and rx != ry
        lx, ly = sum(map(len, rx)), sum(map(len, ry))
        assert abs(lx - ly) <= 0.01 * lx
    toy = {}
    datagen.make_toydata(str(tmp_path / "c"), 2, 0xD5A2, record=toy)
    c = datagen.make_toydata(str(tmp_path / "d"), 2, 5, toy)
    e = datagen.make_toydata(str(tmp_path / "e"), 2, 6, toy)
    assert [len(reference.fasta_records(x)) for x in c] == \
        [len(reference.fasta_records(x)) for x in e]


@pytest.mark.parametrize("name, make", [
    ("d64", lambda out, rec: datagen.make_samples(out, 64, 35_200_000, 14,
                                                  record=rec)),
    ("s1000", lambda out, rec: datagen.make_toydata(out, 1000, 0xD5A2,
                                                    record=rec))])
def test_the_configs_layouts_are_the_golden_seeds(tmp_path, name, make):
    """Each configuration's layout is what its generator records at the
    seed of the frozen references (D64: 14; scale 1000: 0xD5A2)."""
    rec = {}
    make(str(tmp_path), rec)
    assert runner.load_json(BENCH / "configs" / f"{name}.json")["layout"] \
        == json.loads(json.dumps(rec))


@pytest.mark.parametrize("seed", [0xD5A2, 2**31 + 11])
def test_generators_write_the_originals_bytes(tmp_path, seed):
    toy = load_tests_module("make_toydata")
    samples = load_tests_module("freeze_samples_reference")
    for a, b in zip(toy.make_toydata(str(tmp_path / "a"), 2, seed),
                    datagen.make_toydata(str(tmp_path / "b"), 2, seed)):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    for a, b in zip(samples.make_samples(str(tmp_path / "c"), 9, 90000, seed),
                    datagen.make_samples(str(tmp_path / "d"), 9, 90000, seed)):
        assert Path(a).read_bytes() == Path(b).read_bytes()


def same_output(got, want) -> None:
    assert got.total_paths == want.total_paths
    assert got.total_output == want.total_output == len(want.lines)
    assert got.total_occs == want.total_occs
    assert np.array_equal(got.freq_histogram, want.freq_histogram)
    assert [(p, e, [tuple(o) for o in occ]) for p, e, occ in got.lines] == \
        [(p, e, [tuple(o) for o in occ]) for p, e, occ in want.lines]
    assert math.isclose(got.smallest_entropy, want.smallest_entropy,
                        rel_tol=1e-13)
    assert math.isclose(got.largest_entropy, want.largest_entropy,
                        rel_tol=1e-13)


def test_reference_agrees_with_the_host_miner(tmp_path):
    """toydata at scale 1, a seed the goldens never saw: the reference and
    the port's host miner (mine_np, ascending) give the same lines, f64
    entropies and counters, for the whole trie and under prefixes mined
    in one frontier."""
    from dsm_tpu_torch.index.build import indexes_from_fasta
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine_np import mine_np

    paths = datagen.make_toydata(str(tmp_path), 1, 0xBE7C)
    idx = indexes_from_fasta(paths, None)
    ix = reference.RefIndex.from_fasta(paths, "cpu")
    prefixes = [b"", b"A", b"CA", b"TG"]
    got = reference.mine_jobs(ix, prefixes, 2, 2, emax=1.2)
    for p in prefixes:
        want = mine_np(idx, MiningConfig(fmin=2, pmin=2, emax=1.2), prefix=p)
        same_output(got[p], want)
    assert got[b""].total_output > 0 and got[b"A"].total_output > 0


def test_reference_agrees_on_many_samples(tmp_path):
    from dsm_tpu_torch.index.build import indexes_from_fasta
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine_np import mine_np

    paths = datagen.make_samples(str(tmp_path), 12, 150000, 99)
    want = mine_np(indexes_from_fasta(paths, None),
                   MiningConfig(fmin=2, pmin=2, emax=2.0, maxdepth=14))
    ix = reference.RefIndex.from_fasta(paths, "cpu")
    same_output(reference.mine_jobs(ix, [b""], 2, 2, emax=2.0,
                                    maxdepth=14)[b""], want)
    assert want.total_output > 0


def digest(outs: dict) -> str:
    """sha256 of each job's lines (entropies to 12 decimals) and counters."""
    h = hashlib.sha256()
    for p in sorted(outs):
        o = outs[p]
        h.update(repr((p, o.total_paths, o.total_output, o.total_occs,
                       o.freq_histogram.tolist(),
                       round(o.smallest_entropy, 12),
                       round(o.largest_entropy, 12),
                       [(q, round(e, 12), [tuple(x) for x in occ])
                        for q, e, occ in o.lines])).encode())
    return h.hexdigest()


@pytest.mark.parametrize("mining, want", ASCENDING_DIGESTS)
def test_ascending_reference_is_unchanged(tmp_path, mining, want):
    """The ascending reference answers each job as it did before it took
    a reader order, with the argument given or left out."""
    paths = datagen.generate(TINY, TINY_SEED, str(tmp_path))
    ix = reference.RefIndex.from_fasta(paths, "cpu")
    plain = reference.mine_jobs(ix, TINY_JOBS, **mining)
    named = reference.mine_jobs(ix, TINY_JOBS, **mining,
                                reader_order="ascending")
    assert digest(plain) == digest(named) == want
    with pytest.raises(ValueError, match="reader_order"):
        reference.mine_jobs(ix, [b""], **mining, reader_order="level-gnu")


@pytest.fixture(scope="module")
def toy_index(tmp_path_factory):
    """The reference's index of the five toy samples the server outputs
    in tests/golden were frozen from, reader ids in name order."""
    out = tmp_path_factory.mktemp("toydata")
    paths = []
    for gz in sorted((ROOT / "tests" / "data" / "toydata").glob("*.gz")):
        paths.append(str(out / gz.stem))
        Path(paths[-1]).write_bytes(gzip.decompress(gz.read_bytes()))
    return reference.RefIndex.from_fasta(paths, "cpu")


def server_text(lines) -> bytes:
    """Lines as the reference server prints them: the path, the entropy
    by printf("%f") and the id:occs pairs in their order."""
    return b"".join(b"%s %f%s\n" % (p, e, b"".join(b" %d:%d" % o
                                                   for o in occs))
                    for p, e, occs in lines)


def golden(config: str, prefix: str) -> bytes:
    path = ROOT / "tests" / "golden" / f"server-output.{config}.{prefix}.txt.gz"
    return gzip.decompress(path.read_bytes())


@pytest.mark.parametrize("prefix", "ACGT")
@pytest.mark.parametrize("config", list(GOLDEN_CONFIGS))
def test_gnu_reference_prints_the_servers_bytes(toy_index, config, prefix):
    """A gnu job under a one-symbol prefix prints, line for line, what
    that prefix's server printed: path, id:occs in order, %f entropy."""
    out = reference.mine_jobs(toy_index, [prefix.encode()],
                              **GOLDEN_CONFIGS[config],
                              reader_order="gnu")[prefix.encode()]
    assert server_text(out.lines) == golden(config, prefix)
    assert out.total_output == len(out.lines)


@pytest.mark.parametrize("config", list(GOLDEN_CONFIGS))
def test_gnu_whole_trie_is_the_four_servers(toy_index, config):
    out = reference.mine_jobs(toy_index, [b""], **GOLDEN_CONFIGS[config],
                              reader_order="gnu")[b""]
    assert server_text(out.lines) == b"".join(golden(config, p)
                                              for p in "ACGT")


@pytest.fixture(scope="module")
def uset_oracle(tmp_path_factory):
    """tests/cpp/uset_oracle.cpp built: a real libstdc++
    unordered_set<unsigned> that prints its bucket count and iteration
    order after a sequence of inserts."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    exe = tmp_path_factory.mktemp("uset") / "uset_oracle"
    subprocess.run(["g++", "-O2", "-o", str(exe),
                    str(ROOT / "tests" / "cpp" / "uset_oracle.cpp")],
                   check=True)
    return exe


@pytest.mark.parametrize("d", [5, 64, 273])
def test_gnuset_is_libstdcxx_unordered_set(uset_oracle, d):
    """The set model against the real set, at d readers: ascending (the
    root's set), descending, shuffled, subsets, a set's order inserted
    into a fresh one (a readChildren scan), and repeated keys."""
    rng = np.random.default_rng(d)
    seqs = [list(range(d)), list(range(d))[::-1],
            reference.GnuSet(range(d)).order]
    for _ in range(20):
        seqs.append(rng.permutation(d).tolist())
        k = int(rng.integers(1, d + 1))
        seqs.append(rng.choice(d, size=k, replace=False).tolist())
        seqs.append(reference.GnuSet(seqs[-1]).order + seqs[-2][:k])
    ops = []
    for seq in seqs:
        ops += ["n"] + [f"i {k}" for k in seq] + ["d"]
    res = subprocess.run([str(uset_oracle)], input="\n".join(ops + ["q"]),
                         capture_output=True, text=True, check=True)
    lines = res.stdout.splitlines()
    assert len(lines) == len(seqs)
    for seq, line in zip(seqs, lines):
        _o, nbkt, *order = line.split()
        s = reference.GnuSet(seq)
        assert (s.nbkt, s.order) == (int(nbkt), [int(k) for k in order])


@pytest.fixture(scope="module")
def tiny_orders(tmp_path_factory):
    """The port's whole-trie answers on TINY's data in each reader order,
    and the reference's: ({order: answer}, {order: {b"": expected}})."""
    import torch

    from dsm_tpu_torch.index.build import indexes_from_fasta
    from dsm_tpu_torch.mining import engine
    from dsm_tpu_torch.mining.config import MiningConfig

    paths = datagen.generate(TINY, 2**31 + 7,
                             str(tmp_path_factory.mktemp("tiny")))
    cpu = torch.device("cpu")
    idx = indexes_from_fasta(paths, cpu)
    ix = reference.RefIndex.from_fasta(paths, "cpu")
    got, want = {}, {}
    for order in reference.READER_ORDERS:
        got[order] = engine.mine_torch(idx, MiningConfig(**TINY["mining"]),
                                       reader_order=order, device=cpu)
        want[order] = reference.mine_jobs(ix, [b""], **TINY["mining"],
                                          reader_order=order)
    return got, want


@pytest.mark.parametrize("answer", reference.READER_ORDERS)
@pytest.mark.parametrize("expected", reference.READER_ORDERS)
def test_the_reader_order_is_judged(tiny_orders, answer, expected):
    """An answer is correct against the reference of its own order and
    not against the other's: the lines' readers come in another order."""
    got, want = tiny_orders
    limits = runner.load_json(BENCH / "cells" / "d64.whole.gnu.json")[
        "limits"]
    table = check.compare([(b"", got[answer])], want[expected], 0)
    ok, _table = check.judge(table, limits)
    assert ok == (answer == expected)
    assert (table["lines_off"] > 0) == (answer != expected)
    assert got[answer].total_output > 0


def test_suffix_array_is_sorted():
    import torch

    rng = np.random.default_rng(1)
    codes = rng.integers(1, 7, size=3000).astype(np.int8)
    ends = np.array([999, 1999, 2999])
    codes[ends] = 0
    sa = reference.suffix_array(torch.from_numpy(codes),
                                torch.from_numpy(ends)).numpy()
    key = codes.astype(np.int64) + 3
    key[ends] = np.arange(3)
    sufs = [tuple(key[i:].tolist()) for i in range(len(codes))]
    assert sa.tolist() == sorted(range(len(codes)), key=lambda i: sufs[i])


@pytest.mark.parametrize("traffic", ["whole.asc", "whole.gnu"])
def test_control_is_not_correct(tmp_path, traffic):
    bench, m = tiny_copy(tmp_path, traffic, f"tiny.{traffic}")
    res = control.control(f"tiny.{traffic}", 7, "cpu", bench, m)
    assert not res["correct"]
    assert res["checks"]["entropy_gap"][0] > res["checks"]["entropy_gap"][1]


def fault_answer_altered(monkeypatch):
    from dsm_tpu_torch.mining import engine

    orig = engine.mine_torch

    def altered(*a, **k):
        out = orig(*a, **k)
        p, e, occs = out.lines[0]
        out.lines[0] = (p, e, [(occs[0][0], occs[0][1] + 1)] + occs[1:])
        return out

    monkeypatch.setattr(engine, "mine_torch", altered)


def fault_entropy_altered(monkeypatch):
    from dsm_tpu_torch.mining import engine

    orig = engine.mine_torch

    def altered(*a, **k):
        out = orig(*a, **k)
        p, e, occs = out.lines[-1]
        out.lines[-1] = (p, float(np.float32(e)), occs)
        return out

    monkeypatch.setattr(engine, "mine_torch", altered)


def fault_half_left_out(monkeypatch):
    from dsm_tpu_torch.mining import engine

    orig = engine.mine_torch

    def halved(*a, **k):
        out = orig(*a, **k)
        out.lines = out.lines[::2]
        out.total_output = len(out.lines)
        return out

    monkeypatch.setattr(engine, "mine_torch", halved)


def fault_state_unchanged(monkeypatch):
    from dsm_tpu_torch.mining import engine_device

    monkeypatch.setattr(engine_device, "_level",
                        lambda *a, **k: engine_device.FLAG_DONE)


@pytest.mark.parametrize("traffic", ["whole.asc", "whole.gnu"])
@pytest.mark.parametrize("fault", [fault_answer_altered,
                                   fault_entropy_altered,
                                   fault_half_left_out,
                                   fault_state_unchanged])
def test_faults_are_not_correct(tmp_path, monkeypatch, fault, traffic):
    """The rest of a run, with the timed path broken underneath: an answer
    altered where it is produced, an entropy rounded to float32, half of a
    job's lines left out, a level that returns its state unchanged."""
    bench, m = tiny_copy(tmp_path, traffic, f"tiny.{traffic}")
    fault(monkeypatch)
    res, _run = runner.run_cell(f"tiny.{traffic}", 31, 0.2, False, "cpu",
                                bench, m)
    assert not res["correct"]


def test_compare_counts_every_kind_of_difference():
    ref = reference.RefOutput(
        lines=[(b"AC", 1.0, [(0, 3), (1, 4)]), (b"G", 1.1, [(0, 2), (2, 2)])],
        total_paths=10, total_output=2, total_occs=4, smallest_entropy=0.5,
        largest_entropy=2.0, freq_histogram=np.array([0, 2, 0]))
    same = check.compare([(b"", ref)], {b"": ref}, 0)
    assert check.judge(same, dict.fromkeys(check.NAMES, 0))[0]
    bad = reference.RefOutput(**{**ref.__dict__, "lines": ref.lines[::-1],
                                 "largest_entropy": float("nan")})
    got = check.compare([(b"", bad)], {b"": ref}, 1)
    assert got["lines_off"] == 1 and got["range_gap"] == float("inf")
    assert got["failed_jobs"] == 1


def test_the_runner_loads_no_jax(tmp_path):
    bench, m = tiny_copy(tmp_path)
    (tmp_path / "m.json").write_text(json.dumps(m))
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from pathlib import Path\n"
            "from dsmbench import run as r\n"
            f"m = json.load(open({str(tmp_path / 'm.json')!r}))\n"
            f"r.run_cell('tiny.whole.asc', 3, 0.2, False, 'cpu', "
            f"Path({str(bench)!r}), m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.splitlines()[-1]
    top = {n.split(".")[0] for n in json.loads(out)}
    assert "dsm_tpu_torch" in top
    assert not top & set(runner.FORBIDDEN)


def test_the_yardstick_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import dsmbench.reference, dsmbench.check, dsmbench.datagen\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    top = set(json.loads(out.replace("'", '"')))
    assert not top & {"dsm_tpu_torch", "dsm_tpu", "jax", "jaxlib", "flax"}


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "dsmbench/run.py", "--workload", "s1000.whole.asc",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and dsmbench/: the program is
    missing, so a run fails before any result."""
    shutil.copytree(BENCH, tmp_path / "dsmbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from dsmbench import run as r\n"
            "r.run_cell('s1000.whole.asc', 1, 0.1, False, 'cpu')\n"
            % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and "dsm_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""


def test_trace_reduction():
    kernels = {"rank_kernel"}
    ev = [("dsmbench.job", False, 0, 1000), ("dsmbench.job", False, 1100, 2000),
          ("dsmbench.level", False, 0, 500),
          ("dsmbench.tail", False, 1500, 2000),
          ("void (anonymous namespace)::rank_kernel<1>(Args)", True, 100, 300),
          ("Memcpy DtoH (Device -> Pageable)", True, 250, 600),
          ("void at::native::elementwise_kernel<128>(int)", True, 1200, 1300),
          ("dsmbench.job", True, 0, 1000)]
    t = runner.read_trace(ev, kernels)
    assert t.jobs == 2 and t.window_s == 2000e-9
    assert math.isclose(t.busy_s, 600e-9) and t.kernel_s == 200e-9
    gaps = {n.split(" (")[0]: v for n, v in t.idle_gaps}
    assert gaps == pytest.approx({"tail": 700e-9,
                                  "job, outside the phases": 600e-9,
                                  "level": 100e-9})
    with pytest.raises(RuntimeError, match="no device activity"):
        runner.read_trace(ev[:4], kernels)


def test_port_kernel_names():
    names = runner.port_kernels()
    assert {"rank_kernel", "segstats_kernel", "children_kernel"} <= names
    assert runner.is_port_kernel(
        "void (anonymous namespace)::children_kernel<false>((anonymous "
        "namespace)::Level)", names)
    assert not runner.is_port_kernel(
        "void at::native::vectorized_elementwise_kernel<4>(int)", names)
