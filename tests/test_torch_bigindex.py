"""Capacity planning of the port (dsm_tpu_torch/mining/bigindex.py, `mine
--engine auto`) against dsm_tpu's, on the CPU (mirror of
tests/test_bigindex.py).

The port's `table_bytes` is what its `DeviceIndexes` charges, and its
`episode_bytes` counts its own buffers, so the budgets below are each
package's own sizes: a plan's mode is held against dsm_tpu's at the same
place relative to them, and a mine routed by it against `mine_np` and
dsm_tpu's `mine_big`.  The indexes are dsm_tpu's (4 samples of 3 random
texts), carried over by convert.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dsm_tpu.cli.main import main as dsm_main
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining import bigindex as jbig
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_np import mine_np
from dsm_tpu_torch import convert
from dsm_tpu_torch.cli.main import main as port_main
from dsm_tpu_torch.mining import bigindex as big
from dsm_tpu_torch.mining.engine import DeviceIndexes
from dsm_tpu_torch.ops.rank import ROWW

CFG = MiningConfig(fmin=2, emax=1.6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU episodes: the suite's
    workers share the cores, and an episode's many small ops each wait on
    every thread of the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_indexes(seed: int, samples: int = 4):
    rng = np.random.default_rng(seed)
    idxs = []
    for _s in range(samples):
        texts = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  int(rng.integers(300, 900))))
                 for _ in range(3)]
        idxs.append(FMIndex.from_texts(
            [np.frombuffer(t, np.uint8) for t in texts]))
    return idxs


@pytest.fixture(scope="module")
def indexes():
    return _random_indexes(0xB16)


@pytest.fixture(scope="module")
def pidx(indexes):
    return [convert.fmindex_from_jax(i) for i in indexes]


@pytest.mark.parametrize("seed,samples", [(0xB16, 4), (1, 1), (2, 3),
                                          (3, 7)])
def test_table_bytes_is_the_device_charge(seed, samples):
    pidx = [convert.fmindex_from_jax(i)
            for i in _random_indexes(seed, samples)]
    dev = DeviceIndexes.build(pidx, "cpu")
    assert big.table_rows(pidx) == dev.frows.shape[0]
    assert big.table_bytes(pidx) == 2 * dev.frows.shape[0] * ROWW * 4


def test_episode_bytes_counts_the_largest_level(pidx):
    """The pairs and nodes of a level, and the staged rows, halve with
    fmin 2; the history buffer and the scratch do not."""
    n = sum(i.n for i in pidx)
    one, two = big.episode_bytes(pidx, 1), big.episode_bytes(pidx, 2)
    assert one - two == (big.PAIR_BYTES + big.NODE_BYTES
                         + 3 * 5 * 4) * (n - n // 2)
    assert big.episode_bytes(pidx, n + 1) == \
        (big.PAIR_BYTES + big.NODE_BYTES + 3 * 5 * 4) * len(pidx) \
        + 3 * 5 * 4 * big.OUT_RESERVE + 4 * (1 << 20) + big.SCRATCH_BYTES


def _budgets(mod, idxs):
    """The test_bigindex.py:30 budgets in each package's own sizes."""
    eb, tb = mod.episode_bytes(idxs), mod.table_bytes(idxs)
    return {"device": (tb + eb + 1000, 1), "shard": (tb // 2 + eb + 4096, 4),
            "host": (eb + 1024, 2)}


@pytest.mark.parametrize("want", ["device", "shard", "host"])
def test_plan_modes(indexes, pidx, want):
    budget, devices = _budgets(big, pidx)[want]
    p = big.plan(pidx, budget=budget, devices_available=devices)
    jbudget, jdevices = _budgets(jbig, indexes)[want]
    jp = jbig.plan(indexes, budget=jbudget, devices_available=jdevices)
    assert p.mode == jp.mode == want
    if want == "device":
        assert p.devices == 1
        assert p.resident_bytes == big.table_bytes(pidx) + \
            big.episode_bytes(pidx)
    elif want == "shard":
        assert 2 <= p.devices <= 4 and p.resident_bytes <= budget
    else:
        assert "host" in p.reason and p.devices == 0


def test_plan_shards_as_the_sharded_tables_do(pidx):
    """The shard plan sizes the consecutive, equal-count shards that
    ShardedIndexes makes, and stops at MAX_SHARDS a process."""
    eb = big.episode_bytes(pidx)
    per = [big._rows(i.n) for i in pidx]
    for ndev in (2, 3, 4):
        worst = max(sum(per[k * 4 // ndev:(k + 1) * 4 // ndev])
                    for k in range(ndev))
        p = big.plan(pidx, budget=2 * worst * ROWW * 4 + eb,
                     devices_available=8)
        assert p.mode == "shard" and p.devices <= ndev


def test_plan_respects_max_shards(pidx, monkeypatch):
    budget = big.episode_bytes(pidx) + 2 * max(
        big._rows(i.n) for i in pidx) * ROWW * 4
    assert big.plan(pidx, budget=budget, devices_available=8).mode == "shard"
    monkeypatch.setattr(big, "MAX_SHARDS", 2)
    p = big.plan(pidx, budget=budget, devices_available=8)
    assert p.mode == "host"


def test_mine_big_respects_tiny_budget(indexes, pidx):
    """A budget too small for any device residency mines with the host
    wavefront, byte-identically."""
    want = mine_np(indexes, CFG)
    got = big.mine_big(pidx, convert.config_from_jax(CFG),
                       budget=big.episode_bytes(pidx) + 1024,
                       devices_available=1, device="cpu")
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths


def test_mine_big_shard_mode(indexes, pidx, capsys):
    """A budget that forces sample sharding routes to the sharded episode
    (several shards on the one CPU device, said on stderr) and matches
    mine_np and dsm_tpu's mine_big in shard mode."""
    want = mine_np(indexes, CFG)
    jbudget = jbig.table_bytes(indexes) // 2 + jbig.episode_bytes(indexes) \
        + 4096
    assert jbig.plan(indexes, budget=jbudget,
                     devices_available=8).mode == "shard"
    jgot = jbig.mine_big(indexes, CFG, budget=jbudget, devices_available=8)
    budget = big.table_bytes(pidx) // 2 + big.episode_bytes(pidx, 2) + 4096
    p = big.plan(pidx, budget=budget, devices_available=8, fmin=2)
    assert p.mode == "shard"
    got = big.mine_big(pidx, convert.config_from_jax(CFG), budget=budget,
                       devices_available=8, verbose=True, device="cpu")
    err = capsys.readouterr().err
    assert f"mine_big: shard — sample axis sharded over {p.devices}" in err
    assert f"{p.devices} shards a process share cpu" in err
    assert got.format_lines() == want.format_lines() == jgot.format_lines()
    assert got.total_paths == want.total_paths == jgot.total_paths


def test_device_build_raises_over_budget(pidx, monkeypatch):
    """DeviceIndexes.build raises the sizing error that names the way out
    (not an out-of-memory error) when the tables exceed the budget."""
    monkeypatch.setenv("DSM_HBM_BYTES", "1024")
    with pytest.raises(ValueError, match="mine_big") as e:
        DeviceIndexes.build(pidx, "cpu")
    assert "--engine auto" in str(e.value)


@pytest.fixture(scope="module")
def paths(indexes, tmp_path_factory):
    out = tmp_path_factory.mktemp("bigindex_idx")
    found = []
    for i, idx in enumerate(indexes):
        found.append(str(out / f"s{i}.dsmi"))
        idx.save(found[-1])
    return found


@pytest.mark.parametrize("mode", ["device", "host"])
def test_cli_engine_auto_routes_by_the_plan(pidx, paths, capsysbinary, mode):
    """`mine --engine auto --hbm-budget N --device cpu -v`: the stderr line
    names the plan's mode, stdout is `dsm mine`'s."""
    budget = {"device": big.table_bytes(pidx) + big.episode_bytes(pidx, 2),
              "host": big.episode_bytes(pidx, 2)}[mode]
    args = ["mine", "-f", "2", "-E", "1.6", *paths]
    assert dsm_main([*args, "--engine", "numpy"]) == 0
    want = capsysbinary.readouterr().out
    assert big.plan(pidx, budget=budget, fmin=2, device="cpu").mode == mode
    assert port_main([*args, "--engine", "auto", "--hbm-budget", str(budget),
                      "--device", "cpu", "-v"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    assert f"mine_big: {mode} — ".encode() in got.err
    assert f"budget {budget:,})".encode() in got.err


def test_cli_engine_auto_refuses_a_prefix(paths, capsysbinary):
    for main in (dsm_main, port_main):
        with pytest.raises(SystemExit) as e:
            main(["mine", "-E", "1.6", "--engine", "auto", "--prefix", "A",
                  *paths])
        assert e.value.code == 1
        assert b"--engine auto does not take --prefix" in \
            capsysbinary.readouterr().err


def test_cli_engine_auto_wants_cuda_without_device_cpu(paths, capsys):
    """Without --device cpu, `--engine auto` wants CUDA as the other device
    commands do, and exits 1 where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(SystemExit) as e:
        port_main(["mine", "-E", "1.6", "--engine", "auto", *paths])
    assert e.value.code == 1
    assert "CUDA is not available" in capsys.readouterr().err
