"""The port in the reference server's gnu reader order at 64 readers,
against the benchmark's plain reference (dsmbench/reference.py), on the
CPU: the `d64.whole.gnu` cell's comparison at a small size.

Data: `dsmbench.datagen.make_samples(64, 300,000 symbols, seed)` at two
seeds, about 4,700 symbols a sample.  Gates: d64's fmin 2 and pmin 2,
with emax 5.3 in place of its 1.2: every reader's pseudo-count of one
holds a node's entropy near log2(64) = 6 until its counts reach the
thousands, so at this size emax 1.2 (and 4.5, at a seed tried) prints
no line; at 5.3 a job at these seeds prints 23-571 lines, half of them or
more with 8 readers or more, so the order of sets of many readers is
tested.

Each job (the whole trie and the one-symbol prefixes A/C/G/T, each a
server of its own as in the reference) is mined by
`mine_torch(reader_order="gnu", device="cpu")` and judged by
`dsmbench.check` under `dsmbench/cells/d64.whole.gnu.json`'s limits: it
is correct.  The ascending answer of the whole trie, judged against the
same gnu reference, is not: its lines' readers come in another order.
"""

import json
from pathlib import Path

import pytest
import torch

from dsm_tpu_torch.index.build import indexes_from_fasta
from dsm_tpu_torch.mining.config import MiningConfig
from dsm_tpu_torch.mining.engine import mine_torch
from dsmbench import check, datagen, reference

ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "dsmbench" / "cells" / "d64.whole.gnu.json")
                    .read_text())["limits"]
MINING = {"fmin": 2, "pmin": 2, "emax": 5.3}
SAMPLES, SYMBOLS = 64, 300_000
SEEDS = (2**31 + 27, 2**32 + 101)
JOBS = (b"", b"A", b"C", b"G", b"T")


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
def sets(tmp_path_factory):
    """seed -> (the port's indexes, the reference's index) of one set."""
    out = {}
    for seed in SEEDS:
        paths = datagen.make_samples(
            str(tmp_path_factory.mktemp(f"d64-{seed}")), SAMPLES, SYMBOLS,
            seed)
        out[seed] = (indexes_from_fasta(paths, torch.device("cpu")),
                     reference.RefIndex.from_fasta(paths, "cpu"))
    return out


def _judge(out, prefix: bytes, want) -> tuple[bool, dict]:
    return check.judge(check.compare([(prefix, out)], want, 0), LIMITS)


@pytest.mark.parametrize("prefix", JOBS)
@pytest.mark.parametrize("seed", SEEDS)
def test_gnu_jobs_are_the_reference(sets, seed, prefix):
    idx, ix = sets[seed]
    out = mine_torch(idx, MiningConfig(**MINING), prefix=prefix,
                     reader_order="gnu", device="cpu")
    want = reference.mine_jobs(ix, [prefix], **MINING, reader_order="gnu")
    ok, table = _judge(out, prefix, want)
    assert ok, table
    assert max(len(occs) for _p, _e, occs in out.lines) >= 8


@pytest.mark.parametrize("seed", SEEDS)
def test_ascending_is_not_the_gnu_reference(sets, seed):
    idx, ix = sets[seed]
    out = mine_torch(idx, MiningConfig(**MINING), reader_order="ascending",
                     device="cpu")
    want = reference.mine_jobs(ix, [b""], **MINING, reader_order="gnu")
    ok, table = _judge(out, b"", want)
    assert not ok and table["lines_off"][0] > 0
    assert table["paths_off"][0] == table["counters_off"][0] == 0
