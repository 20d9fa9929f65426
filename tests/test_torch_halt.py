"""The port's halt steering (`mine_device(halt=)`, `_apply_halt`) against
dsm_tpu's `mine_device(halt=)` and `mine_np`.

Both engines poll `halt(depth, out)` at the same exits (drain, history
pull and tail, after the drain) and prune the frontier under the returned
prefixes from the next level on.  With the same callback the port's
halted output equals dsm_tpu's byte for byte, with equal counters and
equal poll depths; halting nothing is the identity.  tests/test_halt.py's
index set, on CPU tensors (the kernels' plain versions).  Exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining import engine_device as jed
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_np import mine_np
from dsm_tpu_torch.mining import engine_device as ted

CFG = MiningConfig(fmin=2, emax=1.9)


@pytest.fixture(scope="module")
def indexes():
    """tests/test_halt.py's index set."""
    rng = np.random.default_rng(0xA117)
    idxs = []
    for _ in range(3):
        texts = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  int(rng.integers(400, 900))))
                 for _ in range(3)]
        idxs.append(FMIndex.from_texts(
            [np.frombuffer(t, np.uint8) for t in texts]))
    return idxs


def _steer(schedule):
    """A halt callback returning schedule[k] at its k-th poll (the last
    entry from then on); -> (callback, the polled depths)."""
    depths = []

    def halt(depth, out):
        depths.append(depth)
        return schedule[min(len(depths), len(schedule)) - 1]

    return halt, depths


def _counters(out):
    return (out.total_paths, out.total_output, out.total_occs,
            out.freq_histogram.tolist())


# per poll: the prefixes to halt.  Longer than the first polls' depth, a
# letter outside EXT_CHARS, an empty prefix, a prefix that starts late.
SCHEDULES = {
    "A": [[b"A"]],
    "deep_and_foreign": [[b"ACGTACGTACGTACGTACGTACGTACGT", b"N", b"cA"],
                         [b"GC", b"TTA"]],
    "late": [[], [], [b"C"], [b"CA", b"G"]],
    "everything": [[], [b""]],
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_halt_equals_dsm_tpu(indexes, name):
    runs = {}
    for engine, mine in (("port", lambda **kw: ted.mine_device(
            indexes, CFG, device="cpu", **kw)),
                         ("jax", lambda **kw: jed.mine_device(
                             indexes, CFG, **kw))):
        halt, depths = _steer(SCHEDULES[name])
        runs[engine] = (mine(out_reserve=1, halt=halt), depths)
    (got, got_depths), (want, want_depths) = runs["port"], runs["jax"]
    assert got_depths and got_depths == want_depths
    assert got.format_lines() == want.format_lines()
    assert _counters(got) == _counters(want)
    # every schedule halts something
    assert got.total_output < mine_np(indexes, CFG).total_output


def test_halt_prunes_only_its_subtree(indexes):
    """tests/test_halt.py's three properties, for the port."""
    halt, depths = _steer([[b"A"]])
    got = ted.mine_device(indexes, CFG, device="cpu", out_reserve=1,
                          halt=halt)
    h = depths[0]
    got_lines = got.format_lines().splitlines(keepends=True)
    want_lines = mine_np(indexes, CFG).format_lines().splitlines(
        keepends=True)
    assert set(got_lines) <= set(want_lines)
    assert len(got_lines) < len(want_lines)
    for ln in got_lines:
        p = ln.split(b" ", 1)[0]
        assert not (p.startswith(b"A") and len(p) > h), (ln, h)
    outside = [ln for ln in want_lines if not ln.startswith(b"A")]
    assert [ln for ln in got_lines if not ln.startswith(b"A")] == outside


def test_halt_nothing_is_identity(indexes):
    halt, depths = _steer([[]])
    got = ted.mine_device(indexes, CFG, device="cpu", out_reserve=1,
                          halt=halt)
    want = mine_np(indexes, CFG)
    assert depths
    assert got.format_lines() == want.format_lines()
    assert _counters(got) == _counters(want)
