"""The HISTFULL history pull (`mining/engine_device._pull_segment`) on the
CPU.

Under a small DSM_HIST_CAP a job takes several HISTFULL exits.  On the
CPU each pull copies the segment to a pageable array that shares no
memory with the history buffer the next level rewrites, holds the
segment's entries as they were when it was pulled, and counts no
page-locked pull; the job's lines equal `engine_np.mine_np`'s, on the
single-device and the sample-sharded episode.  A page-locked allocation
that raises changes nothing on the CPU, which never asks for one.  On
the card the pull lands in page-locked memory that the next job reuses
(tests/test_torch_cuda.py, `-k pull`).
"""

import numpy as np
import pytest
import torch

from dsm_tpu_torch.index.alphabet import transform
from dsm_tpu_torch.index.fmindex import FMIndex
from dsm_tpu_torch.mining import engine_device as ted
from dsm_tpu_torch.mining import engine_np
from dsm_tpu_torch.mining.config import MiningConfig
from dsm_tpu_torch.mining.engine import mine_torch
from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
from dsm_tpu_torch.parallel.multihost import global_samples_mesh

CFG = MiningConfig(fmin=1, emax=99, pmin=1)
# small enough that a run takes several HISTFULL exits
HIST_CAP = "1500"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU episodes: the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def idxs():
    """Three samples of 14 reads of one 600-base genome."""
    rng = np.random.default_rng(1234)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=600)]
    out = []
    for _ in range(3):
        texts = [transform(genome[int(rng.integers(0, 500)):][:90].tobytes())
                 for _ in range(14)]
        out.append(FMIndex.from_texts(texts, device="cpu"))
    return out


@pytest.fixture(scope="module")
def want(idxs):
    return engine_np.mine_np(idxs, CFG)


def _mine(engine, idxs, prof):
    if engine == "sharded":
        return mine_device_sharded(idxs, CFG, mesh=global_samples_mesh(
            2, "cpu"), profile=prof)
    return mine_torch(idxs, CFG, device="cpu", profile=prof)


def pinned_refused(mp) -> list:
    """Make every page-locked `torch.empty` raise as a failed cudaHostAlloc
    would; -> the list that records each such call.  The card's fallback
    test (tests/test_torch_cuda.py) uses it too."""
    asked, empty = [], torch.empty

    def refuse(*a, **kw):
        if kw.get("pin_memory"):
            asked.append(a)
            raise RuntimeError("CUDA error: out of memory")
        return empty(*a, **kw)

    mp.setattr(torch, "empty", refuse)
    return asked


@pytest.mark.parametrize("engine", ["single", "sharded"])
def test_pull_copies_the_segment(idxs, want, monkeypatch, engine):
    monkeypatch.setenv("DSM_HIST_CAP", HIST_CAP)
    pulls = []
    orig = ted._pull_segment

    def pull(ph, seg_depth0, st, prof=None):
        held = set(ph.levels)
        seg = st.hist[:st.hist_len].clone()
        orig(ph, seg_depth0, st, prof)
        new = [ph.levels[d] for d in sorted(set(ph.levels) - held)]
        pulls.append((seg, new, st.hist.numpy()))

    monkeypatch.setattr(ted, "_pull_segment", pull)
    prof = {}
    out = _mine(engine, idxs, prof)
    assert out.format_lines() == want.format_lines()
    assert out.total_paths == want.total_paths
    assert prof["histfull"] == len(pulls) > 2
    assert prof["pull_pinned"] == 0
    for seg, new, buf in pulls:
        # the segment as pulled, though the buffer was rewritten since
        np.testing.assert_array_equal(np.concatenate(new), seg.numpy())
        assert not any(np.shares_memory(a, buf) for a in new)


def test_refused_page_locking_leaves_the_cpu_pull(idxs, want, monkeypatch):
    monkeypatch.setenv("DSM_HIST_CAP", HIST_CAP)
    asked = pinned_refused(monkeypatch)
    prof = {}
    out = mine_torch(idxs, CFG, device="cpu", profile=prof)
    assert out.format_lines() == want.format_lines()
    assert prof["histfull"] > 2 and prof["pull_pinned"] == 0
    assert asked == []


def test_host_copy_on_the_cpu():
    seg = torch.arange(10, dtype=torch.int32)
    prof = {"pull_pinned": 0}
    got = ted._host_copy(seg[2:7], prof)
    np.testing.assert_array_equal(got, np.arange(2, 7, dtype=np.int32))
    assert not np.shares_memory(got, seg.numpy())
    seg.zero_()
    np.testing.assert_array_equal(got, np.arange(2, 7, dtype=np.int32))
    assert prof["pull_pinned"] == 0
