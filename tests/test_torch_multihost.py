"""Prefix ownership of the port (dsm_tpu_torch/parallel/multihost.py,
`mine --num-hosts`) against dsm_tpu's, on the CPU.

(a) `owned_prefixes` and `prefix_depth` equal dsm_tpu's over a grid of
    (hosts, host id, hash depth), uneven splits and the error cases
    included.
(b) The port's `mine_owned` for every host, with engine "numpy" and with
    the episode on the CPU, equals dsm_tpu's `mine_owned(engine="numpy")`
    host by host (lines in bytes and every counter), and the hosts'
    outputs merged by `merge_outputs` equal dsm_tpu's merge, which is the
    full mine.
(c) Two CLI processes with `--coordinator` (a gloo group on the CPU),
    each mining its own prefixes: their stdouts merged in post-order equal
    `dsm mine`'s (mirror of tests/test_multihost.py:42).
(d) The CLI with `--num-hosts 2` and its refusals, against `dsm mine`.
(e) A sharded episode in a 2-process gloo group whose processes disagree
    on the snapshot raises on both, within the test's time limit (this
    file's `__main__` is the worker).

The indexes are dsm_tpu's, built in the process from the toydata, carried
over by convert.py.
"""

import glob
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOYDATA = os.path.join(HERE, "data", "toydata")


def _worker(rank: int, init_file: str, snapshot: str) -> None:
    """One gloo process of test (e): the sharded episode on the toydata
    with the snapshot path `snapshot`, which exists for rank 0 alone."""
    sys.path.insert(0, REPO)
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fasta import read_fasta
    from dsm_tpu_torch.index.fmindex import FMIndex
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.parallel.engine_episode import mine_device_sharded
    from dsm_tpu_torch.parallel.multihost import (global_samples_mesh,
                                                  initialize)

    initialize(f"file://{init_file}", 2, rank, backend="gloo")
    idxs = [FMIndex.from_texts([transform(r.seq) for r in read_fasta(p)],
                               device=None)
            for p in sorted(glob.glob(os.path.join(TOYDATA,
                                                   "toy*.fasta.gz")))[:2]]
    try:
        mine_device_sharded(idxs, MiningConfig(fmin=2, emax=1.2),
                            mesh=global_samples_mesh(1, "cpu"),
                            checkpoint=snapshot)
    except ValueError as e:
        print(e, file=sys.stderr)
        raise SystemExit(3)
    raise SystemExit(0)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])


import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dsm_tpu.cli.main import main as dsm_main  # noqa: E402
from dsm_tpu.index.alphabet import transform  # noqa: E402
from dsm_tpu.index.fasta import read_fasta  # noqa: E402
from dsm_tpu.index.fmindex import FMIndex  # noqa: E402
from dsm_tpu.mining.config import MiningConfig  # noqa: E402
from dsm_tpu.mining.engine_np import mine_np  # noqa: E402
from dsm_tpu.parallel import mesh as jmesh  # noqa: E402
from dsm_tpu.parallel import multihost as jmh  # noqa: E402
from dsm_tpu_torch import convert  # noqa: E402
from dsm_tpu_torch.cli.main import main as port_main  # noqa: E402
from dsm_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dsm_tpu_torch.parallel import multihost as pmh  # noqa: E402

CFG = MiningConfig(fmin=2, emax=1.2)
MINE = ["mine", "-f", "2", "-E", "1.2"]


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
def paths(indexes, tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost_idx")
    found = []
    for i, idx in enumerate(indexes):
        found.append(str(out / f"toy{i}.dsmi"))
        idx.save(found[-1])
    return found


@pytest.fixture(scope="module")
def dsm_full(indexes):
    """What `dsm mine -f 2 -E 1.2` prints for the toydata."""
    return mine_np(indexes, CFG).format_lines()


def _postorder(blob: bytes) -> bytes:
    """Lines in the reference server's post-order (sort by path + 0xFF)."""
    lines = blob.splitlines(keepends=True)
    return b"".join(sorted(lines, key=lambda ln: ln.split(b" ", 1)[0]
                           + b"\xff"))


# ---------------------------------------------- (a) the ownership split --

def _owned(mod, hosts, host, depth):
    try:
        return mod.owned_prefixes(hosts, host, depth)
    except ValueError as e:
        return ("ValueError", str(e))


GRID = [(h, i, d) for h in (1, 2, 3, 4, 5, 7, 16, 17)
        for i in sorted({0, 1, h // 2, h - 1, h})
        for d in (None, 1, 2, 3)] + [(2, -1, None), (0, 0, 1), (65, 3, 3)]


@pytest.mark.parametrize("hosts,host,depth", GRID)
def test_owned_prefixes_match_dsm_tpu(hosts, host, depth):
    got = _owned(pmh, hosts, host, depth)
    assert got == _owned(jmh, hosts, host, depth)


def test_owned_prefixes_partition_every_depth():
    for hosts, depth in ((3, 2), (5, 2), (7, 3), (16, 2)):
        owned = [p for h in range(hosts)
                 for p in pmh.owned_prefixes(hosts, h, depth)]
        assert sorted(owned) == owned and len(owned) == 4 ** depth
        sizes = [len(pmh.owned_prefixes(hosts, h, depth))
                 for h in range(hosts)]
        assert max(sizes) - min(sizes) <= 1


def test_prefix_depth_matches_dsm_tpu():
    for n in range(0, 300):
        assert pmesh.prefix_depth(n) == jmesh.prefix_depth(n)


# ------------------------------------------------- (b) mine_owned, merge --

def _counters(out):
    return (out.total_paths, out.total_output, out.total_occs,
            np.asarray(out.freq_histogram).tolist(),
            float(out.smallest_entropy), float(out.largest_entropy))


@pytest.fixture(scope="module")
def jax_owned(indexes):
    """dsm_tpu's mine_owned(engine="numpy") a (hosts, depth, host), run
    once."""
    found = {}

    def owned(hosts, depth, host):
        key = (hosts, depth, host)
        if key not in found:
            found[key] = jmh.mine_owned(indexes, CFG, hosts, host, depth,
                                        engine="numpy")
        return found[key]
    return owned


@pytest.mark.parametrize("engine", ["numpy", "episode"])
@pytest.mark.parametrize("hosts,depth", [(2, None), (3, 2)])
def test_mine_owned_matches_dsm_tpu(indexes, pidx, jax_owned, engine, hosts,
                                    depth):
    """Host by host and merged: the port's parts (the host engine, or the
    episode on the CPU) against dsm_tpu's host engine."""
    pcfg = convert.config_from_jax(CFG)
    ours, theirs = [], []
    for host in range(hosts):
        want = jax_owned(hosts, depth, host)
        got = pmh.mine_owned(pidx, pcfg, hosts, host, depth,
                             engine="numpy" if engine == "numpy" else "tpu",
                             device="cpu")
        assert got.format_lines() == want.format_lines()
        assert _counters(got) == pytest.approx(_counters(want))
        ours.append(got)
        theirs.append(want)
    merged = pmh.merge_outputs(ours, len(pidx))
    jmerged = jmh.merge_outputs(theirs, len(indexes))
    assert merged.format_lines() == jmerged.format_lines()
    assert _counters(merged) == pytest.approx(_counters(jmerged))
    # a run under a prefix of length 2 also counts the prefix's depth-1
    # node, as dsm_tpu's runs (and the reference's servers) do: each of the
    # four depth-1 nodes is counted by the four runs under it
    assert merged.total_paths == 527_621 + (12 if depth == 2 else 0)


# -------------------------------- (c) two processes with --coordinator --

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_with_coordinator(paths, dsm_full):
    # one thread a process: two processes that each take every core for
    # their tensor operations slow each other down several times
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dsm_tpu_torch", *MINE, "--device", "cpu",
         "--num-hosts", "2", "--host-id", str(h), "--coordinator", coord,
         *paths], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for h in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()
    assert all(out for out, _err in outs)
    assert _postorder(outs[0][0] + outs[1][0]) == dsm_full


# --------------------------------------------------------- (d) the CLI --

@pytest.mark.parametrize("engine", ["numpy"])
def test_cli_num_hosts(paths, dsm_full, capsysbinary, engine):
    """Each host's stdout against `dsm mine --engine numpy --num-hosts 2`'s,
    with -v's counters (the episode engine runs the CLI in (c))."""
    blobs = []
    for host in range(2):
        args = [*MINE, "--num-hosts", "2", "--host-id", str(host), "-v",
                *paths]
        assert dsm_main([*args, "--engine", "numpy"]) == 0
        want = capsysbinary.readouterr()
        assert port_main([*args, "--engine", engine, "--device", "cpu"]) == 0
        got = capsysbinary.readouterr()
        assert got.out == want.out
        assert got.err.splitlines()[-4:] == want.err.splitlines()[-4:]
        blobs.append(got.out)
    assert _postorder(b"".join(blobs)) == dsm_full


@pytest.mark.parametrize("extra,message", [
    (["--num-hosts", "2"], b"dsm mine: --num-hosts requires --host-id"),
    (["--num-hosts", "2", "--host-id", "0", "--prefix", "A"],
     b"dsm mine: --prefix and --num-hosts are exclusive"),
])
def test_cli_num_hosts_refusals(paths, capsysbinary, extra, message):
    for main in (dsm_main, port_main):
        with pytest.raises(SystemExit) as e:
            main([*MINE, "--engine", "numpy", *extra, *paths])
        assert e.value.code == 1
        assert message in capsysbinary.readouterr().err


# ------------------------------------------- (e) the group's snapshot --

def test_group_disagreeing_on_the_snapshot_raises_on_every_rank(tmp_path):
    """Rank 0 finds its snapshot, rank 1 finds none at its own path: both
    raise the ValueError that names the path, and neither hangs in a
    collective."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    init = str(tmp_path / "rendezvous")
    (tmp_path / "snap0.ckpt").write_bytes(b"")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), init,
         str(tmp_path / f"snap{rank}.ckpt")], env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for rank in range(2)]
    try:
        errs = [p.communicate(timeout=90)[1].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 3, err
        assert f"snap{rank}.ckpt" in err
        assert "exists on 1 of 2 processes" in err
        assert "a path that every process sees" in err
