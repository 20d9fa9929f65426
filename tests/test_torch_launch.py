"""The port's fleet launcher (dsm_tpu_torch/cli/launch.py, `python -m
dsm_tpu_torch launch`) on the CPU (mirror of tests/test_launch.py:45,78).

Local mode runs 4 `serve` and 5 `enumerate` processes of the port on
localhost and must reproduce the frozen goldens byte for byte; slurm mode
writes 16 + 5 sbatch scripts that run the port; config mode writes the
discovery files alone.  The helpers and the scripts are held against
dsm_tpu's.  The indexes are dsm_tpu's, built in the process from the
toydata and saved; the base port is picked free at run time.
"""

from __future__ import annotations

import glob
import gzip
import os
import random
import socket
import subprocess
import sys

import pytest

from dsm_tpu.cli import launch as jlaunch
from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu_torch.cli import launch
from dsm_tpu_torch.cli.main import main as port_main

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
TOYDATA = os.path.join(HERE, "data", "toydata")
ENV = {**os.environ, "PYTHONPATH": REPO}


def golden(config: str, prefix: str) -> bytes:
    with gzip.open(os.path.join(
            GOLDEN, f"server-output.{config}.{prefix}.txt.gz")) as f:
        return f.read()


def free_base_port(n: int) -> int:
    """A port p with p .. p + n - 1 all free now."""
    for _ in range(200):
        base = random.randrange(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_idx")
    paths = []
    for fa in sorted(glob.glob(os.path.join(TOYDATA, "toy*.fasta.gz"))):
        name = os.path.basename(fa)[: -len(".fasta.gz")]
        paths.append(str(out / (name + ".dsmi")))
        FMIndex.from_texts([transform(r.seq) for r in read_fasta(fa)]
                           ).save(paths[-1])
    return paths


def test_launch_local(indexes, tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "dsm_tpu_torch", "launch", "--mode", "local",
         "--tmpdir", str(tmp_path / "tmp"), "--outdir", str(tmp_path / "out"),
         "--base-port", str(free_base_port(4)), "-E", "1.2", "-f", "2",
         *indexes], env=ENV, cwd=REPO, capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr.decode()
    assert p.stdout.decode().splitlines() == [
        str(tmp_path / "out" / f"server-output.{h}.txt") for h in "ACGT"]
    for prefix in "ACGT":
        got = (tmp_path / "out" / f"server-output.{prefix}.txt").read_bytes()
        assert got == golden("default", prefix), f"prefix {prefix}"


def test_launch_slurm_emission(indexes, tmp_path, capsys):
    tmp = tmp_path / "tmp"
    assert port_main(["launch", "--mode", "slurm", "--tmpdir", str(tmp),
                      "--outdir", str(tmp_path / "out"), "--hash-depth", "2",
                      *indexes]) == 0
    scripts = capsys.readouterr().out.splitlines()
    assert len(scripts) == 16 + 5  # 4**2 servers + 5 clients
    body = open(scripts[0]).read()
    assert "metaserver_config_AA.txt" in body and "sbatch" not in body
    assert "python -m dsm_tpu_torch serve -p 52000 --emax 1.2" in body
    client = open(scripts[16]).read()
    assert f"python -m dsm_tpu_torch enumerate --fmin 2 {indexes[0]}" \
        in client
    # the scripts are dsm_tpu's with the port's commands (dsm_tpu's
    # emission rewrites the same files)
    ours = [open(x).read() for x in scripts]
    samples = [os.path.basename(x)[:-len(".dsmi")] for x in indexes]
    theirs = jlaunch.emit_slurm(
        samples=samples, indexes=indexes, tmpdir=str(tmp),
        outdir=str(tmp_path / "out"), samplelist=str(tmp / "samples.txt"),
        hash_depth=2, server_cmd="python -m dsm_tpu_torch serve",
        client_cmd="python -m dsm_tpu_torch enumerate")
    assert theirs == scripts
    assert [open(x).read() for x in theirs] == ours


def test_launch_config_mode(indexes, tmp_path, capsys):
    tmp = tmp_path / "tmp"
    assert port_main(["launch", "--mode", "config", "--tmpdir", str(tmp),
                      "--base-port", "53000", "--hash-depth", "1",
                      *indexes]) == 0
    paths = capsys.readouterr().out.splitlines()
    assert [os.path.basename(x) for x in paths] == [
        f"metaserver_config_{h}.txt" for h in "ACGT"]
    host = socket.gethostname()
    assert launch.read_discovery(str(tmp)) == jlaunch.read_discovery(
        str(tmp)) == [(host, 53000 + i, h) for i, h in enumerate("ACGT")]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefix_hashes_match_dsm_tpu(depth):
    assert launch.prefix_hashes(depth) == jlaunch.prefix_hashes(depth)


def test_launch_refuses_duplicate_sample_names(indexes, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["launch", "--mode", "config", "--tmpdir", str(tmp_path),
                   indexes[0], indexes[0]])
    assert e.value.code == 1
    assert "duplicate sample names" in capsys.readouterr().err
