"""The port's mining slice end to end (dsm_tpu_torch) against dsm_tpu.

`mine_torch(device="cpu")` runs the port's episode with the kernels'
plain versions.  It is held against the JAX episode (`mine_tpu`, CPU
backend) and the NumPy oracle (`mine_np`) on the toydata of
tests/test_engine_tpu.py, on a small set mined to full depth (tail
handoff, drain and history-full exits) and in gnu reader order against
the reference server's frozen output.  Exact: the emitted bytes,
total_paths, total_output, total_occs and freq_histogram.  The entropy
min/max diagnostics (f32 on the TPU path): absolute 5e-6.

Enforced prefixes on the device engine (`prefix=`): `A`, `GA`, one under
which the trie is empty, one longer than maxdepth, and one longer than
dsm_tpu's PFX_MAX = 16 symbols (dsm_tpu refuses it: held against the
port's own `mine_np` alone), exactly.

The CLI, `python -m dsm_tpu_torch mine --device cpu`, must print what
`dsm mine` prints, also with `--engine numpy`, and `enumerate --check`
what `dsm enumerate --check` prints; `--engine auto` and `--num-hosts`
exit 1; the port must not import jax; and CUDA asked for where there is
none is an error, not a quiet move to the CPU.
"""

import glob
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine import mine_tpu
from dsm_tpu.mining.engine_np import mine_np
from dsm_tpu_torch import convert
from dsm_tpu_torch.mining.engine import mine_torch as port_mine_torch
from dsm_tpu_torch.mining.engine_np import mine_np as port_mine_np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOYDATA = os.path.join(HERE, "data", "toydata")
GOLDEN = os.path.join(HERE, "golden")
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}

CONFIGS = {
    "default": MiningConfig(fmin=2, emax=1.2, maxdepth=10),
    "filtered": MiningConfig(fmin=2, emax=1.5, emin=0.4, pmin=2, pmax=4,
                             mindepth=8, maxdepth=11),
}


@pytest.fixture(scope="module")
def indexes():
    return [FMIndex.from_texts([transform(r.seq) for r in read_fasta(p)])
            for p in sorted(glob.glob(os.path.join(TOYDATA,
                                                   "toy*.fasta.gz")))]


@pytest.fixture(scope="module")
def small_indexes():
    """3 samples sharing fragments of a 500bp genome + private junk: mined
    to full depth, past the tail handoff."""
    rng = np.random.default_rng(1234)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=500)]
    idxs = []
    for _ in range(3):
        texts = [transform(genome[s:s + 80].tobytes())
                 for s in rng.integers(0, 420, size=12)]
        texts.append(transform(np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, size=200)].tobytes()))
        idxs.append(FMIndex.from_texts(texts))
    return idxs


def mine_torch(idxs, cfg, **kw):
    """The port's front door on its own FMIndex and MiningConfig classes,
    converted from dsm_tpu's."""
    return port_mine_torch([convert.fmindex_from_jax(i) for i in idxs],
                           convert.config_from_jax(cfg), **kw)


def assert_same(got, want, entropy_tol=None):
    assert got.format_lines() == want.format_lines()
    assert got.total_paths == want.total_paths
    assert got.total_output == want.total_output
    assert got.total_occs == want.total_occs
    np.testing.assert_array_equal(got.freq_histogram, want.freq_histogram)
    if entropy_tol is not None:
        assert abs(got.smallest_entropy - want.smallest_entropy) < entropy_tol
        assert abs(got.largest_entropy - want.largest_entropy) < entropy_tol


@pytest.mark.parametrize("config", list(CONFIGS))
def test_mine_torch_matches_jax_and_numpy(indexes, config):
    cfg = CONFIGS[config]
    got = mine_torch(indexes, cfg, device="cpu")
    assert got.total_output > 0
    assert_same(got, mine_np(indexes, cfg), entropy_tol=1e-12)
    assert_same(got, mine_tpu(indexes, cfg), entropy_tol=5e-6)


@pytest.mark.parametrize("exits", ["tail", "device-only", "drain+histfull"])
def test_mine_torch_full_depth(small_indexes, exits, monkeypatch):
    """Full depth: the host tail handoff at its default width, an episode
    that never hands off, and one that drains every level and pulls its
    history to the host every few levels."""
    cfg = MiningConfig(fmin=2, emax=99)
    kw = {"tail": {}, "device-only": {"tail_width": 0},
          "drain+histfull": {"out_reserve": 0}}[exits]
    if exits == "drain+histfull":
        monkeypatch.setenv("DSM_HIST_CAP", "1500")
    got = mine_torch(small_indexes, cfg, device="cpu", **kw)
    assert_same(got, mine_np(small_indexes, cfg), entropy_tol=1e-12)


def test_mine_torch_gnu_matches_reference_golden(indexes):
    """gnu reader order, prefix A: the reference server's own stdout."""
    cfg = MiningConfig(fmin=2, emax=1.2)
    got = mine_torch(indexes, cfg, prefix=b"A", reader_order="gnu",
                     device="cpu")
    with gzip.open(os.path.join(GOLDEN,
                                "server-output.default.A.txt.gz")) as f:
        assert got.format_lines() == f.read()
    want = mine_tpu(indexes, cfg, prefix=b"A", reader_order="gnu")
    assert_same(got, want, entropy_tol=5e-6)


# a path the toydata mines at depth 114: its first 12 symbols are longer
# than CONFIGS["default"]'s maxdepth, its first 17 than dsm_tpu's PFX_MAX
DEEP = b"AATCTCCTGTTAAGAATCGAGCGC"
PREFIXES = {"A": b"A", "GA": b"GA", "empty-trie": b"GATTACAGAT",
            "past-maxdepth": DEEP[:12], "past-16": DEEP[:17],
            "past-16-empty": b"A" * 17}


@pytest.mark.parametrize("case", list(PREFIXES))
@pytest.mark.parametrize("depth", ["maxdepth-10", "unbounded"])
def test_mine_torch_enforced_prefix(indexes, case, depth):
    prefix = PREFIXES[case]
    cfg = CONFIGS["default"] if depth == "maxdepth-10" \
        else MiningConfig(fmin=2, emax=1.2)
    got = mine_torch(indexes, cfg, prefix=prefix, device="cpu")
    want = port_mine_np([convert.fmindex_from_jax(i) for i in indexes],
                        convert.config_from_jax(cfg), prefix=prefix)
    assert_same(got, want, entropy_tol=1e-12)
    if case == "empty-trie":
        assert got.total_output == 0
    if case == "past-16" and depth == "unbounded":
        assert got.total_output == 1
    if len(prefix) <= 16:
        assert_same(got, mine_np(indexes, cfg, prefix=prefix),
                    entropy_tol=1e-12)
        if depth == "maxdepth-10":   # the JAX episode: once a prefix
            assert_same(got, mine_tpu(indexes, cfg, prefix=prefix),
                        entropy_tol=5e-6)
    else:
        with pytest.raises(ValueError, match="longer than 16"):
            mine_tpu(indexes, cfg, prefix=prefix)


@pytest.fixture(scope="module")
def dsmi_files(indexes, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_cli")
    paths = []
    for i, idx in enumerate(indexes):
        path = str(out / f"toy{i}.dsmi")
        idx.save(path)
        paths.append(path)
    return paths


def _run(module, *args, env=ENV):
    return subprocess.run([sys.executable, "-m", module, *args],
                          env=env, cwd=REPO, capture_output=True)


def test_cli_mine_matches_dsm_mine(dsmi_files):
    args = ["mine", "-f", "2", "-E", "1.2", "-M", "8", "-v", *dsmi_files]
    want = _run("dsm_tpu", *args)
    got = _run("dsm_tpu_torch", *args, "--device", "cpu")
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and got.stdout
    assert got.stderr.decode().splitlines()[-4:] == \
        want.stderr.decode().splitlines()[-4:]


def test_cli_mine_engine_numpy_matches_dsm(dsmi_files):
    """--engine numpy: the host engine, with no device asked for."""
    args = ["mine", "--engine", "numpy", "-f", "2", "-E", "1.2", "-M", "8",
            "--prefix", "GA", "--reader-order", "gnu", "-v", *dsmi_files]
    want = _run("dsm_tpu", *args)
    got = _run("dsm_tpu_torch", *args,
               env={**ENV, "CUDA_VISIBLE_DEVICES": ""})
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and got.stdout
    assert got.stderr.decode().splitlines()[-4:] == \
        want.stderr.decode().splitlines()[-4:]


def test_cli_enumerate_check_matches_dsm(dsmi_files, tmp_path):
    """enumerate --check: the index's self-test, OK on a sound index and
    FAILED (exit 1) on one whose last occ checkpoint counts one A too
    many."""
    from dsm_tpu_torch.index.fmindex import FMIndex as PortFMIndex

    bad = PortFMIndex.load(dsmi_files[0])
    bad.table.occ[bad.n >> 7, 2] += 1   # the checkpoint rank(A, n) reads
    broken = str(tmp_path / "broken.dsmi")
    bad.save(broken)
    for path, rc in ((dsmi_files[0], 0), (broken, 1)):
        want = _run("dsm_tpu", "enumerate", "--check", path)
        got = _run("dsm_tpu_torch", "enumerate", "--check", path)
        assert want.returncode == got.returncode == rc, got.stderr.decode()
        assert got.stderr.decode().splitlines()[-1] == \
            want.stderr.decode().splitlines()[-1]
    # without --check the client reads `host port prefix` triplets on
    # stdin, and refuses none as dsm's does
    want = _run("dsm_tpu", "enumerate", dsmi_files[0])
    got = _run("dsm_tpu_torch", "enumerate", dsmi_files[0])
    assert want.returncode == got.returncode == 1
    assert got.stderr.decode().splitlines()[-1] == \
        want.stderr.decode().splitlines()[-1] == "error: empty host info"


@pytest.mark.parametrize("flags", [["--engine", "auto"],
                                   ["--num-hosts", "2", "--host-id", "0"]])
def test_cli_unported_mine_flags_exit_1(dsmi_files, flags):
    """These flags exited 1 until the port took capacity planning and
    prefix ownership; now they mine, and print what `dsm mine --engine
    numpy` prints with the same share of the prefixes."""
    args = ["mine", "-f", "2", "-E", "1.2", "-M", "8", *dsmi_files]
    got = _run("dsm_tpu_torch", *args, "--device", "cpu", *flags)
    dsm_flags = [f for f in flags if f not in ("--engine", "auto")]
    want = _run("dsm_tpu", *args, "--engine", "numpy", *dsm_flags)
    assert got.returncode == want.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and got.stdout


def test_port_never_imports_jax(dsmi_files):
    code = (
        "import sys\n"
        "from dsm_tpu_torch.cli.main import main\n"
        f"main(['mine', '--device', 'cpu', '-f', '2', '-E', '1.2', '-M', "
        f"'8', *{dsmi_files!r}])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n")
    p = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                       capture_output=True)
    assert p.returncode == 0, p.stderr.decode()
    assert p.stdout


def test_no_cuda_is_an_error(dsmi_files):
    """With no visible GPU, CUDA is refused: by resolve_device, by the CLI
    without --device cpu and by chip_smoke.py."""
    env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, "-c",
         "from dsm_tpu_torch.utils.device import resolve_device\n"
         "resolve_device('cuda')"], env=env, cwd=REPO, capture_output=True)
    assert p.returncode != 0 and b"CUDA is not available" in p.stderr
    p = _run("dsm_tpu_torch", "mine", "-f", "2", "-E", "1.2", *dsmi_files,
             env=env)
    assert p.returncode != 0 and not p.stdout
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True)
    assert p.returncode != 0 and b'"ok"' not in p.stdout
