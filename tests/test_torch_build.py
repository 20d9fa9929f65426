"""The port's index build (dsm_tpu_torch/index, `python -m dsm_tpu_torch
build`) against dsm_tpu's.

On the CPU the suffix arrays run the plain PyTorch version.  Exact:
the port's `FMIndex.from_texts` (sorting on the device, or on the host
with device=None) equals dsm_tpu's (JAX backend and numpy)
in every table array, the counts, the metadata and the SA samples; the
incremental build equals dsm_tpu's; the CLI's `.dsmi` loads to the arrays
of `dsm build --sa-backend numpy`'s, its `.fmi` is byte-equal, and its -v
stderr is `dsm build -v`'s line for line apart from the backend and the
timings.  CUDA asked for where there is none is an error.
"""

import glob
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.index.incremental import IncrementalBuilder as DsmIncremental
from dsm_tpu_torch.cli.main import main as port_main
from dsm_tpu_torch.index.fmindex import FMIndex as PortFMIndex
from dsm_tpu_torch.index.incremental import IncrementalBuilder

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOYDATA = os.path.join(HERE, "data", "toydata")
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
FASTAS = [os.path.join(TOYDATA, f) for f in ("toy2.fasta.gz",
                                             "toy4.fasta.gz")]


@pytest.fixture(scope="module")
def texts():
    """80 records of toy0: n = 12,960 symbols per direction."""
    recs = list(read_fasta(os.path.join(TOYDATA, "toy0.fasta.gz")))[:80]
    return [transform(r.seq) for r in recs], [r.name for r in recs]


def assert_same_index(got, want: FMIndex) -> None:
    for a, b in ((got.table, want.table), (got.rtable, want.rtable)):
        for field in ("blocks", "occ", "counts", "C"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
        assert a.n == b.n
    assert (got.n, got.number_of_texts, got.max_text_length, got.samplerate,
            got.names) == (want.n, want.number_of_texts, want.max_text_length,
                           want.samplerate, want.names)


@pytest.mark.parametrize("backend,sample_sa,device", [
    ("jax", False, "cpu"), ("numpy", True, "cpu"), ("numpy", True, None)])
def test_fmindex_from_texts_matches_dsm(texts, backend, sample_sa, device):
    seqs, names = texts
    got = PortFMIndex.from_texts(seqs, names, samplerate=31, device=device,
                                 sample_sa=sample_sa)
    want = FMIndex.from_texts(seqs, names, samplerate=31, sa_backend=backend,
                              sample_sa=sample_sa)
    assert_same_index(got, want)
    if sample_sa:
        for field in ("rows", "vals", "text_starts"):
            np.testing.assert_array_equal(getattr(got.sa_samples, field),
                                          getattr(want.sa_samples, field))
    else:
        assert got.sa_samples is None


def test_incremental_build_matches_dsm(texts):
    seqs, names = texts
    got_b = IncrementalBuilder(buffer_symbols=5000, device="cpu")
    want_b = DsmIncremental(buffer_symbols=5000)
    for t, nm in zip(seqs, names):
        got_b.insert(t, nm)
        want_b.insert(t, nm)
    assert_same_index(got_b.finish(), want_b.finish())


def _loaded(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mask(stderr: str) -> list[str]:
    return [re.sub(r"\d+\.\ds", "T", line) for line in stderr.splitlines()]


@pytest.fixture
def inputs(tmp_path):
    """The FASTA inputs copied into a fresh directory per tool, so each
    writes its default output names beside its own copies."""
    def copy(tool: str) -> list[str]:
        d = tmp_path / tool
        d.mkdir()
        return [shutil.copy(f, d) for f in FASTAS]
    return copy


@pytest.mark.parametrize("extra", [[], ["--buffer-symbols", "3000"]])
def test_cli_build_dsmi_matches_dsm(inputs, capsys, extra):
    want_in, got_in = inputs("dsm"), inputs("port")
    p = subprocess.run([sys.executable, "-m", "dsm_tpu", "build", "-v",
                        "--sa-backend", "numpy", *extra, *want_in],
                       env=ENV, cwd=REPO, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr
    assert port_main(["build", "-v", "--device", "cpu", *extra,
                      *got_in]) == 0
    err = capsys.readouterr().err
    lines = _mask(err)
    assert lines[0] == "builder: sa-backend auto -> cpu"
    want_dir, got_dir = (os.path.dirname(f[0]) for f in (want_in, got_in))
    assert [ln for ln in lines if "sa-backend" not in ln] == \
        [ln.replace(want_dir, got_dir) for ln in _mask(p.stderr)]
    for w, g in zip(want_in, got_in):
        want, got = _loaded(w + ".dsmi"), _loaded(g + ".dsmi")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_build_fmi_is_byte_equal(inputs):
    want_in, got_in = inputs("dsm"), inputs("port")
    p = subprocess.run([sys.executable, "-m", "dsm_tpu", "build", "--format",
                        "fmi", "--sa-backend", "numpy", *want_in],
                       env=ENV, cwd=REPO, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr
    assert port_main(["build", "--format", "fmi", "--device", "cpu",
                      *got_in]) == 0
    for w, g in zip(want_in, got_in):
        with open(w + ".fmi", "rb") as f1, open(g + ".fmi", "rb") as f2:
            assert f2.read() == f1.read()


def test_cli_build_numpy_backend_is_dsms(inputs):
    got_in = inputs("port")
    assert port_main(["build", "--sa-backend", "numpy", "-o",
                      got_in[0] + ".np", got_in[0]]) == 0
    assert port_main(["build", "--device", "cpu", got_in[0]]) == 0
    want, got = _loaded(got_in[0] + ".np.dsmi"), _loaded(got_in[0] + ".dsmi")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_build_refuses_jax_backend(inputs):
    with pytest.raises(SystemExit) as e:
        port_main(["build", "--sa-backend", "jax", "--device", "cpu",
                   *inputs("port")])
    assert e.value.code == 1


def test_cli_build_needs_cuda_without_device_cpu(inputs):
    """No fallback: without --device cpu the build wants CUDA, and the
    build path imports no jax."""
    env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}
    fa = inputs("port")[0]
    p = subprocess.run([sys.executable, "-m", "dsm_tpu_torch", "build", fa],
                       env=env, cwd=REPO, capture_output=True, text=True)
    assert p.returncode == 1 and "CUDA is not available" in p.stderr
    assert not glob.glob(fa + ".dsmi")
    code = ("import sys\n"
            "from dsm_tpu_torch.cli.main import main\n"
            f"main(['build', '--device', 'cpu', {fa!r}])\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr
    assert os.path.exists(fa + ".dsmi")
