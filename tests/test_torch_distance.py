"""The port's distance stage (dsm_tpu_torch/post/distance.py, `python -m
dsm_tpu_torch distance`) against dsm_tpu's, on the CPU.

The same NumPy-seeded rows go through both packages.  On the CPU
`pairwise_matrices_torch` takes the kernel's plain PyTorch version (f64,
direct differences): count equal and the f64 sums within rtol = atol =
1e-9 of dsm_tpu's NumPy `pairwise_matrices` (another summation order, and
torch's lgamma against scipy's), and, on the golden rows, within the JAX
test's own rtol = atol = 2e-4 of `pairwise_matrices_jax` (f32 products).  The accumulator and the
CLI are held against dsm_tpu's on the golden mined rows: exact mode byte
for byte, `--fast` to 1e-5 a printed value.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsm_tpu.post import distance as jd
from dsm_tpu_torch.cli.main import main as port_main
from dsm_tpu_torch.ops.distance import pairwise_matrices_plain
from dsm_tpu_torch.post import distance as pd

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
KINDS = ("count", "log", "sqrt", "lgamma")


def golden_rows(config: str) -> str:
    chunks = []
    for prefix in "ACGT":
        with gzip.open(os.path.join(
                GOLDEN, f"server-output.{config}.{prefix}.txt.gz")) as f:
            chunks.append(f.read())
    return b"".join(chunks).decode()


def seeded_rows(rows: int, d: int, nbins: int, seed: int):
    rng = np.random.default_rng(seed)
    F = (np.minimum(rng.pareto(1.1, size=(rows, d)) * 4 + 1, 1e5)
         * (rng.random((rows, d)) < 0.3)).astype(np.int64)
    bins = rng.integers(0, nbins, size=rows)
    bins[bins == 1] = 0           # a bin no row falls in
    return F, bins


@pytest.mark.parametrize("rows,d,nbins", [(300, 5, 21), (257, 33, 4),
                                          (40, 70, 2), (0, 6, 3)])
def test_pairwise_matrices_torch_matches_numpy(rows, d, nbins):
    F, bins = seeded_rows(rows, d, nbins, seed=rows + d)
    want = jd.pairwise_matrices(F, nbins, bins)
    for Fin in (F, torch.as_tensor(F.astype(np.int32))):
        got = pd.pairwise_matrices_torch(Fin, nbins, bins, device="cpu")
        assert got["count"].dtype == torch.int64
        assert np.array_equal(got["count"].numpy(), want["count"])
        for kind in KINDS[1:]:
            assert got[kind].dtype == torch.float64
            np.testing.assert_allclose(got[kind].numpy(), want[kind],
                                       rtol=1e-9, atol=1e-9, err_msg=kind)


def test_pairwise_matrices_torch_normalised_leaves_lgamma_zero():
    F, bins = seeded_rows(200, 9, 3, seed=5)
    nf = 1.0 / np.random.default_rng(6).uniform(500, 4000, size=9)
    want = jd.pairwise_matrices(F, 3, bins, nf)
    got = pd.pairwise_matrices_torch(F, 3, bins, nf, device="cpu")
    assert np.array_equal(got["count"].numpy(), want["count"])
    for kind in ("log", "sqrt"):
        np.testing.assert_allclose(got[kind].numpy(), want[kind],
                                   rtol=1e-9, atol=1e-9)
    assert not got["lgamma"].any()


def test_pairwise_matrices_torch_matches_jax():
    """The golden rows of the JAX package's own test of its device form,
    at that test's plain rtol = atol = 2e-4."""
    rows = golden_rows("default").splitlines()
    F = np.stack([jd.parse_row(r, 5) for r in rows])
    ent = np.array([jd.row_entropy(f, 5) for f in F])
    bins = np.where(ent <= 0.5, 1, 0)
    want = jd.pairwise_matrices_jax(F, 2, bins)
    got = pd.pairwise_matrices_torch(F, 2, bins, device="cpu")
    assert np.array_equal(got["count"].numpy(), np.asarray(want["count"]))
    for kind in KINDS[1:]:
        np.testing.assert_allclose(got[kind].numpy(), np.asarray(want[kind]),
                                   rtol=2e-4, atol=2e-4, err_msg=kind)


def split_matrices(F: np.ndarray, nbins: int, bins: np.ndarray,
                   nfactor: np.ndarray | None = None) -> dict:
    """The four matrices as K11's kernel forms them, in NumPy: per bin,
    the cross sums of log1p f and sqrt f as Gram products of the bin's
    rows, log = Q_j + Q_k - 2 G with Q the Gram's diagonal, count as the
    product of the nonzero masks (the kernel's popcount), and the lgamma
    matrix from the column sums C (of f) and N (of f > 0) and one sum over
    the rows where both entries are nonzero."""
    from scipy.special import gammaln

    R, d = F.shape
    P = (F > 0).astype(np.float64)
    f = F.astype(np.float64) * (1.0 if nfactor is None else nfactor)
    upper_ge = np.triu(np.ones((d, d), dtype=bool))
    upper_gt = np.triu(np.ones((d, d), dtype=bool), k=1)
    out = {"count": np.zeros((nbins, d, d), dtype=np.int64),
           **{k: np.zeros((nbins, d, d)) for k in KINDS[1:]}}
    for b in range(nbins):
        Pb, fb = P[bins == b], f[bins == b]
        count = Pb.T @ Pb
        out["count"][b] = np.rint(count).astype(np.int64) * upper_ge
        for kind, a in (("log", np.log1p(fb)), ("sqrt", np.sqrt(fb))):
            G = a.T @ a
            Q = np.diag(G)
            out[kind][b] = (Q[:, None] + Q[None, :] - 2 * G) * upper_gt
        if nfactor is not None:
            continue
        C, N, lf = fb.sum(axis=0), Pb.sum(axis=0), gammaln(fb + 1.0)
        both = (Pb[:, :, None] * Pb[:, None, :]) > 0
        s = fb[:, :, None] + fb[:, None, :]
        terms = np.where(both, gammaln(s + 1.0) - lf[:, :, None]
                         - lf[:, None, :], 0.0).sum(axis=0)
        out["lgamma"][b] = (terms - (C[:, None] + C[None, :])
                            - (N[:, None] + N[None, :] - count)) * upper_gt
    return out


def split_case(name: str):
    """(F, nbins, bins, nfactor, a duplicated column pair or None)."""
    rows, d, nbins = {"d5": (300, 5, 21), "d64": (400, 64, 4),
                      "d273": (60, 273, 3), "normalised": (200, 9, 3),
                      "duplicated": (250, 12, 3), "past_table": (120, 7, 2),
                      "empty_bin": (150, 6, 5), "one_row_bin": (90, 8, 4)
                      }[name]
    F, bins = seeded_rows(rows, d, nbins, seed=rows * d)
    rng = np.random.default_rng(d)
    nf, dup = None, None
    if name == "normalised":
        nf = 1.0 / rng.uniform(500, 4000, size=d)
    if name == "duplicated":
        dup = (3, 7)
        F[:, 7] = F[:, 3]
    if name == "past_table":           # pair sums past 2,048, the kernel's
        F[5] = rng.integers(1500, 5000, size=d)   # table of lgamma(n + 1)
        F[6, :3] = 40_000
    if name == "empty_bin":
        bins[bins == 2] = 3
    if name == "one_row_bin":
        bins[bins == 2] = 0
        bins[17] = 2
    return F, nbins, bins, nf, dup


@pytest.mark.parametrize("name", ["d5", "d64", "d273", "normalised",
                                  "duplicated", "past_table", "empty_bin",
                                  "one_row_bin"])
def test_pairwise_split_matches_plain_and_numpy(name):
    """The algebra of K11's kernel, checked before any card time: the split
    into Gram products, column sums and the both-nonzero lgamma sum gives
    the direct differences of `pairwise_matrices_plain` and dsm_tpu's NumPy
    `pairwise_matrices` within 1e-9 * (1 + |want|), count exact."""
    F, nbins, bins, nf, dup = split_case(name)
    got = split_matrices(F, nbins, bins, nf)
    plain = pairwise_matrices_plain(
        torch.as_tensor(F), nbins, torch.as_tensor(bins),
        None if nf is None else torch.as_tensor(nf))
    numpy_ = jd.pairwise_matrices(F, nbins, bins, nf)
    if nf is not None:
        numpy_["lgamma"] = np.zeros_like(numpy_["lgamma"])
    for want in ({k: v.numpy() for k, v in plain.items()}, numpy_):
        assert np.array_equal(got["count"], want["count"])
        for kind in KINDS[1:]:
            g, w = got[kind], want[kind]
            assert (np.abs(g - w) <= 1e-9 * (1 + np.abs(w))).all(), kind
    if dup is not None:
        j, k = dup
        for kind in ("log", "sqrt"):
            assert np.abs(got[kind][:, j, k]).max() <= 1e-9, kind
            assert not plain[kind][:, j, k].any(), kind
    if name == "past_table":
        assert (F[:, :, None] + F[:, None, :]).max() > 2048
    if name == "empty_bin":
        assert not (bins == 2).any() and not got["count"][2].any()
    if name == "one_row_bin":
        assert (bins == 2).sum() == 1 and got["count"][2].any()


def test_pairwise_matrices_plain_is_the_cpu_path(monkeypatch):
    """On CPU tensors the wrapper takes the plain version and never the
    kernel's launcher."""
    from dsm_tpu_torch.ops import _build, distance

    def no_launch(*a, **k):
        raise AssertionError("launched on a CPU tensor")

    monkeypatch.setattr(_build, "launch", no_launch)
    F, bins = seeded_rows(50, 4, 2, seed=1)
    got = distance.pairwise_matrices(torch.as_tensor(F), 2,
                                     torch.as_tensor(bins))
    want = pairwise_matrices_plain(torch.as_tensor(F), 2,
                                   torch.as_tensor(bins))
    assert all(torch.equal(got[k], want[k]) for k in KINDS)


def test_pairwise_matrices_torch_needs_cuda_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    F, bins = seeded_rows(10, 4, 2, seed=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pd.pairwise_matrices_torch(F, 2, bins, device="cuda")


ACC_CASES = {
    "wide": dict(config="wide", maxents=[0.3, 0.6, 1.0]),
    "minfreq": dict(config="wide", maxents=[1.0], minfreq=4),
    "entstep": dict(config="specific", maxents=jd.entropy_steps(0.25)),
    "runtosmpl": dict(config="default", maxents=[0.5, 1.0],
                      runtosmpl=np.array([0, 1, 1, 2, 0])),
    "sizes": dict(config="wide", maxents=[0.5, 1.0],
                  sizes=np.array([1000.0, 2000.0, 1500.0, 800.0, 3000.0])),
}


def _accumulate(mod, case: dict, **extra):
    kw = {k: v for k, v in case.items() if k != "config"}
    smpls = 5
    if "runtosmpl" in kw:
        smpls = int(kw["runtosmpl"].max()) + 1
    acc = mod.DistanceAccumulator(smpls=smpls, runs=5, **kw, **extra)
    acc.add_lines(golden_rows(case["config"]).splitlines())
    return acc


@pytest.mark.parametrize("name", sorted(ACC_CASES))
def test_accumulator_exact_equals_dsm(name):
    got = _accumulate(pd, ACC_CASES[name]).matrices()
    want = _accumulate(jd, ACC_CASES[name]).matrices()
    for key in KINDS + ("thresholds", "noutput"):
        assert np.array_equal(got[key], want[key]), key
    if name == "sizes":
        assert not got["lgamma"].any()


@pytest.mark.parametrize("name", sorted(ACC_CASES))
def test_accumulator_fast_on_cpu_matches_dsm_exact(name):
    acc = _accumulate(pd, ACC_CASES[name], exact=False, device="cpu",
                      chunk_rows=64)
    got = acc.matrices()
    want = _accumulate(jd, ACC_CASES[name]).matrices()
    assert np.array_equal(got["count"], want["count"])
    assert np.array_equal(got["noutput"], want["noutput"])
    for kind in KINDS[1:]:
        np.testing.assert_allclose(got[kind], want[kind], rtol=1e-9,
                                   atol=1e-9, err_msg=kind)


def test_accumulator_fast_needs_a_device():
    with pytest.raises(ValueError, match="needs a device"):
        pd.DistanceAccumulator(smpls=5, maxents=[1.0], exact=False)


@pytest.mark.parametrize("step", [0.05, 0.25, 0.3, 1.0])
def test_entropy_steps_equal(step):
    assert pd.entropy_steps(step) == jd.entropy_steps(step)


def test_row_helpers_equal():
    for line in golden_rows("default").splitlines():
        a, b = pd.parse_row(line, 5), jd.parse_row(line, 5)
        assert np.array_equal(a, b)
        assert pd.row_entropy(a, 5) == jd.row_entropy(b, 5)


def _read(outdir, suffix: str) -> dict:
    out = {}
    for kind in KINDS:
        with open(os.path.join(outdir, f"{kind}.{suffix}"), "rb") as f:
            out[kind] = f.read()
    return out


CLI_CASES = {
    "entstep": ["-s", "5", "-e", "0.05"],
    "maxent_minfreq": ["-s", "5", "-m", "0.3,0.6,1.0", "-M", "4"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_cli_distance_matches_dsm(tmp_path, monkeypatch, name, fast):
    """`python -m dsm_tpu_torch distance --device cpu` against `dsm
    distance`: byte for byte in exact mode, 1e-5 a value with --fast."""
    rows = golden_rows("wide")
    args = CLI_CASES[name] + ["-F", "out"]
    want_dir, got_dir = tmp_path / "dsm", tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    p = subprocess.run([sys.executable, "-m", "dsm_tpu", "distance", *args,
                        "--outdir", str(want_dir)], input=rows.encode(),
                       env=ENV, cwd=REPO, capture_output=True)
    assert p.returncode == 0, p.stderr.decode()
    import io

    monkeypatch.setattr(sys, "stdin", io.StringIO(rows))
    assert port_main(["distance", *args, "--outdir", str(got_dir),
                      "--device", "cpu", *(["--fast"] if fast else [])]) == 0
    want, got = _read(want_dir, "out"), _read(got_dir, "out")
    if not fast:
        assert got == want
        return
    assert got["count"] == want["count"]
    for kind in KINDS[1:]:
        for lw, lg in zip(want[kind].decode().splitlines(),
                          got[kind].decode().splitlines(), strict=True):
            if lw.startswith("Matrix"):
                assert lg == lw
            else:
                assert all(abs(float(a) - float(b)) <= 1e-5 for a, b in
                           zip(lw.split(), lg.split(), strict=True)), kind


def test_cli_distance_samplefile_and_normalize(tmp_path, monkeypatch):
    import io

    rows = golden_rows("default")
    sfile, nfile = tmp_path / "samples.txt", tmp_path / "sizes.txt"
    sfile.write_text("0\n1\n1\n2\n0\n")
    nfile.write_text("".join(f"s{i}\t{v}\n" for i, v in
                             enumerate((1000.0, 2000.0, 1500.0))))
    outs = {}
    for label, mod_main in (("dsm", None), ("port", port_main)):
        d = tmp_path / label
        d.mkdir()
        args = ["distance", "-S", str(sfile), "-m", "0.5,1.0", "-N",
                str(nfile), "-F", "o", "--outdir", str(d)]
        if mod_main is None:
            p = subprocess.run([sys.executable, "-m", "dsm_tpu", *args],
                               input=rows.encode(), env=ENV, cwd=REPO,
                               capture_output=True)
            assert p.returncode == 0, p.stderr.decode()
        else:
            monkeypatch.setattr(sys, "stdin", io.StringIO(rows))
            assert mod_main(args + ["--device", "cpu"]) == 0
        outs[label] = _read(d, "o")
    assert outs["port"] == outs["dsm"]


def test_cli_distance_wants_cuda_only_with_fast(tmp_path):
    """Without --device cpu, --fast wants CUDA and exits 1 where there is
    none; the exact host path runs whatever --device says; the distance
    path imports no jax and nothing of dsm_tpu."""
    env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}
    rows = golden_rows("default").encode()
    base = [sys.executable, "-m", "dsm_tpu_torch", "distance", "-s", "5",
            "-m", "1.0", "--outdir", str(tmp_path)]
    p = subprocess.run(base + ["-F", "fast", "--fast"], input=rows, env=env,
                       cwd=REPO, capture_output=True, text=False)
    assert p.returncode == 1 and b"CUDA is not available" in p.stderr
    assert not os.path.exists(tmp_path / "count.fast")
    code = ("import sys\n"
            "from dsm_tpu_torch.cli.main import main\n"
            f"main(['distance', '-s', '5', '-m', '1.0', '-F', 'exact', "
            f"'--outdir', {str(tmp_path)!r}])\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.split('.')[0] == 'dsm_tpu']\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], input=rows, env=env,
                       cwd=REPO, capture_output=True)
    assert p.returncode == 0, p.stderr.decode()
    assert os.path.exists(tmp_path / "count.exact")


def test_cli_distance_argument_errors():
    for argv in (["distance", "-F", "x", "-m", "1.0"],
                 ["distance", "-F", "x", "-s", "5"],
                 ["distance", "-F", "x", "-s", "5", "-m", "1", "-e", "0.1"]):
        with pytest.raises(SystemExit) as e:
            port_main(argv + ["--device", "cpu"])
        assert e.value.code == 1
