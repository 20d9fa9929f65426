"""The port's CUDA kernels and its mining slice on the card.

Every test here needs a GPU (marker `cuda`) and skips without one.  The
file imports no JAX, so it runs where JAX is not installed:

    DSM_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(DSM_TEST_TPU=1 keeps tests/conftest.py from importing jax.)  Each kernel
is held against its plain PyTorch version on the same CUDA tensors, at
edge shapes; the suffix array also against the host numpy one; the
mining run (plain, killed and resumed from its snapshot, and halted) and
the index build on the card against the port's CPU path.
Exact, except the f64 entropy of segstats: absolute 1e-9 (the plain
version sums with index_add_, whose order on the card may differ), and
the f64 sums of the pairwise distance matrices: 1e-9 * (1 + |value|) (the
kernel's row slices meet in atomics, in an order of their own).
"""

import glob
import os

import numpy as np
import pytest
import torch

from dsm_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
TOYDATA = os.path.join(HERE, "data", "toydata")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def toy_indexes(cuda):
    from dsm_tpu_torch.index import indexes_from_fasta

    return indexes_from_fasta(sorted(glob.glob(os.path.join(
        TOYDATA, "toy*.fasta.gz"))), cuda)


def test_rank_kernel(cuda, toy_indexes):
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    from dsm_tpu_torch.ops.rank import occ_cum8, occ_cum8_plain

    dev = DeviceIndexes.build(toy_indexes, cuda)
    rng = np.random.default_rng(1)
    sid = rng.integers(0, dev.S, size=100_003)
    pos = (rng.random(sid.size) * (dev.ns[sid] + 1)).astype(np.int32)
    pos[:dev.S], sid[:dev.S] = dev.ns, np.arange(dev.S)
    pr = torch.zeros((sid.size, 6), dtype=torch.int32, device=cuda)
    pr[:, 0] = torch.as_tensor(pos, device=cuda)
    pr[:, 4] = dev.soff[torch.as_tensor(sid, device=cuda)]
    before = _build.LAUNCHES["rank"]
    got = occ_cum8(dev.frows, pr[:, 0], pr[:, 4])       # strided columns
    assert _build.LAUNCHES["rank"] == before + 1
    want = occ_cum8_plain(dev.frows, pr[:, 0], pr[:, 4])
    assert torch.equal(got, want)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert occ_cum8(dev.frows, empty, empty).shape == (8, 0)


@pytest.mark.parametrize("n,c", [(1, 1), (1023, 5), (1025, 6), (300_001, 8)])
def test_compact_kernel(cuda, n, c):
    from dsm_tpu_torch.ops.compact import compact_rows, compact_rows_plain

    rng = np.random.default_rng(n)
    vals = torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, c),
                                        dtype=np.int64).astype(np.int32),
                           device=cuda)
    for frac in (0.0, 0.3, 1.0):
        mask = torch.as_tensor(rng.random(n) < frac, device=cuda)
        k = int(mask.sum())
        for width in (k, k // 2, n):
            got, gc = compact_rows(mask, vals, width)
            want, wc = compact_rows_plain(mask, vals, width)
            assert int(gc) == int(wc) == k
            assert torch.equal(got, want), (frac, width)


def test_segstats_kernel(cuda):
    from dsm_tpu_torch.ops.segstats import Gates, segstats, segstats_plain

    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 6, size=50_000)
    nb = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)])
                         .astype(np.int32), device=cuda)
    p = int(sizes.sum())
    freq = rng.integers(0, 500, size=p).astype(np.int32)
    freq[rng.random(p) < 0.2] = 0
    cact = (rng.integers(0, 16, size=p) * (freq > 0)).astype(np.uint8)
    f_t = torch.as_tensor(freq, device=cuda)
    c_t = torch.as_tensor(cact, device=cuda)
    for depth, sym in ((0, 15), (5, 15), (9, 4)):
        g = Gates(depth=depth, s_total=5, mindepth=2, pmin=2, pmax=4,
                  use_egate=True, sym_mask=sym, emin_lo=0.1, emax_hi=1.5)
        fk, ek, pk = segstats(nb, f_t, c_t, g)
        fp, ep, pp = segstats_plain(nb, f_t, c_t, g)
        assert torch.equal(fk, fp) and torch.equal(pk, pp)
        assert float((ek - ep).abs().max()) < 1e-9


def _history(rng, widths):
    """Random parent pointers, level k >= 1 holding widths[k] nodes ->
    (hist, lvl_off) int32 numpy."""
    parts, offs, off = [], [], 0
    for k in range(1, len(widths)):
        parent = rng.integers(0, widths[k - 1], size=widths[k])
        parts.append((parent * 4 + rng.integers(0, 4, size=widths[k]))
                     .astype(np.int32))
        offs.append(off)
        off += widths[k]
    return (np.concatenate(parts) if parts else np.zeros(1, np.int32),
            np.asarray(offs, dtype=np.int32))


@pytest.mark.parametrize("case", ["m=0", "one_row", "jrel=0", "mixed",
                                  "deep"])
def test_decode_kernel(cuda, case):
    from dsm_tpu_torch.ops.decode import decode, decode_plain

    widths = {"m=0": [3, 5, 7], "one_row": [2, 9, 4], "jrel=0": [40, 8],
              "mixed": [5] + [3000] * 12, "deep": [7] + [200] * 90}[case]
    m = {"m=0": 0, "one_row": 1, "jrel=0": 500, "mixed": 100_003,
         "deep": 4097}[case]
    rng = np.random.default_rng(len(widths) + m)
    hist, offs = _history(rng, widths)
    top = len(widths) - 1
    jrel = (np.zeros(m, dtype=np.int32) if case == "jrel=0"
            else rng.integers(0, top + 1, size=m).astype(np.int32))
    if case == "one_row":
        jrel[:] = top
    rows = np.array([rng.integers(0, widths[j]) for j in jrel],
                    dtype=np.int32)
    maxj = top if case == "m=0" else int(jrel.max())
    args = [torch.as_tensor(a, device=cuda) for a in (hist, offs, rows, jrel)]
    before = _build.LAUNCHES["decode"]
    base, syms = decode(*args, maxj)
    assert _build.LAUNCHES["decode"] == before + (m > 0)
    pbase, psyms = decode_plain(*args, maxj)
    torch.cuda.synchronize()
    assert base.shape == (m,) and syms.shape == (m, maxj)
    assert torch.equal(base, pbase) and torch.equal(syms, psyms)


def _children_layout(rng, sizes, frac, sym_mask):
    U = len(sizes)
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(nb[-1])
    node = np.repeat(np.arange(U), sizes)
    pairs = rng.integers(-2**31, 2**31, size=(P, 6)).astype(np.int32)
    pairs[:, 5] = node
    olo = rng.integers(-2**31, 2**31 - 5000, size=(8, P))
    ohi = olo + rng.integers(0, 5000, size=(8, P))
    keep = rng.random((4, P)) < frac
    keep &= (((sym_mask >> np.arange(4)) & 1) > 0)[:, None]
    return nb, pairs, olo.astype(np.int32), ohi.astype(np.int32), keep


@pytest.mark.parametrize("case", ["U=1", "node_512", "nothing_kept",
                                  "all_kept", "restricted", "no_pairs",
                                  "wide"])
def test_children_kernel(cuda, case):
    from dsm_tpu_torch.ops.children import children, children_plain

    rng = np.random.default_rng(len(case))
    sizes = {"U=1": [3], "node_512": [2, 512, 1, 5], "no_pairs": [0, 0],
             "wide": rng.integers(1, 6, size=300_001)}.get(
                 case, rng.integers(1, 6, size=5000))
    frac = {"nothing_kept": 0.0, "all_kept": 1.0}.get(case, 0.3)
    sym_mask = 0b0010 if case == "restricted" else 0b1111
    layout = _children_layout(rng, np.asarray(sizes), frac, sym_mask)
    nb, pairs, olo, ohi, keep = (torch.as_tensor(a, device=cuda)
                                 for a in layout)
    pair_count = int(keep.sum())
    node = pairs[:, 5].to(torch.int64)
    c = torch.arange(4, device=cuda)[:, None]
    child_total = int(torch.unique((node * 4 + c)[keep]).numel())
    got_hist = torch.full((child_total + 5,), -7, dtype=torch.int32,
                          device=cuda)
    want_hist = got_hist.clone()
    before = _build.LAUNCHES["children"]
    got = children(nb, pairs, olo, ohi, keep, pair_count, child_total,
                   got_hist)
    assert _build.LAUNCHES["children"] == before + 1
    want = children_plain(nb, pairs, olo, ohi, keep, pair_count,
                          child_total, want_hist)
    torch.cuda.synchronize()
    assert got[0].shape == (pair_count, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got_hist, want_hist)


def test_checkpoint_resume_on_card_equals_cpu(cuda, toy_indexes, tmp_path,
                                              monkeypatch):
    """Killed after its second snapshot and resumed, on the card; the
    snapshot history pull included (small DSM_HIST_CAP)."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    monkeypatch.setenv("DSM_HIST_CAP", "20000")
    kw = dict(out_reserve=0, tail_width=0)
    ck = str(tmp_path / "card.ckpt")
    save = ckpt.save_checkpoint
    saves = []

    def killing(*a, **k):
        save(*a, **k)
        saves.append(1)
        if len(saves) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt, "save_checkpoint", killing)
    with pytest.raises(KeyboardInterrupt):
        mine_torch(toy_indexes, cfg, device=cuda, checkpoint=ck, **kw)
    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    _build.reset_launches()
    got = mine_torch(toy_indexes, cfg, device=cuda, checkpoint=ck, **kw)
    assert _build.LAUNCHES["decode"] > 0 and _build.LAUNCHES["children"] > 0
    assert not os.path.exists(ck)
    want = mine_torch(toy_indexes, cfg, device="cpu", **kw)
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)


def test_halt_on_card_equals_cpu(cuda, toy_indexes):
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    runs = []
    for device in (cuda, "cpu"):
        depths = []
        out = mine_torch(toy_indexes, cfg, device=device, out_reserve=1,
                         halt=lambda d, o: depths.append(d) or [b"A", b"GT"])
        runs.append((out.format_lines(), out.total_paths, depths))
    assert runs[0] == runs[1] and runs[0][2]


@pytest.mark.parametrize("exits", ["default", "drain+histfull"])
def test_mine_on_card_equals_cpu(cuda, toy_indexes, exits, monkeypatch):
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch

    cfg = MiningConfig(fmin=2, emax=1.2)
    kw = {}
    if exits == "drain+histfull":
        kw["out_reserve"] = 0
        monkeypatch.setenv("DSM_HIST_CAP", "20000")
    _build.reset_launches()
    got = mine_torch(toy_indexes, cfg, device=cuda, **kw)
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["mine"])
    want = mine_torch(toy_indexes, cfg, device="cpu", **kw)
    assert got.format_lines() == want.format_lines()
    assert (got.total_paths, got.total_output, got.total_occs) == \
        (want.total_paths, want.total_output, want.total_occs)
    assert abs(got.smallest_entropy - want.smallest_entropy) < 1e-9


def _sa_codes(case):
    from dsm_tpu_torch.index.alphabet import transform
    from dsm_tpu_torch.index.fasta import read_fasta
    from dsm_tpu_torch.index.fmindex import collection_codes
    from dsm_tpu_torch.ops.sa import RANK_BLOCK, SORT_TILE

    rng = np.random.default_rng(11)
    sizes = {"n=2": 2, "tile": SORT_TILE,
             "tile-1": 3 * SORT_TILE - 1, "tile+1": 3 * SORT_TILE + 1,
             "many_tiles": 1 << 22,    # more tiles than SMs: look-back
             "rank_block-1": 5 * RANK_BLOCK - 1,
             "rank_block+1": 5 * RANK_BLOCK + 1}
    if case in sizes:
        return rng.integers(0, 6, size=sizes[case]).astype(np.int8)
    if case.startswith("rank_bits="):  # the first round's ranks: exactly b bits
        b = int(case.split("=")[1])
        codes = rng.integers(0, 1 << b, size=30_000).astype(np.int32)
        codes[17] = (1 << b) - 1
        return codes
    if case == "all_equal":
        return np.full(20_000, 2, dtype=np.int8)
    if case == "wide_key":     # 17 + 17 bits from the second round on
        return rng.integers(1, 5, size=100_000).astype(np.int8)
    if case == "wide_codes":   # 30 + 31 bits in the first round
        return rng.integers(0, 1 << 30, size=50_000).astype(np.int64)
    name, direction = case.split(":")
    texts = [transform(r.seq) for r in read_fasta(
        os.path.join(TOYDATA, name + ".fasta.gz"))]
    codes, rcodes, _lengths, _max = collection_codes(texts)
    return codes if direction == "fwd" else rcodes


@pytest.mark.parametrize("case", [
    "n=2", "tile", "tile-1", "tile+1", "many_tiles", "rank_block-1",
    "rank_block+1", "all_equal", "wide_key", "wide_codes", "rank_bits=8",
    "rank_bits=16", "rank_bits=24"] + [f"toy{i}:{d}" for i in range(5)
                                       for d in ("fwd", "rev")])
def test_sa_kernel(cuda, case):
    from dsm_tpu_torch.ops.sa import (suffix_array, suffix_array_np,
                                      suffix_array_plain)

    codes = _sa_codes(case)
    codes_t = torch.as_tensor(codes, device=cuda)
    before = _build.LAUNCHES["sa_sort"]
    got = suffix_array(codes_t)
    assert _build.LAUNCHES["sa_sort"] > before
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device == codes_t.device
    assert torch.equal(got, suffix_array_plain(codes_t))
    np.testing.assert_array_equal(got.cpu().numpy(), suffix_array_np(codes))


@pytest.mark.parametrize("top", [39_999, (1 << 8) - 1, (1 << 16) - 1,
                                 (1 << 24) - 1])
def test_sa_round_kernels(cuda, top):
    """One round's sort and rank update against their plain versions: the
    same keys, the same stable order, the same new ranks; each k sorted
    from scratch and from a previous order (the stable order by rank)."""
    from dsm_tpu_torch.ops.sa import (SORT_TILE, rank_round, rank_round_plain,
                                      sort_round, sort_round_plain)

    rng = np.random.default_rng(5)
    n = 300_001
    rank = torch.as_tensor(rng.integers(0, top + 1, size=n).astype(np.int32),
                           device=cuda)
    rank[7] = top
    prev = torch.sort(rank, stable=True).indices.to(torch.int32)
    for k in (1, 4, SORT_TILE + 3, n - 1, n, n + 1):
        pkeys, porder = sort_round_plain(rank, k, top)
        for given in (None, prev):
            keys, order = sort_round(rank, k, top, given)
            assert torch.equal(keys, pkeys) and torch.equal(order, porder), \
                (k, given is None)
        r1, r2 = rank.clone(), rank.clone()
        assert rank_round(keys, order, r1) == \
            rank_round_plain(pkeys, porder, r2)
        assert torch.equal(r1, r2)


@pytest.mark.parametrize("extra", [[], ["--buffer-symbols", "20000"]])
def test_build_on_card_equals_cpu(cuda, tmp_path, extra):
    from dsm_tpu_torch.cli.main import main

    fa = os.path.join(TOYDATA, "toy1.fasta.gz")
    _build.reset_launches()
    assert main(["build", *extra, "-o", str(tmp_path / "gpu"), fa]) == 0
    assert all(_build.LAUNCHES[k] > 0 for k in _build.PATHS["build"])
    assert main(["build", *extra, "--device", "cpu", "-o",
                 str(tmp_path / "cpu"), fa]) == 0
    with np.load(tmp_path / "gpu.dsmi") as g, \
            np.load(tmp_path / "cpu.dsmi") as c:
        assert sorted(g.files) == sorted(c.files)
        for k in c.files:
            np.testing.assert_array_equal(g[k], c[k], err_msg=k)


@pytest.mark.parametrize("n", [256, 1024, 4096, (1 << 20) + 256])
def test_repro_kernels(cuda, n):
    from dsm_tpu_torch.ops import repro

    x = torch.as_tensor(np.random.default_rng(n).integers(
        -2**20, 2**20, size=n).astype(np.int32), device=cuda)
    x[0] = 3     # dynamic_store's offset is x[0] * 0
    for fn, plain, key in (
            (repro.smem_carry, repro.smem_carry_plain, "repro_carry"),
            (repro.async_copy, repro.async_copy_plain, "repro_async"),
            (repro.dynamic_store, repro.dynamic_store_plain,
             "repro_dynstore")):
        before = _build.LAUNCHES[key]
        got = fn(x)
        assert _build.LAUNCHES[key] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, plain(x)), key


def test_repro_tool_on_card(cuda):
    from dsm_tpu_torch.tools.pallas_repro import run_cases

    assert set(run_cases(cuda).values()) == {"PASS"}


@pytest.mark.parametrize("rows,d,nbins,scaled", [
    (5000, 5, 21, False),          # one pair tile, most of it idle
    (4097, 64, 21, False),         # rows not a multiple of the staged 32
    (700, 273, 30, False),         # ragged last tile, more bins
    (31, 17, 1, False),            # fewer rows than one staging step
    (3000, 40, 4, True),           # normalising factors: lgamma left zero
    (0, 8, 3, False),
    (9000, 12, 1000, False),       # more bins than rows in a sort block
], ids=["d5", "d64", "d273", "tiny", "normalised", "no_rows", "many_bins"])
def test_pairwise_matrices_kernel_matches_plain(cuda, rows, d, nbins, scaled):
    """K11 against its plain version on the card and NumPy's on the host;
    bins 1 and nbins-1 hold no row; one row's frequencies are past the
    kernel's lgamma table; F as int32 and as int64."""
    from dsm_tpu_torch.ops.distance import (pairwise_matrices,
                                            pairwise_matrices_plain)
    from dsm_tpu_torch.post.distance import pairwise_matrices as oracle

    rng = np.random.default_rng(rows + d)
    F_np = (np.minimum(rng.pareto(1.1, size=(rows, d)) * 4 + 1, 2e6)
            * (rng.random((rows, d)) < 0.3)).astype(np.int64)
    if rows:
        F_np[rows // 2] = rng.integers(1500, 5000, size=d)
    bins_np = rng.integers(0, nbins, size=rows)
    bins_np[(bins_np == 1) | (bins_np == nbins - 1)] = 0
    nf_np = 1.0 / rng.uniform(500, 4000, size=d) if scaled else None
    nf = None if nf_np is None else torch.as_tensor(nf_np, device=cuda)
    bins = torch.as_tensor(bins_np, device=cuda)
    want_np = oracle(F_np, nbins, bins_np, nf_np)
    if scaled:
        want_np["lgamma"][:] = 0.0
    before = _build.LAUNCHES["distance"]
    for dtype in (torch.int32, torch.int64):
        F = torch.as_tensor(F_np, device=cuda).to(dtype)
        got = pairwise_matrices(F, nbins, bins, nf)
        want = pairwise_matrices_plain(F, nbins, bins, nf)
        torch.cuda.synchronize()
        assert torch.equal(got["count"], want["count"])
        assert np.array_equal(got["count"].cpu().numpy(), want_np["count"])
        for kind in ("log", "sqrt", "lgamma"):
            g = got[kind].cpu().numpy()
            for w in (want[kind].cpu().numpy(), want_np[kind]):
                assert (np.abs(g - w) <= 1e-9 * (1 + np.abs(w))).all(), kind
    launched = _build.LAUNCHES["distance"] - before
    assert launched == (2 if rows else 0)


def test_pairwise_matrices_rejects_what_the_kernel_does_not_take(cuda):
    from dsm_tpu_torch.ops.distance import pairwise_matrices

    F = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    bins = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pairwise_matrices(F.to(torch.float32), 2, bins)
    with pytest.raises(ValueError):
        pairwise_matrices(F.T, 2, bins[:3])
    with pytest.raises(ValueError):
        pairwise_matrices(F, 2, bins.cpu())
    with pytest.raises(ValueError):
        pairwise_matrices(F, 2, bins, torch.ones(3, device=cuda))


def test_distance_accumulator_on_the_card(cuda, toy_indexes):
    """Mined toydata lines through the accumulator: exact on the host
    against exact=False through the kernel."""
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.mining.engine import mine_torch
    from dsm_tpu_torch.post.distance import (DistanceAccumulator,
                                             entropy_steps)

    out = mine_torch(toy_indexes, MiningConfig(fmin=2, emax=1.2), device=cuda)
    lines = out.format_lines().decode().splitlines()
    assert lines
    kw = dict(smpls=5, maxents=entropy_steps(0.05))
    exact = DistanceAccumulator(**kw)
    fast = DistanceAccumulator(exact=False, device=cuda, chunk_rows=7, **kw)
    exact.add_lines(lines)
    before = _build.LAUNCHES["distance"]
    fast.add_lines(lines)
    got, want = fast.matrices(), exact.matrices()
    assert _build.LAUNCHES["distance"] - before == -(-len(lines) // 7)
    assert np.array_equal(got["count"], want["count"])
    assert np.array_equal(got["noutput"], want["noutput"])
    for kind in ("log", "sqrt", "lgamma"):
        np.testing.assert_allclose(got[kind], want[kind], rtol=1e-9,
                                   atol=1e-9)
