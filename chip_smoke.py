"""Smoke run of the PyTorch + CUDA port (dsm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. environment: the card, torch/CUDA versions, nvcc, triton;
  2. build: nvcc builds dsm_tpu_torch/csrc into build/kernels;
  3. data (the build path): scale-100 toydata (tests/make_toydata.py,
     GOLDEN_SEED) and its FM-indexes by `indexes_from_fasta` on the card,
     so all 10 suffix arrays (5 samples, 2 directions) go through the SA
     kernels; every build-path kernel must have been launched;
  4. kernels: each CUDA kernel against its plain PyTorch version on the
     card at main-path shapes (equal integers; the f64 entropy within
     ENT_TOL), with both times.  The suffix array of toy0, forward and
     reverse, must also equal dsm_tpu's host `suffix_array_np`; it is
     timed there and at n = 2^24.  The sort's k = 16 round of toy0 is
     checked from the previous round's order and from scratch, its first
     round from scratch; the round's bytes a key and TB/s are printed
     (toy0 and 2^24).  P2-P4 are timed by events and by the profiler's
     device time, P3 also at N = 2^24.  The path decode (K6) walks a
     synthetic history of DEC_LEVELS levels of SEG_NODES nodes, and the
     children step (K3) runs on SEG_NODES nodes of 1..5 pairs with ~30%
     of the lanes kept (all symbols, and one symbol alone);
  5. main path: `mine_torch` ascending and gnu order at fmin=2, emax=1.2
     on the card-built indexes; the counts and the gnu-order sha256 must
     equal the frozen reference (BENCH_BASELINE.json), so they also
     prove the build, and every mining kernel must have been launched;
  6. resume: the gnu-order mine with `checkpoint=` (out_reserve
     RESUME_RESERVE: saves where the frontier is wide) is killed by a
     raise from `save_checkpoint` after its second save and resumed from
     the file; the same frozen reference, and the file must be gone;
  7. halt: the ascending mine with `halt` returning [b"A"] (out_reserve
     HALT_RESERVE: the first poll before the tail); its lines are a
     subset of the warm ascending run's, none under A is deeper than the
     first poll, and the lines outside A are equal;
  8. repro path: `dsm_tpu_torch.tools.pallas_repro`'s cases must PASS,
     each launching its kernel.
Launches are counted per path: set to 0 just before it, read just after
(the mining kernels also for the resume and halt phases).
Then one JSON line of kernels, the card's name and power limit, and the
final line {"ok": true, "device": {...}}.

The script imports torch and the port, never JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

ENT_TOL = 1e-9   # f64 entropy: the same sums, atomics order in the plain
#                  version's index_add_ may differ by a few ulps
FMIN, EMAX = 2, 1.2
SCALE = 100             # the scale of the frozen reference
# main-path shapes of the kernel checks at scale 100
RANK_Q = 1 << 22        # rank queries (two per pair per level)
COMPACT_N = 1 << 23     # candidate rows of a plateau level's children
SEG_NODES = 1_400_000   # nodes of 1..5 pairs (S = 5 samples): ~4.2M pairs
DEC_LEVELS = 48         # levels each decoded row walks (K6)
RESUME_RESERVE = 100    # gnu order: saves at depths 10-12, 33, 59
HALT_RESERVE = 500      # ascending: the first halt poll at depth 10
SA_ROUND_K = 16         # the round of toy0's suffix array timed alone
SA_BIG = 1 << 24        # a synthetic suffix array, beyond scale 100
P3_BIG = 1 << 24        # async_copy where bytes count (128 MB moved)
HBM_TBS = 3.35          # H100 SXM HBM3 peak, TB/s
# the kernels of each path, by the name in the kernels line
LAUNCH_KEY = {"occ_cum8": "rank", "compact_rows": "compact",
              "segstats": "segstats", "decode": "decode",
              "children": "children", "sa_sort": "sa_sort",
              "sa_rank": "sa_rank", "smem_carry": "repro_carry",
              "async_copy": "repro_async", "dynamic_store": "repro_dynstore"}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load_make_toydata():
    """tests/make_toydata.py by path: `tests` is no package, and another
    installed `tests` package may shadow a namespace import."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_toydata", os.path.join(HERE, "tests", "make_toydata.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_env(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "no GPU, nothing to smoke-test")
    smi = smi_line()
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    from dsm_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1] if nvcc else 'no output'}")
    try:
        import triton
        log(f"triton: {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    return smi


def phase_build() -> None:
    from dsm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"build: {path} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc ran: {_build.build_seconds is not None})")


def path_launches(path: str, label: str | None = None) -> dict:
    """The launch counts of `path`'s kernels since the last reset; fails
    if one of them was never launched."""
    from dsm_tpu_torch.ops import _build

    label = label or f"the {path} path"
    launches = {k: _build.LAUNCHES[k] for k in _build.PATHS[path]}
    log(f"launches in {label}: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"kernels never launched by {label}: {missing}")
    return launches


def phase_data(torch, toy, td: str, device):
    """Scale-100 toydata and its indexes, built on the card per sample;
    -> (indexes, toy0's forward and reverse codes, build launches)."""
    from dsm_tpu.index.alphabet import transform
    from dsm_tpu.index.fasta import read_fasta
    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.index.fmindex import collection_codes
    from dsm_tpu_torch.ops import _build

    fastas = toy.make_toydata(td, scale=SCALE, seed=toy.GOLDEN_SEED)
    idxs, secs = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    for path in fastas:
        t0 = time.perf_counter()
        idxs += indexes_from_fasta([path], device)
        secs.append(time.perf_counter() - t0)
    launches = path_launches("build")
    log(f"data: scale {SCALE}, {sum(i.n for i in idxs):,} indexed "
        f"symbols in {len(idxs)} samples, built on the card in "
        f"{sum(secs):.4f} s (per sample: "
        f"{', '.join(f'{t:.4f}' for t in secs)} s)")
    codes, rcodes, _lengths, _max = collection_codes(
        [transform(rec.seq) for rec in read_fasta(fastas[0])])
    return idxs, (codes, rcodes), launches


def device_ms(torch, fn, reps: int = 20):
    """Device time per call of fn: the durations of the device activities
    (kernels, memsets) that torch.profiler records over reps calls, in ms;
    None when the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1000 if us else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def sort_bytes_per_key(n: int, k: int, max_rank: int, derive: bool):
    """-> (bytes a key, passes) of csrc/sa.cu's sort in one round (see its
    header): the digit counts' read, each pass's reads and writes, the
    last pass's gather of rank[i+k] and its packed-key write."""
    from dsm_tpu_torch.ops.sa import RADIX_BITS

    lo = 0 if derive or k >= n else (max_rank + 1).bit_length()
    bits = max_rank.bit_length() + lo
    passes = max(1, -(-bits // RADIX_BITS))
    kv = (4 if bits <= 32 else 8) + 4          # a carried key and value
    counts = 8 if lo else 4                    # rank (and rank[i+k])
    first_in = 8 if derive or lo else 4        # prev + rank, or rank(s)
    middle = 2 * kv * (passes - 1)             # reads and writes between
    last_out = 12 + (4 if lo == 0 and k < n else 0)
    return counts + first_in + middle + last_out, passes


def cuda_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernels(torch, dev, device) -> list[dict]:
    from dsm_tpu_torch.ops.compact import compact_rows, compact_rows_plain
    from dsm_tpu_torch.ops.rank import occ_cum8, occ_cum8_plain
    from dsm_tpu_torch.ops.segstats import Gates, segstats, segstats_plain

    rng = np.random.default_rng(2024)
    results = []

    # rank: ~4M queries on the forward table, positions over [0, n_s]
    q = RANK_Q
    s = rng.integers(0, dev.S, size=q)
    pos = (rng.random(q) * (dev.ns[s] + 1)).astype(np.int64)
    s[:dev.S] = np.arange(dev.S)            # the end of every text
    pos[:dev.S] = dev.ns
    pos_t = torch.as_tensor(pos.astype(np.int32), device=device)
    soff_t = dev.soff[torch.as_tensor(s, device=device)]
    got = occ_cum8(dev.frows, pos_t, soff_t)
    want = occ_cum8_plain(dev.frows, pos_t, soff_t)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise SystemExit(f"rank kernel disagrees with its plain version "
                         f"(max abs err {err})")
    results.append(dict(
        name="occ_cum8", route="cuda", source="dsm_tpu_torch/csrc/rank.cu",
        replaces="dsm_tpu/ops/rank.py:241", max_abs_err=err,
        ms=cuda_ms(torch, lambda: occ_cum8(dev.frows, pos_t, soff_t)),
        plain_ms=cuda_ms(torch,
                         lambda: occ_cum8_plain(dev.frows, pos_t, soff_t))))
    log(f"kernel rank: Q={q} equal; {results[-1]['ms']:.3f} ms vs plain "
        f"{results[-1]['plain_ms']:.3f} ms")

    # compact: N = 2^23 rows, C in (2, 5, 6, 8), masks 0%, ~30%, 100%
    n = COMPACT_N
    times = {}
    for c in (2, 5, 6, 8):
        vals = torch.as_tensor(
            rng.integers(-2**31, 2**31, size=(n, c), dtype=np.int64)
            .astype(np.int32), device=device)
        for frac in (0.0, 0.3, 1.0):
            mask = torch.as_tensor(rng.random(n) < frac, device=device)
            k = int(mask.sum())
            got, gcnt = compact_rows(mask, vals, k)
            want, wcnt = compact_rows_plain(mask, vals, k)
            torch.cuda.synchronize()
            if int(gcnt) != int(wcnt) or not torch.equal(got, want):
                raise SystemExit(f"compact kernel disagrees with its plain "
                                 f"version at C={c} frac={frac}")
            if frac == 0.3:
                times[c] = (
                    cuda_ms(torch, lambda: compact_rows(mask, vals, k)),
                    cuda_ms(torch, lambda: compact_rows_plain(mask, vals, k)))
    for c, (km, pm) in times.items():
        log(f"kernel compact: N={n} C={c} 30% set: {km:.3f} ms vs plain "
            f"{pm:.3f} ms")
    results.append(dict(
        name="compact_rows", route="cuda",
        source="dsm_tpu_torch/csrc/compact.cu",
        replaces="dsm_tpu/ops/pallas_compact.py:162", max_abs_err=0,
        ms=times[6][0], plain_ms=times[6][1]))

    # segstats: ~4M pairs in nodes of 1..5 pairs (S = 5 samples)
    sizes = rng.integers(1, 6, size=SEG_NODES)
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    p = int(nb[-1])
    freq = rng.integers(0, 3000, size=p)
    freq[rng.random(p) < 0.1] = 0
    cact = (rng.integers(0, 16, size=p) * (freq > 0)).astype(np.uint8)
    nb_t = torch.as_tensor(nb, device=device)
    f_t = torch.as_tensor(freq.astype(np.int32), device=device)
    c_t = torch.as_tensor(cact, device=device)
    g = Gates(depth=7, s_total=5, mindepth=0, pmin=2, pmax=0,
              use_egate=True, sym_mask=0b1111, emin_lo=-0.01, emax_hi=1.21)
    fk, ek, pk = segstats(nb_t, f_t, c_t, g)
    fp, ep, pp = segstats_plain(nb_t, f_t, c_t, g)
    torch.cuda.synchronize()
    eerr = float((ek - ep).abs().max())
    if not (torch.equal(fk, fp) and torch.equal(pk, pp)) or eerr > ENT_TOL:
        raise SystemExit(f"segstats kernel disagrees with its plain version "
                         f"(entropy max abs err {eerr})")
    results.append(dict(
        name="segstats", route="cuda", source="dsm_tpu_torch/csrc/segstats.cu",
        replaces="dsm_tpu/mining/engine_device.py:726", max_abs_err=eerr,
        ms=cuda_ms(torch, lambda: segstats(nb_t, f_t, c_t, g)),
        plain_ms=cuda_ms(torch, lambda: segstats_plain(nb_t, f_t, c_t, g))))
    log(f"kernel segstats: U={len(sizes)} P={p} equal (entropy err "
        f"{eerr:.3g}); {results[-1]['ms']:.3f} ms vs plain "
        f"{results[-1]['plain_ms']:.3f} ms")
    return results + phase_level_kernels(torch, device)


def phase_level_kernels(torch, device) -> list[dict]:
    """K6 (decode) and K3 (children) against their plain versions on
    SEG_NODES-wide synthetic levels, made on the card from a seed."""
    from dsm_tpu_torch.ops.children import children, children_plain
    from dsm_tpu_torch.ops.decode import decode, decode_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(2027)
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    w = SEG_NODES

    # decode: DEC_LEVELS levels of w nodes, each with a parent in the
    # level before; w rows at the top walk all of them
    hist = (torch.randint(0, w, (DEC_LEVELS * w,), **i32) * 4
            + torch.randint(0, 4, (DEC_LEVELS * w,), **i32))
    lvl_off = torch.arange(0, DEC_LEVELS * w, w, dtype=torch.int32,
                           device=device)
    rows = torch.randint(0, w, (w,), **i32)
    jrel = torch.full((w,), DEC_LEVELS, dtype=torch.int32, device=device)
    args = (hist, lvl_off, rows, jrel, DEC_LEVELS)
    (kb, ks), (pb, ps) = decode(*args), decode_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kb, pb) and torch.equal(ks, ps)):
        raise SystemExit("decode kernel disagrees with its plain version")
    results = [dict(
        name="decode", route="cuda", source="dsm_tpu_torch/csrc/decode.cu",
        replaces="dsm_tpu/mining/engine_device.py:990", max_abs_err=0,
        ms=cuda_ms(torch, lambda: decode(*args)),
        plain_ms=cuda_ms(torch, lambda: decode_plain(*args)))]
    log(f"kernel decode: m={w:,} rows x {DEC_LEVELS} levels equal; events "
        f"{results[-1]['ms']:.4f} ms vs plain {results[-1]['plain_ms']:.4f}"
        f" ms; device {fmt_ms(device_ms(torch, lambda: decode(*args)))} vs "
        f"plain {fmt_ms(device_ms(torch, lambda: decode_plain(*args)))}")
    del hist, args, kb, ks, pb, ps

    # children: w nodes of 1..5 pairs, rank outputs with ohi >= olo, ~30%
    # of the lanes kept under the full symbol mask and under G alone
    sizes = torch.randint(1, 6, (w,), **i32)
    nb = torch.zeros(w + 1, dtype=torch.int32, device=device)
    nb[1:] = torch.cumsum(sizes, 0)
    p = int(nb[-1])
    pairs = torch.randint(-2**31, 2**31 - 1, (p, 6), **i32)
    pairs[:, 5] = torch.repeat_interleave(
        torch.arange(w, dtype=torch.int32, device=device),
        sizes.to(torch.int64))
    olo = torch.randint(-2**31, 2**31 - 5000, (8, p), **i32)
    ohi = olo + torch.randint(0, 5000, (8, p), **i32)
    kept = torch.rand((4, p), generator=gen, device=device) < 0.3
    lane = pairs[:, 5].to(torch.int64) * 4 + torch.arange(
        4, device=device)[:, None]
    for label, mask in (("all symbols", kept),
                        ("G alone", kept & (torch.arange(
                            4, device=device)[:, None] == 2))):
        pair_count = int(mask.sum())
        child_total = int(torch.unique(lane[mask]).numel())
        hk = torch.full((child_total,), -1, dtype=torch.int32, device=device)
        hp = hk.clone()
        cargs = (nb, pairs, olo, ohi, mask, pair_count, child_total)
        (kr, kn), (pr_, pn) = children(*cargs, hk), children_plain(*cargs, hp)
        torch.cuda.synchronize()
        if not (torch.equal(kr, pr_) and torch.equal(kn, pn)
                and torch.equal(hk, hp)):
            raise SystemExit(f"children kernel disagrees with its plain "
                             f"version ({label})")
        ms = cuda_ms(torch, lambda: children(*cargs, hk))
        plain_ms = cuda_ms(torch, lambda: children_plain(*cargs, hp))
        log(f"kernel children: U={w:,} P={p:,} {label}: {pair_count:,} "
            f"lanes kept, {child_total:,} children, equal; {ms:.4f} ms vs "
            f"plain {plain_ms:.4f} ms")
        if label == "all symbols":
            results.append(dict(
                name="children", route="cuda",
                source="dsm_tpu_torch/csrc/children.cu",
                replaces="dsm_tpu/mining/engine_device.py:789",
                max_abs_err=0, ms=ms, plain_ms=plain_ms))
    return results


def phase_sa_kernels(torch, toy0, device) -> list[dict]:
    """The suffix-array kernels on toy0's collections (both directions)
    and at SA_BIG; toy0's first round checked, and its round k = 16 of
    each kernel timed alone (the sort's also at SA_BIG)."""
    from dsm_tpu.ops.sa import suffix_array_np
    from dsm_tpu_torch.ops.sa import (rank_round, rank_round_plain,
                                      sort_round, sort_round_plain,
                                      suffix_array, suffix_array_plain)

    for label, codes in zip(("forward", "reverse"), toy0):
        c = torch.as_tensor(codes, device=device)
        got = suffix_array(c)
        want = suffix_array_plain(c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"SA kernel disagrees with its plain version "
                             f"on toy0 {label}")
        t0 = time.perf_counter()
        host = suffix_array_np(codes)
        host_s = time.perf_counter() - t0
        if not np.array_equal(got.cpu().numpy(), host):
            raise SystemExit(f"SA kernel disagrees with suffix_array_np on "
                             f"toy0 {label}")
        log(f"kernel suffix_array: toy0 {label} n={len(codes):,} equals "
            f"plain and suffix_array_np; "
            f"{cuda_ms(torch, lambda: suffix_array(c), 5):.3f} ms vs plain "
            f"{cuda_ms(torch, lambda: suffix_array_plain(c), 5):.3f} ms "
            f"(suffix_array_np on the host {host_s:.3f} s)")

    # toy0's first round, and its round k = 16 with the rank update
    c = torch.as_tensor(toy0[0], device=device)
    first, top0 = c.to(torch.int32), int(c.max())
    if not all(torch.equal(g, w) for g, w in zip(
            sort_round(first, 1, top0), sort_round_plain(first, 1, top0))):
        raise SystemExit("sa_sort disagrees with its plain version in "
                         "toy0's first round")
    log(f"kernel sa_sort: toy0 forward first round (k=1, from scratch, "
        f"codes < {top0 + 1}) equal")
    rank, k, top, (keys, order), ms, plain_ms = sa_round(torch, c,
                                                         "toy0 forward")
    r1, r2 = rank.clone(), rank.clone()
    new1, new2 = rank_round(keys, order, r1), rank_round_plain(keys, order,
                                                               r2)
    torch.cuda.synchronize()
    if new1 != new2 or not torch.equal(r1, r2):
        raise SystemExit("sa_rank disagrees with its plain version")
    results = [
        dict(name="sa_sort", route="cuda", source="dsm_tpu_torch/csrc/sa.cu",
             replaces="dsm_tpu/ops/sa.py:109", max_abs_err=0, ms=ms,
             plain_ms=plain_ms),
        dict(name="sa_rank", route="cuda", source="dsm_tpu_torch/csrc/sa.cu",
             replaces="dsm_tpu/ops/sa.py:110", max_abs_err=0,
             ms=cuda_ms(torch, lambda: rank_round(keys, order, r1)),
             plain_ms=cuda_ms(torch,
                              lambda: rank_round_plain(keys, order, r2)))]
    log(f"kernel sa_rank: toy0 forward n={len(toy0[0]):,} round k={k} "
        f"equal; {results[1]['ms']:.3f} ms vs plain "
        f"{results[1]['plain_ms']:.3f} ms")

    rng = np.random.default_rng(2025)
    big = torch.as_tensor(rng.integers(1, 5, size=SA_BIG).astype(np.int8),
                          device=device)
    if not torch.equal(suffix_array(big), suffix_array_plain(big)):
        raise SystemExit(f"SA kernel disagrees with its plain version at "
                         f"n={SA_BIG}")
    log(f"kernel suffix_array: random n={SA_BIG:,} equal; "
        f"{cuda_ms(torch, lambda: suffix_array(big), 3):.3f} ms vs plain "
        f"{cuda_ms(torch, lambda: suffix_array_plain(big), 3):.3f} ms")
    sa_round(torch, big, "random")
    return results


def sa_round(torch, codes, label: str):
    """Round k = SA_ROUND_K of the prefix doubling of `codes` (the rounds
    before it by the plain versions): the kernel's sort from the previous
    round's order and from scratch, each against the plain sort, timed;
    -> (rank, k, max rank, the plain (keys, order), ms, plain ms)."""
    from dsm_tpu_torch.ops.sa import (rank_round_plain, sort_round,
                                      sort_round_plain)

    rank = codes.to(torch.int32)
    top, k, prev = int(codes.max()), 1, None
    while k < SA_ROUND_K:
        keys, prev = sort_round_plain(rank, k, top)
        top = rank_round_plain(keys, prev, rank)
        k *= 2
    want = sort_round_plain(rank, k, top)
    for how, given in (("from the previous order", prev),
                       ("from scratch", None)):
        got = sort_round(rank, k, top, given)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"sa_sort disagrees with its plain version: "
                             f"{label} round k={k} {how}")
    ms = cuda_ms(torch, lambda: sort_round(rank, k, top, prev))
    scratch_ms = cuda_ms(torch, lambda: sort_round(rank, k, top))
    plain_ms = cuda_ms(torch, lambda: sort_round_plain(rank, k, top))
    n, bits = rank.shape[0], top.bit_length()
    per_key, passes = sort_bytes_per_key(n, k, top, True)
    tbs = per_key * n / (ms * 1e-3) / 1e12
    log(f"kernel sa_sort: {label} n={n:,} round k={k} (ranks < {top + 1:,}"
        f": {bits} bits, {passes} passes) equal from the "
        f"previous order and from scratch; {ms:.4f} ms (from scratch "
        f"{scratch_ms:.4f} ms) vs plain {plain_ms:.4f} ms; {per_key} B a "
        f"key, {tbs:.3f} TB/s = {100 * tbs / HBM_TBS:.1f}% of {HBM_TBS} TB/s")
    return rank, k, top, want, ms, plain_ms


def phase_repro_kernels(torch, device) -> list[dict]:
    """P2-P4 against their plain versions and the repro tool's expected
    arrays, timed by events and by the profiler's device time; P3 also
    at N = P3_BIG."""
    from dsm_tpu_torch.ops import repro
    from dsm_tpu_torch.tools.pallas_repro import N, expected

    want = expected(device)
    x = torch.arange(N, dtype=torch.int32, device=device)
    results = []
    for name, line, fn, plain in (
            ("smem_carry", 81, repro.smem_carry, repro.smem_carry_plain),
            ("async_copy", 101, repro.async_copy, repro.async_copy_plain),
            ("dynamic_store", 123, repro.dynamic_store,
             repro.dynamic_store_plain)):
        got = fn(x)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain(x)) and torch.equal(got, want[name])):
            raise SystemExit(f"{name} kernel disagrees with its plain version "
                             f"or the expected array")
        results.append(dict(
            name=name, route="cuda", source="dsm_tpu_torch/csrc/repro.cu",
            replaces=f"tools/pallas_repro.py:{line}", max_abs_err=0,
            ms=cuda_ms(torch, lambda: fn(x)),
            plain_ms=cuda_ms(torch, lambda: plain(x))))
        log(f"kernel {name}: N={N} equal; events {results[-1]['ms']:.4f} ms "
            f"vs plain {results[-1]['plain_ms']:.4f} ms; device "
            f"{fmt_ms(device_ms(torch, lambda: fn(x)))} vs plain "
            f"{fmt_ms(device_ms(torch, lambda: plain(x)))}")

    rng = np.random.default_rng(2026)
    xb = torch.as_tensor(rng.integers(-2**30, 2**30, size=P3_BIG,
                                      dtype=np.int64).astype(np.int32),
                         device=device)
    if not torch.equal(repro.async_copy(xb), repro.async_copy_plain(xb)):
        raise SystemExit(f"async_copy disagrees with its plain version at "
                         f"N={P3_BIG}")
    ms = cuda_ms(torch, lambda: repro.async_copy(xb))
    dev = device_ms(torch, lambda: repro.async_copy(xb))
    moved = 2 * 4 * P3_BIG
    log(f"kernel async_copy: N={P3_BIG:,} equal; events {ms:.4f} ms "
        f"({moved / (ms * 1e-3) / 1e12:.3f} TB/s) vs plain "
        f"{cuda_ms(torch, lambda: repro.async_copy_plain(xb)):.4f} ms; "
        f"device {fmt_ms(dev)} vs plain "
        f"{fmt_ms(device_ms(torch, lambda: repro.async_copy_plain(xb)))}")
    return results


def phase_repro(torch, device) -> dict:
    """The repro tool's cases, through its entry point's function."""
    from dsm_tpu_torch.ops import _build
    from dsm_tpu_torch.tools.pallas_repro import run_cases

    torch.cuda.synchronize()
    _build.reset_launches()
    report = run_cases(device)
    launches = path_launches("repro")
    log(f"repro tool: {json.dumps(report)}")
    if set(report.values()) != {"PASS"}:
        raise SystemExit("repro tool: a case did not pass")
    return launches


def phase_main(torch, idxs, dev, device) -> dict:
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)

    def run(label: str, order: str):
        prof = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mine_torch(idxs, cfg, dev=dev, device=device,
                         reader_order=order, profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"mine {label}: {out.total_paths} paths, {out.total_output} "
            f"lines in {wall:.4f} s = {out.total_paths / wall:,.0f} paths/s;"
            " host phases " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in prof.items()}))
        return out

    torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    # the first run pays one-time costs (the host indexes' lazy dense
    # tables, first use of each torch op on the card); the second is warm
    cold = run("ascending (first in process)", "ascending")
    out = run("ascending (warm)", "ascending")
    gnu = run("gnu", "gnu")
    torch.cuda.synchronize()
    launches = path_launches("mine")
    peak = torch.cuda.max_memory_allocated(device)
    log(f"peak device memory (max_memory_allocated): {peak:,} bytes")

    if cold.format_lines() != out.format_lines():
        raise SystemExit("two ascending runs on the card disagree")
    if gnu.total_output != out.total_output \
            or gnu.total_paths != out.total_paths:
        raise SystemExit("gnu and ascending runs report different counts")
    check_reference(gnu, "scale-100 parity")
    return launches, out


def check_reference(gnu, label: str) -> None:
    """A gnu-order scale-100 output against the frozen reference."""
    with open(os.path.join(HERE, "BENCH_BASELINE.json")) as f:
        ref = json.load(f)["reference"]
    sha = hashlib.sha256(gnu.format_lines()).hexdigest()
    log(f"{label}: gnu-order sha256 {sha}")
    want = (ref["total_paths"], 485, ref["lines_sha256"])
    if (gnu.total_paths, gnu.total_output, sha) != want:
        raise SystemExit(
            f"{label} FAILED: got paths={gnu.total_paths} "
            f"lines={gnu.total_output} sha={sha}, want {want}")
    log(f"{label}: paths, lines and gnu sha256 equal the frozen reference")


class Killed(Exception):
    """Raised from save_checkpoint to abort a mining run."""


def phase_resume(torch, idxs, dev, device, td: str) -> None:
    """The gnu-order mine with a snapshot file, killed after its second
    save and resumed from it in this process."""
    from dsm_tpu_torch.mining import checkpoint as ckpt
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build

    cfg = MiningConfig(fmin=FMIN, emax=EMAX)
    path = os.path.join(td, "mine.ckpt")
    save = ckpt.save_checkpoint
    saves = []     # (depth, frontier nodes, write seconds, file bytes)

    def killing(p, state, *a, **k):
        t0 = time.perf_counter()
        save(p, state, *a, **k)
        saves.append((int(state["depth"]), int(state["nvalid"]),
                      round(time.perf_counter() - t0, 4),
                      os.path.getsize(p)))
        if killed is None and len(saves) == 2:
            raise Killed()

    ckpt.save_checkpoint = killing
    killed = None
    torch.cuda.synchronize()
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        try:
            mine_torch(idxs, cfg, dev=dev, device=device, reader_order="gnu",
                       out_reserve=RESUME_RESERVE, checkpoint=path)
        except Killed:
            killed = time.perf_counter() - t0
        if killed is None or not os.path.exists(path):
            raise SystemExit("resume: the run was not killed at its second "
                             "save, or left no snapshot")
        prof = {}
        t0 = time.perf_counter()
        gnu = mine_torch(idxs, cfg, dev=dev, device=device,
                         reader_order="gnu", out_reserve=RESUME_RESERVE,
                         checkpoint=path, profile=prof)
        torch.cuda.synchronize()
        resumed = time.perf_counter() - t0
    finally:
        ckpt.save_checkpoint = save
    path_launches("mine", "the resume phase")
    log(f"resume: killed after save 2 at {killed:.4f} s, resumed run "
        f"{resumed:.4f} s; {len(saves)} saves (depth, frontier nodes, "
        f"write s, bytes): {json.dumps([list(s) for s in saves])}; the "
        f"resumed run's {prof['saves']} saves took {prof['save_s']:.4f} s "
        f"in all (frontier decode and write)")
    if len(saves) < 3 or min(s[1] for s in saves) < 100_000:
        raise SystemExit("resume: fewer than three saves at wide frontiers")
    if os.path.exists(path):
        raise SystemExit("resume: the snapshot file outlived the run")
    check_reference(gnu, "resume parity")


def phase_halt(torch, idxs, dev, device, warm) -> None:
    """The ascending mine halted under A at its first poll, against the
    warm ascending run `warm`."""
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch
    from dsm_tpu_torch.ops import _build

    polls = []

    def halt(depth, out):
        polls.append(depth)
        return [b"A"]

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = mine_torch(idxs, MiningConfig(fmin=FMIN, emax=EMAX), dev=dev,
                     device=device, out_reserve=HALT_RESERVE, halt=halt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_launches("mine", "the halt phase")
    lines = got.format_lines().splitlines()
    want = warm.format_lines().splitlines()
    first = polls[0] if polls else None
    log(f"halt: polls at depths {polls}; {len(lines)} of {len(want)} lines "
        f"in {wall:.4f} s")
    outside = [ln for ln in want if not ln.startswith(b"A")]
    if (first is None or not set(lines) <= set(want)
            or any(ln.startswith(b"A") and len(ln.split(b" ", 1)[0]) > first
                   for ln in lines)
            or [ln for ln in lines if not ln.startswith(b"A")] != outside):
        raise SystemExit("halt: the halted output is not the warm run's "
                         "pruned below A at the first poll")
    if len(lines) == len(want):
        raise SystemExit("halt: nothing was pruned")
    log("halt: a subset of the warm run, nothing under A deeper than the "
        "first poll, the lines outside A equal")


def main() -> int:
    import torch

    smi = phase_env(torch)
    from dsm_tpu_torch.mining.engine import DeviceIndexes
    toy = load_make_toydata()

    phase_build()
    device = torch.device("cuda", 0)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="dsm_smoke_") as td:
        idxs, toy0, launches["build"] = phase_data(torch, toy, td, device)
        dev = DeviceIndexes.build(idxs, device)
        kernels = (phase_kernels(torch, dev, device)
                   + phase_sa_kernels(torch, toy0, device)
                   + phase_repro_kernels(torch, device))
        launches["mine"], warm = phase_main(torch, idxs, dev, device)
        phase_resume(torch, idxs, dev, device, td)
        phase_halt(torch, idxs, dev, device, warm)
    launches["repro"] = phase_repro(torch, device)
    counts = {k: v for path in launches.values() for k, v in path.items()}
    for k in kernels:
        k["launches"] = counts[LAUNCH_KEY[k["name"]]]
    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
