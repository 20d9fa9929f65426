"""Many-sample data, and references for chip_smoke.py's sample-axis phase
(`D64`, `D273`, `D512`) frozen with dsm_tpu on the host CPU.

    python tests/freeze_samples_reference.py OUTDIR --samples D --symbols N
        [--seed S] [--maxdepth M] (--emax E | --explore) [--jobs J]

`make_samples(outdir, d, symbols, seed)` writes d FASTA files shaped as a
metagenome collection (see its docstring), about `symbols` indexed symbols
in all (a read of n bases indexes 2n + 2 of them: forward, '-', reverse
complement, end).  The script makes that data in OUTDIR/data, builds each
sample's FMIndex with dsm_tpu (`FMIndex.from_texts`, the numpy suffix
sort) in a pool of `--jobs` processes, and mines the whole trie with
dsm_tpu's `mine_device` on the JAX CPU backend (fmin 2, pmin 2, `--emax`,
`--maxdepth` if given), ascending and gnu, a process an order; tests/
test_engine_tpu.py holds that engine equal to `mine_np`, whose dense (nodes
x samples) tables do not fit this size at d = 273.  Each run writes
OUTDIR/out/ORDER.txt (its lines) and .json (its counters, sha256, wall
seconds and peak resident memory); a run whose .json exists is skipped.
Then it prints the reference dict: `make` (make_samples' arguments: the
samples, the symbols asked for, the seed), the indexed symbols, emax and
maxdepth, the paths, lines and occurrences, the entropy range (float32 on
dsm_tpu's device levels), the sha256 of the frequency histogram
(`hist_sha256`) and both orders' sha256.

`--explore` mines ascending with the port on the CPU instead (faster; it
is not the reference, and nothing is frozen), with `--emax` as a ceiling
that keeps the drains small, and prints the entropy of the 1,000th lowest
line and the emax to freeze with: that entropy rounded up to 0.01, the
smallest emax that leaves 1,000 lines, or 1.2 where that leaves more.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ORDERS = ("ascending", "gnu")
READ_LEN = 80
CORE_LEN = 600          # the species every sample carries: a marker region
REPEAT_LEN = 120        # a high-copy repeat element
REPEAT_SHARE = 0.15    # of the symbols, in the planted repeats
FMIN, PMIN = 2, 2


def _genome(rng, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=n)]


def _mutate(rng, g: np.ndarray, rate: float) -> np.ndarray:
    g = g.copy()
    k = rng.binomial(len(g), rate)
    pos = rng.choice(len(g), size=k, replace=False)
    g[pos] = BASES[rng.integers(0, 4, size=k)]
    return g


def _reads(rng, genome: np.ndarray, n: int) -> list[np.ndarray]:
    starts = rng.integers(0, len(genome) - READ_LEN + 1, size=n)
    return [genome[s:s + READ_LEN] for s in starts]


def make_samples(outdir: str, d: int, symbols: int, seed: int) -> list[str]:
    """d FASTA files sample0000.fasta.. with about `symbols` indexed
    symbols in all, shaped as a metagenome collection:

      * sample sizes log-uniform over 0.5-2x their mean;
      * a core species (CORE_LEN bases, no variation) in every sample at
        30% of its reads, so that real levels hold nodes of d pairs deep
        into the reads;
      * accessory species (about one a 4 samples, each of 1.5x a mean
        sample's bases), each carried by 2..d/4 samples at uneven
        (Dirichlet) abundance, with 1% per-sample mutations: 55% of reads;
      * sample-private sequence: 15% of reads;
      * high-copy repeat elements (REPEAT_LEN bases, one a 8 samples),
        each planted into a group of 2-3 samples at 0.4-1.6x a mean number
        of copies a sample, so that they hold REPEAT_SHARE of the symbols;
        each copy with 1% mutations and a start jitter of up to 8, so the
        mined output holds low-entropy lines;
      * lowercase letters (one read in 17) and `N`s (one read in 23), as in
        tests/make_toydata.py.
    """
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(0.5), np.log(2.0), size=d))
    sizes /= sizes.mean()
    per_read = 2 * READ_LEN + 2
    # the repeats take REPEAT_SHARE of the symbols, the reads the rest
    nreads = np.maximum((sizes * (1 - REPEAT_SHARE) * symbols / d
                         / per_read).astype(np.int64), 8)
    mean_reads = float(nreads.mean())
    core = _genome(rng, CORE_LEN)
    nacc = max(2, d // 4)
    acc = [_genome(rng, max(int(1.5 * mean_reads * READ_LEN), 4 * READ_LEN))
           for _ in range(nacc)]
    carriers = [set(rng.choice(d, size=int(rng.integers(2, max(3, d // 4 + 1))),
                               replace=False).tolist()) for _ in range(nacc)]
    nrep = max(2, d // 8)
    copies = REPEAT_SHARE * symbols / (nrep * 2.5 * (2 * REPEAT_LEN + 2))
    repeats = []
    for _ in range(nrep):
        group = rng.choice(d, size=int(rng.integers(2, 4)), replace=False)
        repeats.append((_genome(rng, REPEAT_LEN), {
            int(s): int(rng.integers(max(2, int(0.4 * copies)),
                                     max(3, int(1.6 * copies))))
            for s in group}))
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for s in range(d):
        n = int(nreads[s])
        pool = [a for a in range(nacc) if s in carriers[a]]
        reads = [(r, "core") for r in _reads(rng, core, int(0.30 * n))]
        if pool:
            w = rng.dirichlet(np.full(len(pool), 0.8))
            counts = rng.multinomial(int(0.55 * n), w)
            for a, c in zip(pool, counts):
                local = _mutate(rng, acc[a], 0.01)
                reads += [(r, f"species={a}") for r in _reads(rng, local, c)]
        private = _genome(rng, max(4 * READ_LEN, int(0.15 * n) * READ_LEN // 3))
        reads += [(r, "private") for r in _reads(rng, private, int(0.15 * n))]
        for rid, (elem, group) in enumerate(repeats):
            for _ in range(group.get(s, 0)):
                off = int(rng.integers(0, 8))
                reads.append((_mutate(rng, elem, 0.01)[off:], f"repeat={rid}"))
        lines = []
        for i, (read, tag) in enumerate(reads):
            read = read.copy()
            if i % 17 == 0:
                read[: len(read) // 4] += 32   # lowercase
            if i % 23 == 0:
                read[len(read) // 2] = ord("N")
            lines.append(f">read_{s}_{i} {tag}".encode())
            seq = read.tobytes()
            lines.extend(seq[j:j + 70] for j in range(0, len(seq), 70))
        path = os.path.join(outdir, f"sample{s:04d}.fasta")
        with open(path, "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
        paths.append(path)
    return paths


def _fastas(data: str) -> list[str]:
    return sorted(os.path.join(data, f) for f in os.listdir(data)
                  if f.endswith(".fasta"))


def _config(cls, emax: float, maxdepth: int | None):
    """fmin FMIN, pmin PMIN, `emax`, and `maxdepth` where one is given, as
    either package's MiningConfig `cls`."""
    kw = {} if maxdepth is None else dict(maxdepth=maxdepth)
    return cls(fmin=FMIN, pmin=PMIN, emax=emax, **kw)


def build(path: str) -> int:
    """One sample's FMIndex, saved beside its FASTA as .dtfmi; -> n."""
    from dsm_tpu.index.alphabet import transform
    from dsm_tpu.index.fasta import read_fasta
    from dsm_tpu.index.fmindex import FMIndex

    idx = FMIndex.from_texts([transform(r.seq) for r in read_fasta(path)],
                             names=[os.path.basename(path)],
                             sa_backend="numpy")
    idx.rtable   # the reverse table, built once here
    idx.save(path + ".dtfmi")
    return idx.n


def mine(data: str, out: str, order: str, emax: float,
         maxdepth: int | None) -> dict:
    """One whole-trie run of dsm_tpu's mine_device on the JAX CPU backend
    -> its record (also written to OUT/ORDER.json, the lines to .txt)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from dsm_tpu.index.fmindex import FMIndex
    from dsm_tpu.mining.config import MiningConfig
    from dsm_tpu.mining.engine_device import mine_device

    idxs = [FMIndex.load(f + ".dtfmi") for f in _fastas(data)]
    t0 = time.perf_counter()
    res = mine_device(idxs, _config(MiningConfig, emax, maxdepth),
                      reader_order=order)
    wall = time.perf_counter() - t0
    blob = res.format_lines()
    with open(os.path.join(out, f"{order}.txt"), "wb") as f:
        f.write(blob)
    hist = res.freq_histogram
    rec = dict(order=order, total_paths=res.total_paths,
               total_output=res.total_output, total_occs=res.total_occs,
               smallest_entropy=res.smallest_entropy,
               largest_entropy=res.largest_entropy,
               hist={int(k) + 1: int(hist[k]) for k in np.flatnonzero(hist)},
               sha256=hashlib.sha256(blob).hexdigest(), wall_s=wall,
               peak_rss_gb=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 1e6)
    with open(os.path.join(out, f"{order}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def explore(data: str, emax: float, maxdepth: int | None) -> dict:
    """The port's ascending mine on the CPU, `emax` a ceiling -> the
    lines and the entropy of the 1,000th lowest."""
    import torch

    from dsm_tpu_torch.index import indexes_from_fasta
    from dsm_tpu_torch.mining.engine import MiningConfig, mine_torch

    torch.set_num_threads(4)
    res = mine_torch(indexes_from_fasta(_fastas(data), "cpu"),
                     _config(MiningConfig, emax, maxdepth), device="cpu")
    ents = sorted(e for _p, e, _o in res.lines)
    k = ents[min(999, len(ents) - 1)]
    return dict(paths=res.total_paths, lines=res.total_output,
                entropy_1000th=k, emax=max(1.2, float(np.ceil(k * 100) / 100)))


def hist_sha256(hist: dict, d: int) -> str:
    """The sha256 of a frequency histogram ({samples: lines}, its nonzero
    entries) as d little-endian int64 words, entry k for k + 1 samples."""
    words = np.zeros(d, dtype="<i8")
    for k, v in hist.items():
        words[int(k) - 1] = v
    return hashlib.sha256(words.tobytes()).hexdigest()


def reference(a, data: str, recs: dict) -> dict:
    """The frozen dict of chip_smoke.py (D64, D273, D512)."""
    from dsm_tpu.index.fmindex import FMIndex

    asc, gnu = recs["ascending"], recs["gnu"]
    keys = ("total_paths", "total_output", "total_occs", "hist")
    if [asc[k] for k in keys] != [gnu[k] for k in keys]:
        raise SystemExit("the two orders' counts differ")
    return dict(make=(a.samples, a.symbols, a.seed), symbols=sum(
        FMIndex.load(f + ".dtfmi").n for f in _fastas(data)),
        emax=a.emax, maxdepth=a.maxdepth, paths=gnu["total_paths"],
        lines=gnu["total_output"], occs=gnu["total_occs"],
        entropy=(gnu["smallest_entropy"], gnu["largest_entropy"]),
        hist=hist_sha256(gnu["hist"], a.samples), gnu=gnu["sha256"],
        ascending=asc["sha256"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--samples", type=int, required=True)
    ap.add_argument("--symbols", type=int, required=True)
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--emax", type=float, default=1.2)
    ap.add_argument("--explore", action="store_true",
                    help="mine ascending with the port, --emax a ceiling, "
                         "and print the emax that leaves 1,000 lines")
    ap.add_argument("--jobs", type=int, default=4)
    a = ap.parse_args()
    data, out = os.path.join(a.outdir, "data"), os.path.join(a.outdir, "out")
    t0 = time.perf_counter()
    if not os.path.isdir(data) or not _fastas(data):
        make_samples(data, a.samples, a.symbols, a.seed)
    print(f"data in {time.perf_counter() - t0:.1f} s", flush=True)
    if a.explore:
        print(json.dumps(explore(data, a.emax, a.maxdepth)))
        return
    os.makedirs(out, exist_ok=True)
    todo = [f for f in _fastas(data) if not os.path.exists(f + ".dtfmi")]
    runs = [o for o in ORDERS
            if not os.path.exists(os.path.join(out, f"{o}.json"))]
    with ProcessPoolExecutor(max_workers=a.jobs) as ex:
        n = sum(ex.map(build, todo, chunksize=8))
        print(f"built {len(todo)} indexes ({n:,} symbols) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        futs = [ex.submit(mine, data, out, o, a.emax, a.maxdepth)
                for o in runs]
        for f in futs:
            r = f.result()
            print(f"mined {r['order']}: {r['total_paths']:,} paths, "
                  f"{r['total_output']:,} lines in {r['wall_s']:.1f} s, "
                  f"peak {r['peak_rss_gb']:.2f} GB", flush=True)
    print(f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    recs = {}
    for o in ORDERS:
        with open(os.path.join(out, f"{o}.json")) as f:
            recs[o] = json.load(f)
    print(json.dumps(reference(a, data, recs)))


if __name__ == "__main__":
    main()
