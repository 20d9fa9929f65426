"""Freeze a reference for chip_smoke.py's scale-1000 phase (`S1000`) with
dsm_tpu on the host: no accelerator and no JAX device code is used.

    python tests/freeze_scale_reference.py OUTDIR [--scale 1000] [--jobs 4]
    python tests/freeze_scale_reference.py OUTDIR --merge

The first form makes tests/make_toydata.py's data at the scale with
GOLDEN_SEED in OUTDIR/data, builds each sample's FMIndex
(`FMIndex.from_texts`, the numpy suffix sort) in a process of its own, and
mines each enforced prefix A, C, G, T in ascending and in gnu reader order
with `dsm_tpu.mining.engine_np.mine_np` (fmin 2, emax 1.2), a process a
(prefix, order), `--jobs` at a time (a scale-1000 mine holds ~8 GB of host
memory).  Each run writes OUTDIR/out/P.ORDER.txt (its lines) and .json (its
counters, sha256 and wall seconds); a run whose .json exists is skipped.
Then, as `--merge` alone does, it prints the `S1000` dict: per prefix the
paths, lines and both orders' sha256; for the whole trie the summed paths,
lines and occurrences, the entropy range, and the sha256 of the four
prefixes' bytes concatenated in each order, which is what a whole-trie run
prints (its sorted post-order is the concatenation:
tests/test_scale_parity.py).
"""

import argparse
import hashlib
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

PREFIXES = "ACGT"
ORDERS = ("ascending", "gnu")


def _fastas(data: str) -> list[str]:
    return sorted(os.path.join(data, f) for f in os.listdir(data)
                  if f.endswith(".fasta"))


def build(path: str) -> tuple[str, int, float]:
    """One sample's FMIndex, saved beside its FASTA as .dtfmi."""
    from dsm_tpu.index.alphabet import transform
    from dsm_tpu.index.fasta import read_fasta
    from dsm_tpu.index.fmindex import FMIndex

    t0 = time.perf_counter()
    idx = FMIndex.from_texts([transform(r.seq) for r in read_fasta(path)],
                             names=[os.path.basename(path)],
                             sa_backend="numpy")
    idx.rtable   # the reverse table, built once here
    idx.save(path + ".dtfmi")
    return path, idx.n, time.perf_counter() - t0


def mine(data: str, out: str, prefix: str, order: str) -> dict:
    """One enforced-prefix run of mine_np -> its record."""
    from dsm_tpu.index.fmindex import FMIndex
    from dsm_tpu.mining.config import MiningConfig
    from dsm_tpu.mining.engine_np import mine_np

    idxs = [FMIndex.load(f + ".dtfmi") for f in _fastas(data)]
    t0 = time.perf_counter()
    res = mine_np(idxs, MiningConfig(fmin=2, emax=1.2),
                  prefix=prefix.encode(), reader_order=order)
    wall = time.perf_counter() - t0
    blob = res.format_lines()
    with open(os.path.join(out, f"{prefix}.{order}.txt"), "wb") as f:
        f.write(blob)
    rec = dict(prefix=prefix, order=order, total_paths=res.total_paths,
               total_output=res.total_output, total_occs=res.total_occs,
               smallest_entropy=res.smallest_entropy,
               largest_entropy=res.largest_entropy,
               sha256=hashlib.sha256(blob).hexdigest(), wall_s=wall)
    with open(os.path.join(out, f"{prefix}.{order}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def merge(data: str, out: str, scale: int) -> dict:
    """The indexes of `data` and the per-run records and bytes of `out` ->
    the S1000 dict."""
    from dsm_tpu.index.fmindex import FMIndex

    recs = {}
    for p in PREFIXES:
        for o in ORDERS:
            with open(os.path.join(out, f"{p}.{o}.json")) as f:
                recs[p, o] = json.load(f)
    whole = {}
    for o in ORDERS:
        h = hashlib.sha256()
        for p in PREFIXES:
            with open(os.path.join(out, f"{p}.{o}.txt"), "rb") as f:
                h.update(f.read())
        whole[o] = h.hexdigest()
    for p in PREFIXES:
        a, g = recs[p, "ascending"], recs[p, "gnu"]
        if (a["total_paths"], a["total_output"], a["total_occs"]) != \
                (g["total_paths"], g["total_output"], g["total_occs"]):
            raise SystemExit(f"prefix {p}: the two orders' counts differ")
    gnu = [recs[p, "gnu"] for p in PREFIXES]
    return dict(
        scale=scale,
        symbols=sum(FMIndex.load(f + ".dtfmi").n for f in _fastas(data)),
        paths=sum(r["total_paths"] for r in gnu),
        lines=sum(r["total_output"] for r in gnu),
        occs=sum(r["total_occs"] for r in gnu),
        entropy=(min(r["smallest_entropy"] for r in gnu),
                 max(r["largest_entropy"] for r in gnu)),
        gnu=whole["gnu"], ascending=whole["ascending"],
        prefixes={p: dict(paths=recs[p, "gnu"]["total_paths"],
                          lines=recs[p, "gnu"]["total_output"],
                          gnu=recs[p, "gnu"]["sha256"],
                          ascending=recs[p, "ascending"]["sha256"])
                  for p in PREFIXES})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--scale", type=int, default=1000)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--merge", action="store_true",
                    help="only print the S1000 dict of finished runs")
    a = ap.parse_args()
    data, out = os.path.join(a.outdir, "data"), os.path.join(a.outdir, "out")
    if not a.merge:
        from make_toydata import GOLDEN_SEED, make_toydata

        os.makedirs(out, exist_ok=True)
        t0 = time.perf_counter()
        if not os.path.isdir(data) or not _fastas(data):
            make_toydata(data, scale=a.scale, seed=GOLDEN_SEED)
        todo = [f for f in _fastas(data) if not os.path.exists(f + ".dtfmi")]
        with ProcessPoolExecutor(max_workers=a.jobs) as ex:
            for path, n, s in ex.map(build, todo):
                print(f"built {path}: {n:,} symbols in {s:.1f} s",
                      flush=True)
            runs = [(p, o) for o in ORDERS for p in PREFIXES
                    if not os.path.exists(os.path.join(out, f"{p}.{o}.json"))]
            futs = [ex.submit(mine, data, out, p, o) for p, o in runs]
            for f in futs:
                r = f.result()
                print(f"mined {r['prefix']} {r['order']}: "
                      f"{r['total_paths']:,} paths, {r['total_output']} "
                      f"lines in {r['wall_s']:.1f} s", flush=True)
        print(f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(merge(data, out, a.scale), indent=1))


if __name__ == "__main__":
    main()
