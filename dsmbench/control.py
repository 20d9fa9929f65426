"""The control of a cell's comparison: the plain reference put in the
program's place and computed a precision lower (float32 where the
configuration states float64), on the cell's own data and jobs, judged by
the comparison that decides `correct` (check.py).  Its readings are the
upper ends the cell's limits were set below; it has to come out as not
correct.

    python3 dsmbench/control.py --workload NAME --seeds N [N ...]

prints, for each seed, one JSON line with the control's numbers and
whether the cell's limits pass them, on whatever device is there (the
card where there is one).  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dsmbench import check, datagen, reference  # noqa: E402
from dsmbench.run import BENCH, job_prefixes, load_json  # noqa: E402


def control(name: str, seed: int, device, bench: Path = BENCH,
            manifest: dict | None = None) -> dict:
    """The control's numbers for cell `name` at `seed`: every distinct job
    of the cell's traffic answered by the reference in float32, held
    against the reference in float64, both in the traffic's reader
    order."""
    import itertools

    if manifest is None:
        manifest = load_json(bench.parent / "BENCHMARK.json")
    wl = next(w for w in manifest["workloads"] if w["name"] == name)
    cellfile = load_json(bench / "cells" / f"{name}.json")
    config = load_json(bench / "configs" / f"{wl['config']}.json")
    traffic = load_json(bench / "traffic" / f"{wl['traffic']}.json")
    njobs = 1 if traffic["scope"] == "whole" else 4 ** traffic["prefix_depth"]
    prefixes = sorted(set(itertools.islice(job_prefixes(traffic, seed),
                                           njobs)))
    work = tempfile.mkdtemp(prefix="dsmbench-control-")
    try:
        paths = datagen.generate(config, seed, work)
        t = time.perf_counter()
        ix = reference.RefIndex.from_fasta(paths, device)
        order = traffic["reader_order"]
        want = reference.mine_jobs(ix, prefixes, **config["mining"],
                                   reader_order=order)
        low = reference.mine_jobs(ix, prefixes, **config["mining"],
                                  dtype=np.float32, reader_order=order)
        secs = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = check.compare(list(low.items()), want, 0)
    ok, table = check.judge(got, cellfile["limits"])
    return {"workload": name, "seed": seed, "correct": ok, "checks": table,
            "lines": sum(w.total_output for w in want.values()),
            "paths": sum(w.total_paths for w in want.values()),
            "seconds": secs}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
