"""dsm_tpu_torch's benchmark: one run of one cell on the card.

    python3 dsmbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell (`BENCHMARK.json`'s workload NAME)
names a configuration (dsmbench/configs/<config>.json: its generator,
sizes and mining settings) and a traffic mix (dsmbench/traffic/<traffic>
.json: the jobs' scope, reader order and job order); dsmbench/cells/
<NAME>.json holds the cell's limits for `correct`.  Metrics are readers
of their own (dsmbench/metrics/<metric>.py), each reported in the cells
that BENCHMARK.json lists for it.  A later cell, traffic mix, config or
metric is a new file and a new manifest entry; no file here changes.

A run: set-up (import the port and load its kernel library, which nvcc
builds on a checkout's first run; write the configuration's FASTA from
the seed into a fresh directory under TMPDIR; build the indexes on the
card with `index.build.indexes_from_fasta`; upload them once with
`mining.engine.DeviceIndexes.build`; run one job of the cell's traffic),
then a closed loop of one client: `mining.engine.mine_torch` jobs back to
back over the resident tables until `--seconds` have passed, the job in
flight finishing.  With `--trace 1` the same window runs untraced for the
host-clock readings, and then under `torch.profiler` for up to
TRACE_SECONDS more.  Once the windows close and the peak is read, the
program's state is freed and the plain reference (reference.py) mines the
same FASTA files in the traffic's reader order; check.py compares every
job's answer with it.

The last line of standard output is the result as one JSON object; the
compared numbers and their limits are the last lines of standard error.
Without a CUDA card (or with fewer than the cell asks for) the run exits
with code 2 and prints no result; if `jax`, `jaxlib`, `flax` or `dsm_tpu`
is loaded in the process once the windows close, with code 3.
"""

from __future__ import annotations

import time

_T_LOADED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "dsmbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dsmbench import check, datagen, reference  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dsm_tpu")
TRACE_SECONDS = 4.0     # the traced window's length at most
# the program's functions whose calls the traced window marks as spans, to
# name the device's idle gaps by what the host was doing
PHASES = (("level", "dsm_tpu_torch.mining.engine_device", "_level"),
          ("drain", "dsm_tpu_torch.mining.engine_device", "_drain"),
          ("pull", "dsm_tpu_torch.mining.engine_device", "_pull_segment"),
          ("tail", "dsm_tpu_torch.mining.engine_device", "_handoff_tail"))
SPAN = "dsmbench."
KERNEL_DEF = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def process_age() -> float:
    """Seconds since this process started: from /proc where it reads
    sensibly, else since this module was loaded."""
    loaded = time.perf_counter() - _T_LOADED
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return loaded
    return age if loaded <= age <= loaded + 60 else loaded


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, bench: Path = BENCH):
    """The reader module dsmbench/metrics/<name>.py."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"dsmbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, kind: str, cell: str) -> list[dict]:
    """The manifest's `kind` metrics ("end_to_end" or "per_layer") that
    `cell` reports: those that list it, and those that list no cells."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def job_prefixes(traffic: dict, seed: int):
    """The traffic's jobs as an endless stream of enforced prefixes:
    "repeat", the whole trie (b"") again and again; "shuffled_cycle",
    every prefix of `prefix_depth` symbols in an order shuffled by the
    seed, cycled."""
    import itertools

    import numpy as np

    if traffic["job_order"] == "repeat" and traffic["scope"] == "whole":
        return itertools.repeat(b"")
    if traffic["job_order"] != "shuffled_cycle" or traffic["scope"] != "prefix":
        raise ValueError(f"unknown traffic: {traffic}")
    prefixes = [bytes(p) for p in itertools.product(
        b"ACGT", repeat=traffic["prefix_depth"])]
    order = np.random.default_rng(seed).permutation(len(prefixes))
    return itertools.cycle([prefixes[i] for i in order])


@dataclass
class Job:
    prefix: bytes
    wall_s: float
    paths: int
    profile: dict


@dataclass
class Trace:
    """The traced window: its length, the device's busy seconds (the
    union of its activities), the jobs run, the seconds of the program's
    kernels, the device operations by time and the idle gaps by phase."""

    window_s: float
    busy_s: float
    jobs: int
    kernel_s: float
    device_ops: list
    idle_gaps: list


@dataclass
class Run:
    """What a run saw; the metric readers read it."""

    cell: str
    jobs: list = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    build_s: float = 0.0
    upload_s: float = 0.0
    peak_bytes: int = 0
    trace: Trace | None = None

    def phase_ms(self, key: str) -> float | None:
        """A profile key's seconds, a job's average over the window, in ms."""
        vals = [j.profile[key] for j in self.jobs if key in j.profile]
        return 1e3 * sum(vals) / len(vals) if vals else None


def port_kernels(root: Path = ROOT) -> set[str]:
    """The names of the program's CUDA kernels (its csrc/*.cu files)."""
    names = set()
    for src in sorted((root / "dsm_tpu_torch" / "csrc").glob("*.cu*")):
        names.update(KERNEL_DEF.findall(src.read_text()))
    return names


def is_port_kernel(name: str, kernels: set[str]) -> bool:
    """Whether a traced device operation is one of `kernels`: its name
    holds a kernel's name right after a space, '::' or its start, followed
    by '(' or '<', and it is none of PyTorch's or CUB's own."""
    if any(lib in name for lib in ("at::", "c10::", "cub::", "thrust::")):
        return False
    for m in re.finditer(r"(?:^|\s|::)(\w+)\s*[(<]", name):
        if m.group(1) in kernels:
            return True
    return False


def _kineto_events(prof):
    """(name, on the device, start ns, end ns) of each traced event."""
    from torch.autograd import DeviceType

    res = getattr(prof.profiler, "kineto_results", None)
    out = []
    if res is not None:
        for e in res.events():
            if hasattr(e, "start_ns"):
                s, dur = e.start_ns(), e.duration_ns()
            else:
                s, dur = 1000 * e.start_us(), 1000 * e.duration_us()
            out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                        s + dur))
        return out
    for e in prof.events():
        s, t = e.time_range.start * 1000, e.time_range.end * 1000
        out.append((e.name, e.device_type == DeviceType.CUDA, s, t))
    return out


def read_trace(events, kernels: set[str]) -> Trace:
    """Reduce the traced events to a Trace.  The window runs from the
    first traced job's start to the last one's end; the device's activity
    is every device event but the profiler's own annotations and
    synchronisations."""
    import bisect

    jobs = sorted((s, t) for n, dev, s, t in events
                  if not dev and n == SPAN + "job")
    if not jobs:
        raise RuntimeError("the trace holds no job")
    w0, w1 = jobs[0][0], jobs[-1][1]
    acts = sorted((max(s, w0), min(t, w1), n) for n, dev, s, t in events
                  if dev and t > w0 and s < w1 and not n.startswith(SPAN)
                  and "Sync" not in n)
    busy, gaps, by_op, kernel = 0, [], {}, 0
    cur0 = cur1 = w0
    for s, t, n in acts:
        by_op[n] = by_op.get(n, 0) + (t - s)
        if is_port_kernel(n, kernels):
            kernel += t - s
        if s > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, s))
            cur0 = s
        cur1 = max(cur1, t)
    busy += cur1 - cur0
    if cur1 < w1:
        gaps.append((cur1, w1))
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device activity in the "
                           "traced window")
    phases = sorted((s, t, n[len(SPAN):]) for n, dev, s, t in events
                    if not dev and n.startswith(SPAN) and n != SPAN + "job")
    starts = [p[0] for p in phases]
    jstarts = [j[0] for j in jobs]
    idle: dict[str, list] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        j = bisect.bisect_right(jstarts, mid) - 1
        if i >= 0 and phases[i][1] >= mid:
            name = phases[i][2]
        elif j >= 0 and jobs[j][1] >= mid:
            name = "job, outside the phases"
        else:
            name = "between jobs"
        acc = idle.setdefault(name, [0, 0, 0])
        acc[0] += g1 - g0
        acc[1] += 1
        acc[2] = max(acc[2], g1 - g0)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1][0])[:10]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, jobs=len(jobs),
                 kernel_s=kernel / 1e9,
                 device_ops=[[n[:100], v / 1e9] for n, v in ops],
                 idle_gaps=[[f"{n} ({c} gaps, longest {m / 1e6:.3f} ms)",
                             v / 1e9] for n, (v, c, m) in gap_list])


class _Spans:
    """Marks each call of the PHASES functions as a profiler span while
    installed (the traced window only)."""

    def __init__(self):
        self.saved = []

    def __enter__(self):
        import importlib

        import torch

        for name, modname, attr in PHASES:
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr, None)
            if not callable(fn):
                continue

            def spanned(*a, _fn=fn, _name=SPAN + name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, spanned)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved = []


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Path = BENCH,
             manifest: dict | None = None) -> tuple[dict, Run]:
    """One run of cell `name`; -> the result dict (the JSON line's keys)
    and the Run the readers read.  `device` "cpu" runs the port's plain
    CPU path (tests only: no result of it is a device number)."""
    if manifest is None:
        manifest = load_json(bench.parent / "BENCHMARK.json")
    wl = next(w for w in manifest["workloads"] if w["name"] == name)
    cellfile = load_json(bench / "cells" / f"{name}.json")
    config = load_json(bench / "configs" / f"{wl['config']}.json")
    traffic = load_json(bench / "traffic" / f"{wl['traffic']}.json")
    if (cellfile["config"], cellfile["traffic"]) != (wl["config"],
                                                     wl["traffic"]):
        raise ValueError(f"{name}: the cell's file and the manifest differ")

    import torch

    from dsm_tpu_torch.index.build import indexes_from_fasta
    from dsm_tpu_torch.mining import engine
    from dsm_tpu_torch.mining.config import MiningConfig
    from dsm_tpu_torch.ops import _build

    dev_t = torch.device(device)
    if dev_t.type == "cuda":
        dev_t = torch.device("cuda", torch.cuda.current_device())
        _build.lib()
        if _build.build_seconds is not None:
            log(f"setup: the kernel library built in {_build.build_seconds:.1f} s")
    run = Run(cell=name)
    work = tempfile.mkdtemp(prefix="dsmbench-")
    try:
        t = time.perf_counter()
        paths = datagen.generate(config, seed, work)
        log(f"setup: data in {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        indexes = indexes_from_fasta(paths, dev_t)
        _sync(torch, dev_t)
        run.build_s = time.perf_counter() - t
        t = time.perf_counter()
        dev = engine.DeviceIndexes.build(indexes, dev_t)
        _sync(torch, dev_t)
        run.upload_s = time.perf_counter() - t
        cfg = MiningConfig(**config["mining"])
        order = traffic["reader_order"]
        answers, failed = [], 0

        def job(prefix: bytes) -> Job:
            """One mining job; a job that raises is counted in `failed`
            and has no answer."""
            nonlocal failed
            prof: dict = {}
            t0 = time.perf_counter()
            try:
                out = engine.mine_torch(indexes, cfg, prefix=prefix,
                                        reader_order=order, dev=dev,
                                        device=dev_t, profile=prof)
                _sync(torch, dev_t)
            except Exception as exc:  # a job that fails is counted, not fatal
                failed += 1
                log(f"job {prefix!r} failed: {exc!r}")
                return Job(prefix, time.perf_counter() - t0, 0, prof)
            answers.append((prefix, out))
            gc.freeze()
            return Job(prefix, time.perf_counter() - t0, out.total_paths,
                       prof)

        def window(stream, secs: float, span=None) -> list[Job]:
            jobs, t0 = [], time.perf_counter()
            while True:
                if span is None:
                    jobs.append(job(next(stream)))
                else:
                    with span(SPAN + "job"):
                        jobs.append(job(next(stream)))
                if time.perf_counter() - t0 >= secs:
                    return jobs

        t = time.perf_counter()
        warm = job(next(job_prefixes(traffic, seed)))
        log(f"setup: build {run.build_s:.2f} s, upload {run.upload_s:.2f} s, "
            f"warm-up job {time.perf_counter() - t:.2f} s "
            f"({warm.paths:,} paths)")
        # the answers the harness keeps would make every later collection
        # of the interpreter's cycle collector walk them: keep them out of
        # its generations, as the set-up's objects
        gc.collect()
        gc.freeze()
        run.setup_s = process_age()
        stream = job_prefixes(traffic, seed)
        _build.reset_launches()
        t0 = time.perf_counter()
        run.jobs = window(stream, seconds)
        run.window_s = time.perf_counter() - t0
        attempted = len(run.jobs)
        log("launches a job: " + json.dumps(
            {k: v / len(run.jobs) for k, v in _build.LAUNCHES.items() if v}))
        walls = sorted(j.wall_s for j in run.jobs)
        log(f"job walls: min {walls[0]:.4f} median "
            f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; a job's "
            + ", ".join(f"{k} {run.phase_ms(k):.2f} ms" for k in (
                "level_s", "drain_s", "tail_s", "pull_s")
                if run.phase_ms(k) is not None))
        if trace:
            with _Spans(), torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                attempted += len(window(stream, min(seconds, TRACE_SECONDS),
                                        torch.profiler.record_function))
            run.trace = read_trace(_kineto_events(prof), port_kernels())
        if dev_t.type == "cuda":
            run.peak_bytes = int(torch.cuda.max_memory_allocated(dev_t))
        del dev, indexes
        gc.unfreeze()
        gc.collect()
        if dev_t.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ix = reference.RefIndex.from_fasta(paths, dev_t)
        t1 = time.perf_counter()
        expected = reference.mine_jobs(
            ix, sorted({p for p, _o in answers}), **config["mining"],
            reader_order=order)
        del ix
        log(f"reference: its index in {t1 - t:.2f} s, {len(expected)} "
            f"job(s) in {time.perf_counter() - t1:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = check.compare(answers, expected, failed)
    ok, table = check.judge(got, cellfile["limits"])
    kind = "end_to_end" if not trace else "per_layer"
    metrics = {}
    for m in cell_metrics(manifest, kind, name):
        value = load_metric(m["name"], bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res = {"correct": bool(ok and answers), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": device_info(torch, dev_t, run)}
    if run.trace is not None:
        res["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    res["checks"] = table
    return res, run


def device_info(torch, dev_t, run: Run) -> dict:
    if dev_t.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev_t),
                "count": 1, "memory_peak_bytes": run.peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if run.trace is not None:
        info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    return info


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi where it runs."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return proc.stdout.strip() or "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in manifest["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); this host "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res, run = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", BENCH, manifest)
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"window: {len(run.jobs)} jobs in {run.window_s:.3f} s, "
          f"{sum(j.paths for j in run.jobs):,} paths; set-up "
          f"{run.setup_s:.2f} s; peak {run.peak_bytes:,} B", file=sys.stderr)
    for k, (v, lim) in res["checks"].items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(res))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
