"""`python -m dsm_tpu_torch <command> [--device cuda|cpu] ...` — the port's
CLI.

Counterpart of dsm_tpu/cli/main.py: the same subcommands and flags (every
`dsm` command line parses here and runs; the reference's separate
executables behind them are builder, metaenumerate, metaserver and
smtxt2entropy), with one more flag on build, mine and distance,
`--device` (default cuda; only an explicit `--device cpu` runs on the
CPU, and asking for CUDA where there is none exits 1).  stdin conventions
match the reference: `serve` reads expected sample names, `enumerate`
reads `host port enforcepath` triplets.  Numeric validation mirrors
atoi_min/atof_min (metaserver.cpp:60-100): bad values exit with status 1
and a message on stderr.

build:     `--sa-backend auto` (the default) suffix-sorts on --device;
           `--sa-backend numpy` sorts on the host with NumPy;
           `--sa-backend jax` is refused.  With -v, stderr has `dsm build
           -v`'s lines.
mine:      stdout is `out.format_lines()`; with -v, stderr carries the
           index loads and the same four counter lines.  --checkpoint FILE
           snapshots the run at its drain exits and resumes from FILE when
           it exists (dsm_tpu's snapshot format, so a snapshot of `dsm mine
           --checkpoint` resumes here and the other way round).  --engine
           numpy mines on the host (engine_np.mine_np); --engine
           sharded-episode shards the samples over DSM_SHARDS (environment,
           default 1) shards on --device (parallel/engine_episode);
           --engine sharded runs the per-level (prefix, samples) mesh engine
           (parallel/engine_sharded.mine_sharded, mesh default_mesh_shape(
           DSM_SHARDS)), which, as dsm's, takes no snapshot and ignores
           --checkpoint; --engine auto routes by the capacity plan
           (mining/bigindex.mine_big) under --hbm-budget bytes a device.
           --num-hosts N --host-id I mines host I's share of the DNA-prefix
           shards (parallel/multihost.mine_owned; --coordinator H:P joins a
           torch.distributed group, gloo on the CPU and NCCL on CUDA, which
           exchanges nothing).  DSM_TRACE=<dir> (environment) runs the
           mining under torch.profiler with the port's phase spans
           annotated (utils/trace.py) and writes <dir>/mine-<pid>.json,
           a Chrome trace of the `dsm.*` spans and the device's kernels on
           one clock.
enumerate: streams one sample's trie to the servers on stdin
           (net/client.run_client, host code); --check runs the index's
           self-test.
serve:     merges the clients' trie streams and prints the reference
           server's lines (net/server.serve, host code).
launch:    a serve/enumerate fleet on this machine (--mode local), sbatch
           scripts (--mode slurm) or the discovery files alone (--mode
           config) (cli/launch.py).
distance:  mined rows on stdin -> the four pairwise matrix files.  Without
           --fast the rows are accumulated one by one on the host in f64
           (byte parity with the reference, whatever --device says); with
           --fast whole chunks go through the pairwise-matrix kernel on
           --device.
"""

from __future__ import annotations

import argparse
import os
import sys


def _die(msg: str) -> "NoReturn":  # noqa: F821
    print(msg, file=sys.stderr)
    raise SystemExit(1)


def _int_min(minv: int, flag: str):
    def conv(value: str):
        try:
            i = int(value)
        except ValueError:
            _die(f"dsm: argument of {flag} must be of type <int>, and "
                 f"greater than or equal to {minv}")
        if i < minv:
            _die(f"dsm: argument of {flag} must be greater than or equal "
                 f"to {minv}")
        return i
    return conv


def _float_min(minv: float, flag: str):
    def conv(value: str):
        try:
            f = float(value)
        except ValueError:
            _die(f"dsm: argument of {flag} must be of type <double>, and "
                 f"greater than or equal to {minv}")
        if f < minv:
            _die(f"dsm: argument of {flag} must be greater than or equal "
                 f"to {minv}")
        return f
    return conv


def _device(args, cmd: str):
    """The torch device --device names; exits 1 for CUDA where there is
    none."""
    from ..utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        _die(f"dsm_tpu_torch {cmd}: {e}")


# ---------------------------------------------------------------- build --

def cmd_build(args) -> int:
    from ..index.build import build_index

    if args.sa_backend == "jax":
        _die("dsm_tpu_torch build: --sa-backend jax is the JAX package's "
             "(`dsm build`); the port sorts on --device (auto) or on the "
             "host (numpy)")
    device = None if args.sa_backend == "numpy" else _device(args, "build")
    if args.sample_rate and args.sample_rate <= 3:
        print("Warning: small samplerates (-s, --sample-rate) may yield "
              "infeasible index sizes", file=sys.stderr)
    for inp in args.input:
        out = build_index(inp, output=args.output,
                          samplerate=args.sample_rate or 0, device=device,
                          fmt=args.format, buffer_symbols=args.buffer_symbols,
                          verbose=args.verbose)
        if args.verbose:
            print(f"Save complete. ({out})", file=sys.stderr)
    return 0


# ---------------------------------------------------------- index load --

def _load_index(path: str):
    from ..index.build import libname
    from ..index.fmindex import FMIndex

    return FMIndex.load(path), libname(path)


# ------------------------------------------------------------ enumerate --

def cmd_enumerate(args) -> int:
    idx, name = _load_index(args.index)
    if args.check:
        ok = idx.check()
        print(f"{args.index}: {'OK' if ok else 'FAILED'}", file=sys.stderr)
        return 0 if ok else 1
    from ..net.client import UNLIMITED_DEPTH, run_client

    hosts = []
    data = sys.stdin.read().split()
    it = iter(data)
    for host in it:
        try:
            port = int(next(it))
            enforce = next(it)
        except StopIteration:
            _die("error: truncated host info")
        if port < 1024:
            _die(f"error: invalid port number: {port}")
        if not enforce:
            _die("error: invalid enforced path")
        hosts.append((host, port, enforce))
    if not hosts:
        _die("error: empty host info")
    maxdepth = args.maxdepth if args.maxdepth else UNLIMITED_DEPTH
    total = run_client(idx, name, hosts, fmin=args.fmin, maxdepth=maxdepth,
                       verbose=args.verbose)
    if args.verbose:
        print(f"Number of reported alignments: {total}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------- serve --

def cmd_serve(args) -> int:
    from ..mining.config import MiningConfig
    from ..net.server import serve

    if args.emax is None:
        _die("dsm serve: error: expecting parameter --emax")
    if args.emin > args.emax:
        _die("dsm serve: error: -e <double> must be smaller than or equal "
             "to -E <double>")
    names = [line.split("\t")[0] for line in sys.stdin.read().splitlines()
             if line.strip()]
    cfg = MiningConfig(fmin=1, pmin=args.pmin, pmax=args.pmax,
                       emin=args.emin, emax=args.emax,
                       mindepth=args.mindepth)
    serve(args.port, names, cfg, verbose=args.verbose, debug=args.debug,
          topfreq=args.topfreq, toptimes=args.toptimes,
          outputall=args.outputall)
    return 0


# ----------------------------------------------------------------- mine --

def _mine_owned(args, indexes, cfg, device):
    """--num-hosts: this host's prefix shards, merged; with --coordinator
    inside a torch.distributed group, destroyed before returning."""
    import torch.distributed as dist

    from ..parallel.multihost import initialize, mine_owned

    if args.coordinator:
        cuda = device is not None and device.type == "cuda"
        initialize(args.coordinator, args.num_hosts, args.host_id,
                   backend="nccl" if cuda else "gloo")
    try:
        return mine_owned(indexes, cfg, args.num_hosts, args.host_id,
                          hash_depth=args.hash_depth or None,
                          engine=args.engine, device=device)
    finally:
        if args.coordinator:
            dist.destroy_process_group()


def cmd_mine(args) -> int:
    from ..mining.config import UNLIMITED, MiningConfig

    if args.emax is None:
        _die("dsm mine: error: expecting parameter --emax")
    prefix = args.prefix.encode() if args.prefix else b""
    if args.num_hosts:
        if args.host_id is None:
            _die("dsm mine: --num-hosts requires --host-id")
        if prefix:
            _die("dsm mine: --prefix and --num-hosts are exclusive "
                 "(prefix ownership is computed per host)")
    elif args.engine == "auto" and prefix:
        _die("dsm mine: --engine auto does not take --prefix")
    # the host engine needs no device
    device = None if args.engine == "numpy" else _device(args, "mine")
    cfg = MiningConfig(
        fmin=args.fmin, maxdepth=args.maxdepth or UNLIMITED,
        pmin=args.pmin, pmax=args.pmax, emin=args.emin, emax=args.emax,
        mindepth=args.mindepth)
    indexes = []
    for path in args.indexes:
        idx, _name = _load_index(path)
        indexes.append(idx)
        if args.verbose:
            print(f"loaded {path} (n = {idx.n})", file=sys.stderr)
    trace_dir = os.environ.get("DSM_TRACE")
    if trace_dir:
        out = _traced(trace_dir, lambda: _mine(args, indexes, cfg, prefix,
                                               device))
    else:
        out = _mine(args, indexes, cfg, prefix, device)
    sys.stdout.buffer.write(out.format_lines())
    if args.verbose:
        print(f"Number of paths: {out.total_paths}\n"
              f"Number of reported paths: {out.total_output}\n"
              f"Number of reported occs: {out.total_occs}\n"
              f"Smallest and largest entropies encountered: "
              f"{out.smallest_entropy:g} and {out.largest_entropy:g}",
              file=sys.stderr)
    return 0


def _traced(trace_dir: str, fn):
    """fn() under torch.profiler (CPU activity, and CUDA's where there is a
    card) with the port's spans annotated; the Chrome trace goes to
    <trace_dir>/mine-<pid>.json.  The profiler opens here, not in the
    library, so that a caller's own profiler is never nested."""
    import torch

    from ..utils import trace

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    trace.annotate(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
    finally:
        trace.annotate(False)
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"mine-{os.getpid()}.json"))
    return out


def _mine(args, indexes, cfg, prefix: bytes, device):
    """`mine`'s run by its engine and host options -> MinedOutput."""
    if args.num_hosts:
        out = _mine_owned(args, indexes, cfg, device)
    elif args.engine == "auto":
        from ..mining.bigindex import mine_big

        out = mine_big(indexes, cfg, budget=args.hbm_budget,
                       reader_order=args.reader_order, verbose=args.verbose,
                       device=device)
    elif args.engine == "numpy":
        from ..mining.engine_np import mine_np

        out = mine_np(indexes, cfg, prefix=prefix,
                      reader_order=args.reader_order)
    elif args.engine == "sharded":
        # the per-level engine takes no snapshot: --checkpoint is not used
        from ..parallel.engine_sharded import mine_sharded

        out = mine_sharded(indexes, cfg, prefix=prefix,
                           reader_order=args.reader_order, device=device)
    elif args.engine == "sharded-episode":
        from ..parallel.engine_episode import mine_device_sharded

        out = mine_device_sharded(indexes, cfg, prefix=prefix,
                                  reader_order=args.reader_order,
                                  checkpoint=args.checkpoint, device=device)
    else:
        from ..mining.engine import mine_torch

        out = mine_torch(indexes, cfg, prefix=prefix,
                         reader_order=args.reader_order, device=device,
                         checkpoint=args.checkpoint)
    return out


# --------------------------------------------------------------- launch --

def cmd_launch(args) -> int:
    from ..index.build import libname
    from .launch import (emit_slurm, launch_local, prefix_hashes,
                         write_discovery)

    samples = [libname(p) for p in args.indexes]
    if len(set(samples)) != len(samples):
        _die("launch: duplicate sample names derived from index paths")
    kw = dict(
        samples=samples, indexes=[os.path.abspath(p) for p in args.indexes],
        tmpdir=args.tmpdir, outdir=args.outdir, base_port=args.base_port,
        hash_depth=args.hash_depth, emax=args.emax, fmin=args.fmin)
    if args.mode == "config":
        import socket

        os.makedirs(args.tmpdir, exist_ok=True)
        host = socket.gethostname()
        paths = [write_discovery(args.tmpdir, host, args.base_port + i, h)
                 for i, h in enumerate(prefix_hashes(args.hash_depth))]
        print("\n".join(paths))
        return 0
    if args.mode == "slurm":
        samplelist = os.path.join(args.tmpdir, "samples.txt")
        os.makedirs(args.tmpdir, exist_ok=True)
        with open(samplelist, "w") as f:
            f.write("\n".join(samples) + "\n")
        scripts = emit_slurm(samplelist=samplelist, **kw)
        print("\n".join(scripts))
        print("submit servers first, then clients once every "
              "metaserver_config_*.txt exists", file=sys.stderr)
        return 0
    if args.server_cmd:
        kw["server_cmd"] = args.server_cmd.split()
    if args.client_cmd:
        kw["client_cmd"] = args.client_cmd.split()
    outputs = launch_local(**kw)
    print("\n".join(outputs))
    return 0


# ------------------------------------------------------------- distance --

def cmd_distance(args) -> int:
    import numpy as np

    from ..post.distance import DistanceAccumulator, entropy_steps

    if (args.samples is None) == (args.samplefile is None):
        _die("give either the argument -s,--samples or -S,--samplefile.")
    if (args.maxent is None) == (args.entstep is None):
        _die("give either the argument -m,--maxent or -e,--entstep.")
    # only --fast runs on the device: the exact path is host f64
    device = _device(args, "distance") if args.fast else None
    runtosmpl = None
    runs = args.samples
    smpls = args.samples
    if args.samplefile:
        with open(args.samplefile) as f:
            vals = [int(x) for x in f.read().split()]
        runtosmpl = np.asarray(vals)
        runs = len(vals)
        smpls = int(runtosmpl.max()) + 1
        if smpls < 2 or runs < smpls:
            _die("unable to parse the samples file in the argument "
                 "-S,--samplefile.")
    maxents = ([float(x) for x in args.maxent.replace(",", " ").split()]
               if args.maxent else entropy_steps(args.entstep))
    sizes = None
    if args.normalize:
        with open(args.normalize) as f:
            sizes = np.array([float(line.split("\t")[1])
                              for line in f if line.strip()])
    acc = DistanceAccumulator(
        smpls=smpls, runs=runs, maxents=maxents, runtosmpl=runtosmpl,
        minfreq=args.minfreq, sizes=sizes, exact=not args.fast,
        device=device)
    acc.add_lines(sys.stdin)
    paths = acc.write(args.file, args.outdir)
    if args.verbose:
        print(f"Number of lines processed: {acc.rows_read}", file=sys.stderr)
        for p in paths:
            print(f"wrote {p}", file=sys.stderr)
    return 0


# ------------------------------------------------------------------ main --

def _add_device(sub_parser, what: str) -> None:
    sub_parser.add_argument(
        "--device", default="cuda",
        help=f"torch device to {what} on (default cuda; no fallback to "
             "the CPU: pass --device cpu to run there)")


def build_parser() -> argparse.ArgumentParser:
    """dsm_tpu's parser (every subcommand and flag of `dsm`), plus
    --device on build, mine and distance."""
    ap = argparse.ArgumentParser(
        prog="python -m dsm_tpu_torch",
        description="distributed string mining in PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="FASTA -> FM-index artifact")
    b.add_argument("input", nargs="+")
    b.add_argument("-o", "--output", default=None)
    b.add_argument("-s", "--sample-rate", dest="sample_rate",
                   type=_int_min(1, "-s, --sample-rate"), default=0)
    b.add_argument("--sa-backend", choices=["auto", "numpy", "jax"],
                   default="auto",
                   help="auto: suffix-sort on --device; numpy: on the host")
    b.add_argument("--format", choices=["dsmi", "fmi"], default="dsmi",
                   help="fmi writes a reference-compatible v17 index")
    b.add_argument("--buffer-symbols", type=_int_min(1, "--buffer-symbols"),
                   default=0,
                   help="bounded-memory build: flush+merge every N symbols")
    b.add_argument("-v", "--verbose", action="store_true")
    _add_device(b, "suffix-sort")
    b.set_defaults(fn=cmd_build)

    e = sub.add_parser(
        "enumerate",
        help="stream a sample's trie to servers (hostinfo on stdin)")
    e.add_argument("index")
    e.add_argument("-f", "--fmin", type=_int_min(1, "-f, --fmin"), default=10)
    e.add_argument("-M", "--maxdepth",
                   type=_int_min(1, "-M, --maxdepth"), default=0)
    e.add_argument("-C", "--check", action="store_true",
                   help="verify index integrity and exit")
    e.add_argument("-v", "--verbose", action="store_true")
    e.add_argument("--debug", action="store_true")
    e.set_defaults(fn=cmd_enumerate)

    s = sub.add_parser(
        "serve", help="merge trie streams + entropy gates (names on stdin)")
    s.add_argument("-p", "--port", type=_int_min(1024, "-p, --port"),
                   default=54666)
    s.add_argument("-P", "--pmin", type=_int_min(1, "-P, --pmin"), default=2)
    s.add_argument("--pmax", type=_int_min(1, "--pmax"), default=0)
    s.add_argument("-m", "--mindepth",
                   type=_int_min(1, "-m, --mindepth"), default=0)
    s.add_argument("-e", "--emin", type=_float_min(0, "-e, --emin"),
                   default=0.0)
    s.add_argument("-E", "--emax", type=_float_min(0, "-E, --emax"),
                   default=None)
    s.add_argument("-F", "--topfreq", type=_int_min(1, "--topfreq"),
                   default=0)
    s.add_argument("-T", "--toptimes", type=_int_min(1, "--toptimes"),
                   default=0)
    s.add_argument("-v", "--verbose", action="store_true")
    s.add_argument("--debug", action="store_true")
    s.add_argument("-A", "--outputall", action="store_true")
    s.set_defaults(fn=cmd_serve)

    m = sub.add_parser(
        "mine", help="integrated pipeline: indexes -> mined substrings",
        epilog="DSM_TRACE=<dir> (environment): run the mining under "
               "torch.profiler with the port's phase spans (dsm.job, "
               "dsm.level, dsm.drain, ...) annotated, and write "
               "<dir>/mine-<pid>.json, a Chrome trace of the spans and the "
               "device's kernels on one clock")
    m.add_argument("indexes", nargs="+")
    m.add_argument("-f", "--fmin", type=_int_min(1, "-f, --fmin"), default=10)
    m.add_argument("-M", "--maxdepth",
                   type=_int_min(1, "-M, --maxdepth"), default=0)
    m.add_argument("-P", "--pmin", type=_int_min(1, "-P, --pmin"), default=2)
    m.add_argument("--pmax", type=_int_min(1, "--pmax"), default=0)
    m.add_argument("-m", "--mindepth",
                   type=_int_min(1, "-m, --mindepth"), default=0)
    m.add_argument("-e", "--emin", type=_float_min(0, "-e, --emin"),
                   default=0.0)
    m.add_argument("-E", "--emax", type=_float_min(0, "-E, --emax"),
                   default=None)
    m.add_argument("--prefix", default="",
                   help="mine only the subtree under this DNA prefix "
                        "(enforcepath)")
    m.add_argument("--engine",
                   choices=["tpu", "auto", "numpy", "sharded",
                            "sharded-episode"],
                   default="tpu",
                   help="tpu (default): the device-resident episode; numpy: "
                        "the host engine; sharded-episode: the episode with "
                        "the samples in DSM_SHARDS (environment, default 1) "
                        "shards on --device; sharded: the per-level "
                        "(prefix, samples) mesh engine, default_mesh_shape("
                        "DSM_SHARDS) on --device, which takes no snapshot "
                        "(--checkpoint is not used); auto: "
                        "capacity-planned routing (one device / "
                        "sample-sharded episode / bounded-memory host, "
                        "mining/bigindex.py)")
    m.add_argument("--hbm-budget", type=_int_min(1, "--hbm-budget"),
                   default=None,
                   help="device memory budget in bytes a device for "
                        "--engine auto (default: 90%% of the device's free "
                        "memory, or DSM_HBM_BYTES)")
    m.add_argument("--reader-order", choices=["ascending", "gnu"],
                   default="ascending",
                   help="per-line reader order; 'gnu' replicates the "
                        "reference byte-exactly")
    m.add_argument("--checkpoint", default=None,
                   help="snapshot file written at episode exits and "
                        "resumed from if present (tpu and "
                        "sharded-episode engines)")
    m.add_argument("--num-hosts", type=_int_min(1, "--num-hosts"),
                   default=0,
                   help="multi-host prefix ownership: mine only this "
                        "host's share of the DNA-prefix shards")
    m.add_argument("--host-id", type=_int_min(0, "--host-id"), default=None)
    m.add_argument("--coordinator", default=None,
                   help="host:port of a torch.distributed group to join "
                        "(optional; prefix shards need no cross-host "
                        "traffic)")
    m.add_argument("--hash-depth", type=_int_min(1, "--hash-depth"),
                   default=0, help="prefix shard depth (4**depth shards)")
    m.add_argument("-v", "--verbose", action="store_true")
    _add_device(m, "mine")
    m.set_defaults(fn=cmd_mine)

    ln = sub.add_parser(
        "launch", help="orchestrate a server/client fleet "
                       "(wrapper-SLURM equivalent)")
    ln.add_argument("indexes", nargs="+")
    ln.add_argument("--mode", choices=["local", "slurm", "config"],
                    default="local",
                    help="config: only write the discovery files for "
                         "externally managed processes")
    ln.add_argument("--tmpdir", default="dsm_tmp")
    ln.add_argument("--outdir", default="dsm_out")
    ln.add_argument("--base-port", type=_int_min(1024, "--base-port"),
                    default=52000)
    ln.add_argument("--hash-depth", type=_int_min(1, "--hash-depth"),
                    default=1, help="prefix shards = 4**depth servers")
    ln.add_argument("-E", "--emax", type=_float_min(0, "-E, --emax"),
                    default=1.2)
    ln.add_argument("-f", "--fmin", type=_int_min(1, "-f, --fmin"),
                    default=2)
    ln.add_argument("--server-cmd", default=None,
                    help="external server binary (e.g. reference "
                         "metaserver) for mixed fleets")
    ln.add_argument("--client-cmd", default=None)
    ln.set_defaults(fn=cmd_launch)

    d = sub.add_parser(
        "distance", help="mined rows (stdin) -> pairwise distance matrices")
    d.add_argument("-s", "--samples", type=_int_min(2, "-s, --samples"),
                   default=None)
    d.add_argument("-S", "--samplefile", default=None)
    d.add_argument("-m", "--maxent", default=None)
    d.add_argument("-e", "--entstep", type=float, default=None)
    d.add_argument("-F", "--file", required=True,
                   help="suffix for the four output files")
    d.add_argument("-N", "--normalize", default=None)
    d.add_argument("-M", "--minfreq", type=_int_min(1, "-M, --minfreq"),
                   default=0)
    d.add_argument("--outdir", default=".")
    d.add_argument("--fast", action="store_true",
                   help="chunked accumulation on --device (float order "
                        "differs by ULPs)")
    d.add_argument("-v", "--verbose", action="store_true")
    _add_device(d, "accumulate --fast chunks")
    d.set_defaults(fn=cmd_distance)

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
