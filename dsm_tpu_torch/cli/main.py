"""`python -m dsm_tpu_torch build|mine|distance [--device cuda|cpu] ...` —
the port's CLI.

Counterpart of dsm_tpu/cli/main.py: the same subcommands and flags (every
`dsm` command line parses here; the reference's separate executables
behind them are builder, metaenumerate, metaserver and smtxt2entropy),
with one more flag on the ported subcommands, `--device` (default cuda;
only an explicit `--device cpu` runs on the CPU).  Numeric validation
mirrors atoi_min/atof_min (metaserver.cpp:60-100): bad values exit with
status 1 and a message on stderr.

build:    `--sa-backend auto` (the default) suffix-sorts on --device;
          `--sa-backend numpy` sorts on the host with NumPy;
          `--sa-backend jax` is refused.  With -v, stderr has `dsm build
          -v`'s lines.
mine:     stdout is `out.format_lines()`; with -v, stderr carries the index
          loads and the same four counter lines.  --checkpoint FILE
          snapshots the run at its drain exits and resumes from FILE when
          it exists (dsm_tpu's snapshot format, so a snapshot of `dsm mine
          --checkpoint` resumes here and the other way round).
distance: mined rows on stdin -> the four pairwise matrix files.  Without
          --fast the rows are accumulated one by one on the host in f64
          (byte parity with the reference, whatever --device says); with
          --fast whole chunks go through the pairwise-matrix kernel on
          --device.
enumerate, serve, launch, mine --engine and the multi-host flags are not
ported yet and exit with status 1.
"""

from __future__ import annotations

import argparse
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


# ----------------------------------------------------------------- mine --

def cmd_mine(args) -> int:
    from ..mining.config import UNLIMITED, MiningConfig
    from ..mining.engine import mine_torch

    if args.emax is None:
        _die("dsm mine: error: expecting parameter --emax")
    if args.engine != "tpu" or args.num_hosts:
        _die("dsm_tpu_torch mine: only the default engine is ported "
             "(no --engine or --num-hosts yet)")
    device = _device(args, "mine")
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
    prefix = args.prefix.encode() if args.prefix else b""
    out = mine_torch(indexes, cfg, prefix=prefix,
                     reader_order=args.reader_order, device=device,
                     checkpoint=args.checkpoint)
    sys.stdout.buffer.write(out.format_lines())
    if args.verbose:
        print(f"Number of paths: {out.total_paths}\n"
              f"Number of reported paths: {out.total_output}\n"
              f"Number of reported occs: {out.total_occs}\n"
              f"Smallest and largest entropies encountered: "
              f"{out.smallest_entropy:g} and {out.largest_entropy:g}",
              file=sys.stderr)
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

def _not_ported(args) -> int:
    _die(f"dsm_tpu_torch: '{args.cmd}' is not ported yet (only 'build', "
         "'mine' and 'distance'; the JAX package's `dsm` runs the others)")


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
        help="stream a sample's trie to servers (not ported yet)")
    e.add_argument("index")
    e.add_argument("-f", "--fmin", type=_int_min(1, "-f, --fmin"), default=10)
    e.add_argument("-M", "--maxdepth",
                   type=_int_min(1, "-M, --maxdepth"), default=0)
    e.add_argument("-C", "--check", action="store_true")
    e.add_argument("-v", "--verbose", action="store_true")
    e.add_argument("--debug", action="store_true")
    e.set_defaults(fn=_not_ported)

    s = sub.add_parser(
        "serve", help="merge trie streams + entropy gates (not ported yet)")
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
    s.set_defaults(fn=_not_ported)

    m = sub.add_parser(
        "mine", help="integrated pipeline: indexes -> mined substrings")
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
                   help="dsm's engine choice; only the default, the "
                        "device-resident episode, is ported")
    m.add_argument("--hbm-budget", type=_int_min(1, "--hbm-budget"),
                   default=None, help="for --engine auto (not ported yet)")
    m.add_argument("--reader-order", choices=["ascending", "gnu"],
                   default="ascending",
                   help="per-line reader order; 'gnu' replicates the "
                        "reference byte-exactly")
    m.add_argument("--checkpoint", default=None,
                   help="snapshot file written at episode exits and "
                        "resumed from if present")
    m.add_argument("--num-hosts", type=_int_min(1, "--num-hosts"),
                   default=0, help="multi-host mining (not ported yet)")
    m.add_argument("--host-id", type=_int_min(0, "--host-id"), default=None)
    m.add_argument("--coordinator", default=None)
    m.add_argument("--hash-depth", type=_int_min(1, "--hash-depth"),
                   default=0)
    m.add_argument("-v", "--verbose", action="store_true")
    _add_device(m, "mine")
    m.set_defaults(fn=cmd_mine)

    ln = sub.add_parser(
        "launch", help="orchestrate a server/client fleet (not ported yet)")
    ln.add_argument("indexes", nargs="+")
    ln.add_argument("--mode", choices=["local", "slurm", "config"],
                    default="local")
    ln.add_argument("--tmpdir", default="dsm_tmp")
    ln.add_argument("--outdir", default="dsm_out")
    ln.add_argument("--base-port", type=_int_min(1024, "--base-port"),
                    default=52000)
    ln.add_argument("--hash-depth", type=_int_min(1, "--hash-depth"),
                    default=1)
    ln.add_argument("-E", "--emax", type=_float_min(0, "-E, --emax"),
                    default=1.2)
    ln.add_argument("-f", "--fmin", type=_int_min(1, "-f, --fmin"),
                    default=2)
    ln.add_argument("--server-cmd", default=None)
    ln.add_argument("--client-cmd", default=None)
    ln.set_defaults(fn=_not_ported)

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
