"""`python -m dsm_tpu_torch mine|build [--device cuda|cpu] ...` — the
port's CLI.

Counterpart of dsm_tpu/cli/main.py `cmd_mine` (default engine) and
`cmd_build`: the same parser (dsm_tpu.cli.main.build_parser, JAX-free at
import) with one more flag on each, `--device` (default cuda; only an
explicit `--device cpu` runs on the CPU).

mine:  stdout is `out.format_lines()`; with -v, stderr carries the index
       loads and the same four counter lines.
build: `--sa-backend auto` (the default) suffix-sorts on --device;
       `--sa-backend numpy` is dsm's own host build; `--sa-backend jax`
       is refused.  With -v, stderr has `dsm build -v`'s lines.
mine --checkpoint FILE snapshots the run at its drain exits and resumes
from FILE when it exists (dsm_tpu's snapshot format, so a snapshot of
`dsm mine --checkpoint` resumes here and the other way round).
The other subcommands, --engine and the multi-host flags are not ported
yet and exit with status 1.
"""

from __future__ import annotations

import argparse
import sys

from dsm_tpu.cli.main import _die, _load_index, build_parser


def parser() -> argparse.ArgumentParser:
    ap = build_parser()
    ap.prog = "python -m dsm_tpu_torch"
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    for cmd, what in (("mine", "mine"), ("build", "suffix-sort")):
        sub.choices[cmd].add_argument(
            "--device", default="cuda",
            help=f"torch device to {what} on (default cuda; no fallback to "
                 "the CPU: pass --device cpu to run there)")
    return ap


def cmd_build(args) -> int:
    from dsm_tpu.cli.main import cmd_build as dsm_cmd_build

    from ..index.build import build_index
    from ..utils.device import resolve_device

    if args.sa_backend == "jax":
        _die("dsm_tpu_torch build: --sa-backend jax is the JAX package's "
             "(`dsm build`); the port sorts on --device (auto) or on the "
             "host (numpy)")
    if args.sa_backend == "numpy":
        return dsm_cmd_build(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        _die(f"dsm_tpu_torch build: {e}")
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


def cmd_mine(args) -> int:
    from dsm_tpu.mining.config import UNLIMITED, MiningConfig

    from ..mining.engine import mine_torch
    from ..utils.device import resolve_device

    if args.emax is None:
        _die("dsm mine: error: expecting parameter --emax")
    if args.engine != "tpu" or args.num_hosts:
        _die("dsm_tpu_torch mine: only the default engine is ported "
             "(no --engine or --num-hosts yet)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        _die(f"dsm_tpu_torch mine: {e}")
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


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.cmd == "build":
        return cmd_build(args)
    if args.cmd != "mine":
        _die(f"dsm_tpu_torch: '{args.cmd}' is not ported yet (only 'mine' "
             "and 'build'; the JAX package's `dsm` runs the others)")
    return cmd_mine(args)


if __name__ == "__main__":
    raise SystemExit(main())
