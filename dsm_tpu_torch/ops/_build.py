"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles every source in `dsm_tpu_torch/csrc` to an object, one
process per source, all started together, and links them into one shared
library with a plain C interface, `build/kernels/libdsm_torch.so` under
the checkout, which `ctypes` loads.  The library is rebuilt when the
sha256 of the sources and flags changes.  Nothing here runs at import
time: a CPU-only host imports every module of the port without a
compiler.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`.  A wrapper calls it through `launch()`, which
passes the device's current stream, raises on a non-zero code and adds
one to the kernel's count in `LAUNCHES`: the counts are of wrapper calls
that launched the kernel, and nothing else adds to them.  `PATHS` names
the kernels each entry point runs: `dsm_tpu_torch build` (the suffix
array), `mine`, `distance --fast`, and the repro tool
(`dsm_tpu_torch.tools.pallas_repro`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
LIB_NAME = "libdsm_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

PATHS = {
    "build": ("sa_sort", "sa_rank"),
    "mine": ("rank", "compact", "segstats", "children", "decode"),
    "distance": ("distance",),
    "repro": ("repro_carry", "repro_async", "repro_dynstore"),
}
LAUNCHES = {k: 0 for keys in PATHS.values() for k in keys}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # rows, pos, pos_stride, soff, soff_stride, out, q, stream
    "dsm_occ_cum8": [_P, _P, _I64, _P, _I64, _P, _I64, _P],
    # mask, values, n, c, out, width, block_count, block_off, count, stream
    "dsm_compact_rows": [_P, _P, _I64, _I, _P, _I64, _P, _P, _P, _P],
    # nb, freq, cact, n_nodes, depth, s_total, mindepth, pmin, pmax,
    # use_egate, sym_mask, emin_lo, emax_hi, flags, ent, pair_out, stream
    "dsm_segstats": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _D, _D,
                     _P, _P, _P, _P],
    # nb, pairs, olo, ohi, keep, U, P, pair_count, child_total, cnt,
    # scratch, newp, nb_next, hist, stream
    "dsm_children": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P, _P,
                     _P, _P, _P],
    # hist, lvl_off, rows, jrel, m, maxj, base, syms, stream
    "dsm_decode": [_P, _P, _P, _P, _I64, _I, _P, _P, _P],
    # F, f_is64, bins, nfactor, R, d, nbins, slices, counts, order, count,
    # log, sqrt, lgamma, stream
    "dsm_pairwise": [_P, _I, _P, _P, _I64, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P, _P],
    # rank, prev, n, k, lo_bits, bits, keys, order, work, stream
    "dsm_sa_sort": [_P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P],
    # n, tail, bits -> bytes
    "dsm_sa_sort_workspace": [_I64, _I64, _I],
    # keys, order, n, rank, block_count, block_off, last, stream
    "dsm_sa_rank": [_P, _P, _I64, _P, _P, _P, _P, _P],
    # x, out, n, stream (dynstore: x, out, n, factor, stream)
    "dsm_repro_carry": [_P, _P, _I64, _P],
    "dsm_repro_async": [_P, _P, _I64, _P],
    "dsm_repro_dynstore": [_P, _P, _I64, _I, _P],
}

_lib = None
build_seconds = None   # wall time of the build this process ran, if any


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built on this host")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the sources if the library is missing or stale; return its
    path."""
    global build_seconds
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(obj) for _s, obj, _p in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
    finally:
        for _src, obj, _proc in jobs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_longlong if name.endswith("_workspace")
                          else ctypes.c_int)
        _lib = handle
    return _lib


def launch(entry: str, key: str, device, *args) -> None:
    """Call the C entry point `entry` with `args` and the current stream of
    `device` (a CUDA torch.device), raise if it reports an error, and count
    one launch of kernel `key`.  The current device is switched only when
    `device` is another one."""
    import torch

    fn = getattr(lib(), entry)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        raise RuntimeError(f"{key}: CUDA launch failed with error {code}")
    LAUNCHES[key] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
