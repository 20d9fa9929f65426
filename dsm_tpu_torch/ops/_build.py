"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles every source in `dsm_tpu_torch/csrc` into one shared
library with a plain C interface, `build/kernels/libdsm_torch.so` under
the checkout, which `ctypes` loads.  The library is rebuilt when the
sha256 of the sources and flags changes.  Nothing here runs at import
time: a CPU-only host imports every module of the port without a
compiler.

Each C entry point launches on the stream it is given (the wrapper passes
`torch.cuda.current_stream().cuda_stream`) and returns
`cudaGetLastError()`; `check()` raises on a non-zero code.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it; a
wrapper adds one right where it launches and nowhere else.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"rank": 0, "compact": 0, "segstats": 0}

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
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
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
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
