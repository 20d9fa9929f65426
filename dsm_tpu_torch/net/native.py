"""On-demand build + ctypes bindings for the native trie-stream codec.

The port's copy of dsm_tpu/net/native.py.  Compiles net/_trieio.cpp with
the system g++ the first time it is needed (sub-second) into the
gitignored `build/net/` under the checkout, beside the CUDA kernels'
`build/kernels/`, named by the source's hash, and exposes NativeTrieParser
/ native_encode with the exact interface semantics of the pure-Python
codec in net/wire.py.  Without a compiler `get_lib()` is None and callers
use wire.TrieParser and wire.encode_events.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .wire import CLOSE, OPEN, StreamError, TrieParser

_SRC = Path(__file__).resolve().with_name("_trieio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "net"
CXX = "g++"
_lib = None
_lib_tried = False


class _TrieState(ctypes.Structure):
    _fields_ = [
        ("depth", ctypes.c_uint64),
        ("n", ctypes.c_uint64),
        ("err", ctypes.c_int32),
        ("errmsg", ctypes.c_char * 256),
    ]


def _build() -> str | None:
    """The shared library's path, compiled when missing; None when the
    compiler is missing or fails.  Processes that start together each
    compile into a temporary file and rename it into place."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sopath = BUILD_DIR / f"_trieio-{tag}.so"
    if sopath.exists():
        return str(sopath)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([CXX, "-O3", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, sopath)
        return str(sopath)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get_lib():
    """The loaded codec library, built at the first call; None without a
    compiler."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    sopath = _build()
    if sopath is None:
        return None
    lib = ctypes.CDLL(sopath)
    lib.trie_parse.restype = ctypes.c_int64
    lib.trie_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_TrieState),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.trie_encode.restype = ctypes.c_int64
    lib.trie_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeTrieParser:
    """Drop-in for wire.TrieParser backed by the C++ batch parser."""

    def __init__(self) -> None:
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("the native trie codec could not be built")
        self._st = _TrieState(0, 0, 0, b"")
        self._tail = b""

    @property
    def depth(self) -> int:
        return self._st.depth

    @property
    def n(self) -> int:
        return self._st.n

    @property
    def pending(self) -> int:
        return len(self._tail)

    def _parse(self, data: bytes, max_events: int | None):
        """Parse the held tail and `data` -> (types, syms, freqs) of the
        events, the unparsed bytes kept for the next call."""
        buf = self._tail + data
        cap = max(len(buf), 16)
        if max_events is not None:
            cap = min(cap, max_events)
        types = np.empty(cap, dtype=np.uint8)
        syms = np.empty(cap, dtype=np.uint8)
        freqs = np.empty(cap, dtype=np.uint64)
        consumed = ctypes.c_int64(0)
        nev = self._lib.trie_parse(
            buf, len(buf), ctypes.byref(self._st), _u8(types), _u8(syms),
            freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cap, ctypes.byref(consumed))
        if self._st.err:
            raise StreamError(self._st.errmsg.decode())
        self._tail = buf[consumed.value:]
        return types[:nev], syms[:nev], freqs[:nev]

    def feed(self, data: bytes, max_events: int | None = None):
        """-> list of events: (OPEN, sym_byte) | (CLOSE, freq, leftchar)."""
        types, syms, freqs = self._parse(data, max_events)
        events = []
        for i in range(types.shape[0]):
            if types[i] == 0:
                events.append((OPEN, int(syms[i])))
            else:
                events.append((CLOSE, int(freqs[i]), int(syms[i])))
        return events

    def feed_arrays(self, data: bytes):
        """The events of `feed` as arrays, with no Python loop: -> (types
        uint8 (0 open, 1 close), syms uint8 (the symbol of an open, the
        leftChar of a close), freqs uint64 (a close's frequency))."""
        types, syms, freqs = self._parse(data, None)
        return types.copy(), syms.copy(), freqs.copy()


def native_encode(types: np.ndarray, syms: np.ndarray, freqs: np.ndarray,
                  start_n: int = 0, start_depth: int = 0):
    """C++ twin of wire.encode_events -> (bytes, n, depth), or None if no
    native lib."""
    lib = get_lib()
    if lib is None:
        return None
    types = np.ascontiguousarray(types, dtype=np.uint8)
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    freqs = np.ascontiguousarray(freqs, dtype=np.uint64)
    out = np.empty(max(len(types), 1) * 21, dtype=np.uint8)
    n = ctypes.c_uint64(start_n)
    depth = ctypes.c_uint64(start_depth)
    written = lib.trie_encode(
        _u8(types), _u8(syms),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(types),
        _u8(out), ctypes.byref(n), ctypes.byref(depth))
    return out[:written].tobytes(), n.value, depth.value


def make_parser():
    """Best parser available: native if a toolchain exists, else pure."""
    if get_lib() is not None:
        return NativeTrieParser()
    return TrieParser()


def codec_name() -> str:
    """Which codec this process runs: "native (<library>)" or "pure
    Python (wire.py)"."""
    if get_lib() is None:
        return "pure Python (wire.py)"
    return f"native ({Path(get_lib()._name).name})"
