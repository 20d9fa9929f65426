"""Interop client: stream a sample's suffix-trie to reference metaservers.

The port's copy of dsm_tpu/net/client.py: host code on the port's own
FMIndex and NumPy engine helpers (mining/engine_np), no device.

Byte-compatible replacement for `metaenumerate` (metaenumerate.cpp:130-323):
loads one sample index, and per configured server streams the depth-first
serialized trie of the sample (fmin-pruned, optionally maxdepth-capped,
optionally restricted to the server's enforced prefix) over TCP, preceded
by the 'S' + libname + '.' session header.

Design difference from the reference: instead of a pointer-chasing DFS
with one HuffWT::rank per step (EnumerateQuery.cpp:151-238), the trie is
generated LEVEL-SYNCHRONOUSLY with the same batched wavefront expansion
the mining engines use, then the DFS bracket sequence the wire format
needs is *computed* — subtree sizes bottom-up, event offsets top-down,
all vectorized — and handed to the native encoder.  The byte stream is
identical (differentially tested against metaenumerate's own output in
tests/test_interop.py, and the port's against dsm_tpu's in
tests/test_torch_net.py), including the followOneBranch freq=1 quirk
(EnumerateQuery.cpp:105-149: the unary fast lane is only reachable for
singleton intervals, where freq == 1 holds anyway) and the depth<=6
checksum trail.
"""

from __future__ import annotations

import socket
import sys
import threading

import numpy as np

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..mining.engine_np import _Level, _expand, _seed_root, leftchar_np
from .native import native_encode
from .wire import CLOSE, OPEN, encode_events, encode_header

LC_BYTES = np.frombuffer(b"0NACGT", dtype=np.uint8)  # engine lc codes -> wire
SYM_BYTES = np.frombuffer(EXT_CHARS, dtype=np.uint8)
UNLIMITED_DEPTH = (1 << 62)


def enumerate_levels(index: FMIndex, fmin: int,
                     maxdepth: int = UNLIMITED_DEPTH,
                     enforcepath: bytes = b""):
    """Per-level node arrays of one sample's fmin-pruned suffix trie.

    -> list of dicts {parent, sym, freq, lc} for depths 1..L, rows sorted
    by (parent, sym).  Semantics of EnumerateQuery::enumerate with
    nextEnforced prefix descent (EnumerateQuery.cpp:240-290): enforced
    nodes are emitted like any other, only their siblings are skipped.
    """
    levels = []
    level = _seed_root([index])
    depth = 0
    while level.lo.shape[0]:
        if depth >= maxdepth:
            break
        clo, chi, crlo, cfreq, cactive, _lc = _expand([index], level, fmin)
        union_child = cactive.any(axis=2)  # (4, U)
        if depth < len(enforcepath):
            want = EXT_CHARS.index(enforcepath[depth])
            mask = np.zeros_like(union_child)
            mask[want] = union_child[want]
            union_child = mask
        u_idx, ci_idx = np.nonzero(union_child.T)  # sorted by (parent, sym)
        if u_idx.size == 0:
            break
        keep = cactive[ci_idx, u_idx]
        nxt = _Level(
            paths=[],  # paths not needed; DFS is reconstructed from parents
            lo=np.where(keep, clo[ci_idx, u_idx], 0),
            hi=np.where(keep, chi[ci_idx, u_idx], 0),
            rlo=np.where(keep, crlo[ci_idx, u_idx], 0),
        )
        freq = (nxt.hi - nxt.lo)[:, 0]
        levels.append(dict(
            parent=u_idx.astype(np.int64),
            sym=ci_idx.astype(np.int8),
            freq=freq.astype(np.int64),
            lc=leftchar_np(index, nxt.rlo[:, 0], freq).astype(np.int8),
        ))
        level = nxt
        depth += 1
    return levels


def levels_to_events(levels):
    """DFS bracket sequence from per-level arrays, fully vectorized.

    A node with subtree size sz occupies event slots [o, o + 2*sz): its
    open at o, children consecutively after, its close at o + 2*sz - 1.
    Subtree sizes flow bottom-up (np.add.at onto parents); open offsets
    flow top-down (per-parent exclusive cumsum of sibling sizes).
    -> (types, syms, freqs) uint8/uint8/uint64 arrays for the encoder.
    """
    L = len(levels)
    if L == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                np.zeros(0, np.uint64))
    sz = [np.ones(lv["parent"].shape[0], dtype=np.int64) for lv in levels]
    for l in range(L - 1, 0, -1):
        np.add.at(sz[l - 1], levels[l]["parent"], sz[l])

    opens = []
    for l in range(L):
        parent = levels[l]["parent"]
        # exclusive cumsum of sibling subtree sizes within each parent group
        csz = np.concatenate([[0], np.cumsum(2 * sz[l])[:-1]])
        # subtract each parent group's starting offset
        group_start = np.concatenate(
            [[True], parent[1:] != parent[:-1]]) if parent.size else \
            np.zeros(0, dtype=bool)
        base = np.where(group_start, csz, 0)
        np.maximum.accumulate(base, out=base)
        within = csz - base
        if l == 0:
            o = 1 + within  # after nothing: root children start at slot 0
            o -= 1
        else:
            o = opens[l - 1][parent] + 1 + within
        opens.append(o)

    total = 2 * sum(lv["parent"].shape[0] for lv in levels)
    types = np.empty(total, dtype=np.uint8)
    syms = np.empty(total, dtype=np.uint8)
    freqs = np.zeros(total, dtype=np.uint64)
    for l in range(L):
        o = opens[l]
        c = o + 2 * sz[l] - 1
        types[o] = OPEN
        syms[o] = SYM_BYTES[levels[l]["sym"]]
        types[c] = CLOSE
        syms[c] = LC_BYTES[levels[l]["lc"]]
        freqs[c] = levels[l]["freq"].astype(np.uint64)
    return types, syms, freqs


def serialize_trie(index: FMIndex, fmin: int,
                   maxdepth: int = UNLIMITED_DEPTH,
                   enforcepath: bytes = b"") -> tuple[bytes, int]:
    """-> (wire bytes for one (sample, server) stream sans header, nodes)."""
    levels = enumerate_levels(index, fmin, maxdepth, enforcepath)
    types, syms, freqs = levels_to_events(levels)
    enc = native_encode(types, syms, freqs)
    if enc is None:
        enc = encode_events(types, syms, freqs)
    return enc[0], len(types) // 2


def stream_sample(host: str, port: int, libname: str, index: FMIndex,
                  fmin: int, maxdepth: int = UNLIMITED_DEPTH,
                  enforcepath: bytes = b"", chunk: int = 16 * 1024) -> int:
    """Connect, send header + trie, close.  -> number of nodes sent.

    16 KiB write chunks match ClientSocket's buffer (ClientSocket.h:82);
    TCP backpressure from a lazy server throttles us exactly as it does
    the reference client.
    """
    payload, n_nodes = serialize_trie(index, fmin, maxdepth, enforcepath)
    with socket.create_connection((host, port)) as sock:
        sock.sendall(encode_header(libname))
        for off in range(0, len(payload), chunk):
            sock.sendall(payload[off:off + chunk])
    return n_nodes


def run_client(index: FMIndex, libname: str, hostinfos, fmin: int = 10,
               maxdepth: int = UNLIMITED_DEPTH, verbose: bool = False) -> int:
    """One thread per server, as metaenumerate's OpenMP loop
    (metaenumerate.cpp:268-309).  hostinfos: [(host, port, enforcepath)].
    -> total nodes sent."""
    totals = [0] * len(hostinfos)
    errors: list[BaseException] = []

    def work(i, host, port, enforce):
        try:
            if verbose:
                print(f"{i}: connecting to {host}:{port} \"{enforce}\"",
                      file=sys.stderr)
            totals[i] = stream_sample(
                host, int(port), libname, index, fmin, maxdepth,
                enforce.encode() if isinstance(enforce, str) else enforce)
        except BaseException as e:  # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i, *hi), daemon=True)
               for i, hi in enumerate(hostinfos)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return sum(totals)
