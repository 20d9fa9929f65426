"""Post-hoc gnu reader-order reconstruction for the episode engine (the
port's copy of dsm_tpu/mining/gnulazy.py).

The per-level `GnuOrderTracker` (mining/gnuorder.py) must watch every
frontier level, which only the per-level engines materialize on the
host.  The device-resident episode (mining/engine_device.py) never pulls
levels — it drains a handful of gated output nodes — so byte-exact gnu ordering there needs a different
shape: reconstruct each emitted node's libstdc++ set-iteration order
ON DEMAND by re-walking its ancestor chain in the FM-indexes.

A node's reader-set order depends only on (a) its parent's order and
(b) the per-reader child-symbol lists at the parent (which of the
parent's four children each reader is active in: interval nonempty and
frequency >= fmin, the client-side pruning of EnumerateQuery.cpp:186-190
merged at the server per metaserver.cpp:159-189,322-339).  Both are
recomputable for ONE path with O(depth * S) host rank queries — gated
outputs are sparse (hundreds of lines in production configs), so total
reconstruction cost is O(emitted * depth * S), independent of trie size.

Drop-in for the tracker interface the emitters use (`order_for`,
`entropy_for`, `advance`): `advance` is a no-op because orders are
derived from the index, not from watching levels.
"""

from __future__ import annotations

import math

import numpy as np

from ..index.fmindex import FMIndex
from .engine_np import _occ_psum4
from .gnuorder import LOG2, GnuHashSet, root_order, simulate_node


class LazyGnuOrder:
    """Gnu set-iteration orders for queried paths only (see module doc).

    server_prefix_len follows GnuOrderTracker: nodes at depth strictly
    below it sit on the clients' enforced path, where each child's set is
    built in a single readChildren scan of the parent's order
    (metaserver.cpp:159-189); deeper nodes replay the traverse() round
    structure (metaserver.cpp:322-339).
    """

    def __init__(self, indexes: list[FMIndex], fmin: int, d: int,
                 server_prefix_len: int = 1) -> None:
        self.indexes = indexes
        self.fmin = fmin
        self.d = d
        self.server_prefix_len = server_prefix_len
        S = len(indexes)
        lo = np.zeros(S, dtype=np.int64)
        hi = np.array([idx.n for idx in indexes], dtype=np.int64)
        rlo = np.zeros(S, dtype=np.int64)
        self._iv: dict[bytes, tuple] = {b"": (lo, hi, rlo)}
        self.orders: dict[bytes, list[int]] = {b"": root_order(d)}

    # -- tracker interface -------------------------------------------------
    def order_for(self, path: bytes) -> list[int]:
        order = self.orders.get(path)
        if order is None:
            self._extend(path)
            order = self.orders[path]
        return order

    def entropy_for(self, path: bytes, freq: np.ndarray, d: int) -> float:
        """metaserver.cpp:356-389 in set-iteration accumulation order."""
        sumN = float(d + int(freq.sum()))
        sumNlogN = 0.0
        for r in self.order_for(path):
            f1 = float(int(freq[r]) + 1)
            sumNlogN += (f1 * math.log(f1)) / LOG2
        return math.log(sumN) / LOG2 - sumNlogN / sumN

    def advance(self, *args, **kwargs) -> None:
        """No-op: orders are reconstructed from the index on demand."""

    # -- reconstruction ----------------------------------------------------
    def _extend(self, path: bytes) -> None:
        """Expand cached ancestors down to `path` (root is always cached)."""
        k = len(path)
        i = k
        while path[:i] not in self.orders:
            i -= 1
        for j in range(i, k):
            self._expand_node(path[:j])
            if path[:j + 1] not in self.orders:
                raise KeyError(
                    f"gnu order requested for non-existent trie node "
                    f"{path!r} (missing child at depth {j})")

    def _expand_node(self, ppath: bytes) -> None:
        """One 4-way LF expansion of node `ppath`: caches every child's
        intervals and set order."""
        from ..index.alphabet import EXT_CHARS, EXT_CODES

        lo, hi, rlo = self._iv[ppath]
        S = len(self.indexes)
        clo = np.zeros((4, S), dtype=np.int64)
        chi = np.zeros((4, S), dtype=np.int64)
        crlo = np.zeros((4, S), dtype=np.int64)
        for s, idx in enumerate(self.indexes):
            if hi[s] <= lo[s]:
                continue
            occ_lo, psum_lo = _occ_psum4(idx.dcum, lo[s:s + 1])
            occ_hi, psum_hi = _occ_psum4(idx.dcum, hi[s:s + 1])
            for ci, c in enumerate(EXT_CODES):
                base = int(idx.C[c])
                clo[ci, s] = base + occ_lo[0, ci]
                chi[ci, s] = base + occ_hi[0, ci]
                crlo[ci, s] = rlo[s] + psum_hi[0, ci] - psum_lo[0, ci]
        cfreq = np.maximum(chi - clo, 0)
        cact = (hi > lo)[None, :] & (cfreq >= self.fmin)   # (4, S)

        order = self.orders[ppath]
        depth = len(ppath)
        if depth < self.server_prefix_len:
            # enforced-path node: one readChildren round per child
            for ci in range(4):
                if not cact[ci].any():
                    continue
                s = GnuHashSet()
                for r in order:
                    if cact[ci, r]:
                        s.insert(r)
                self._cache_child(ppath, ci, s.order(), clo, chi, crlo,
                                  cact, EXT_CHARS)
        else:
            child_syms: dict[int, list[int]] = {}
            for ci in range(4):
                for r in np.flatnonzero(cact[ci]):
                    child_syms.setdefault(int(r), []).append(ci)
            for ci, sub in simulate_node(order, child_syms).items():
                self._cache_child(ppath, ci, sub, clo, chi, crlo, cact,
                                  EXT_CHARS)

    def _cache_child(self, ppath, ci, order, clo, chi, crlo, cact,
                     ext_chars) -> None:
        cpath = ppath + ext_chars[ci:ci + 1]
        keep = cact[ci]
        self.orders[cpath] = order
        self._iv[cpath] = (np.where(keep, clo[ci], 0),
                           np.where(keep, chi[ci], 0),
                           np.where(keep, crlo[ci], 0))
