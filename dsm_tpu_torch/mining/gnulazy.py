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

A `profile` dict (utils/trace.py) takes the tracker's host seconds
(`gnu_s`: the reconstruction and the entropy sums, each second once), the
nodes it expanded (`gnu_nodes`) and the lines whose order it answered
(`gnu_lines`, one an `order_for` call).
"""

from __future__ import annotations

import math

import numpy as np

from ..index.alphabet import EXT_CHARS, EXT_CODES
from ..index.fmindex import FMIndex
from ..utils.trace import count, timed
from .gnuorder import LOG2, GnuHashSet, root_order, simulate_node


def _occ_psum4_rows(cum: np.ndarray, pos: np.ndarray):
    """engine_np._occ_psum4 on rows already read: cum (S, 5) = the dense
    counts cum(1..5) at each sample's `pos` -> (occ4, psum4), each (4, S)
    (occ(A) = cum2-cum1, occ(C) = cum3-cum2, occ(G) = cum4-cum3, occ(T) =
    pos-cum5; psum = cum1, cum2, cum3, cum5)."""
    c = cum.T
    occ4 = np.stack([c[1] - c[0], c[2] - c[1], c[3] - c[2], pos - c[4]])
    return occ4, np.stack([c[0], c[1], c[2], c[4]])


class LazyGnuOrder:
    """Gnu set-iteration orders for queried paths only (see module doc).

    server_prefix_len follows GnuOrderTracker: nodes at depth strictly
    below it sit on the clients' enforced path, where each child's set is
    built in a single readChildren scan of the parent's order
    (metaserver.cpp:159-189); deeper nodes replay the traverse() round
    structure (metaserver.cpp:322-339).
    """

    def __init__(self, indexes: list[FMIndex], fmin: int, d: int,
                 server_prefix_len: int = 1,
                 profile: dict | None = None) -> None:
        self.indexes = indexes
        self.profile = profile
        self.fmin = fmin
        self.d = d
        self.server_prefix_len = server_prefix_len
        S = len(indexes)
        lo = np.zeros(S, dtype=np.int64)
        hi = np.array([idx.n for idx in indexes], dtype=np.int64)
        rlo = np.zeros(S, dtype=np.int64)
        self._iv: dict[bytes, tuple] = {b"": (lo, hi, rlo)}
        # C[c] of each extension symbol c and sample: (4, S)
        self._base = np.array([[int(idx.C[c]) for idx in indexes]
                               for c in EXT_CODES], dtype=np.int64)
        self.orders: dict[bytes, list[int]] = {b"": root_order(d)}

    # -- tracker interface -------------------------------------------------
    def order_for(self, path: bytes) -> list[int]:
        count(self.profile, "gnu_lines", 1)
        return timed(self.profile, "gnu_s", self._order, path)

    def entropy_for(self, path: bytes, freq: np.ndarray, d: int) -> float:
        return timed(self.profile, "gnu_s", self._entropy, path, freq, d)

    def advance(self, *args, **kwargs) -> None:
        """No-op: orders are reconstructed from the index on demand."""

    # -- reconstruction ----------------------------------------------------
    def _order(self, path: bytes) -> list[int]:
        order = self.orders.get(path)
        if order is None:
            self._extend(path)
            order = self.orders[path]
        return order

    def _entropy(self, path: bytes, freq: np.ndarray, d: int) -> float:
        """metaserver.cpp:356-389 in set-iteration accumulation order."""
        sumN = float(d + int(freq.sum()))
        sumNlogN = 0.0
        for r in self._order(path):
            f1 = float(int(freq[r]) + 1)
            sumNlogN += (f1 * math.log(f1)) / LOG2
        return math.log(sumN) / LOG2 - sumNlogN / sumN

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
        intervals and set order.  A sample's two dense-count rows are read
        in the loop; the rank arithmetic is done for all samples at once
        (engine_np._occ_psum4's, column by column)."""
        count(self.profile, "gnu_nodes", 1)
        lo, hi, rlo = self._iv[ppath]
        S = len(self.indexes)
        live = hi > lo
        cum_lo = np.zeros((S, 5), dtype=np.int64)
        cum_hi = np.zeros((S, 5), dtype=np.int64)
        for s in np.flatnonzero(live).tolist():
            dcum = self.indexes[s].dcum
            cum_lo[s] = dcum[lo[s]]
            cum_hi[s] = dcum[hi[s]]
        occ_lo, psum_lo = _occ_psum4_rows(cum_lo, lo)
        occ_hi, psum_hi = _occ_psum4_rows(cum_hi, hi)
        clo = np.where(live, self._base + occ_lo, 0)
        chi = np.where(live, self._base + occ_hi, 0)
        crlo = np.where(live, rlo + psum_hi - psum_lo, 0)
        cfreq = np.maximum(chi - clo, 0)
        cact = live[None, :] & (cfreq >= self.fmin)   # (4, S)

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
