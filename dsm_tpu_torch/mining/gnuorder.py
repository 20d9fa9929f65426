"""Byte-exact reader ordering: a model of libstdc++ unordered_set<unsigned>
(the port's copy of dsm_tpu/mining/gnuorder.py).

The reference metaserver iterates `readerset` — `unordered_set<unsigned>`
(metaserver.cpp:23) — when accumulating the entropy sum and printing the
"id:occs" pairs (metaserver.cpp:366-388,478-484).  The iteration order of a
libstdc++ hashtable depends on its full insert/rehash history, so byte-exact
output parity requires replaying that history.

`GnuHashSet` models exactly the subset of _Hashtable behaviour these sets
exercise (std::hash<unsigned> = identity, _Prime_rehash_policy with
max_load_factor 1.0, unique keys, no erases):

  * bucket index = key % bucket_count;
  * insert into a non-empty bucket places the node at the bucket's head
    (before the bucket's current first node in the global singly-linked
    list); insert into an empty bucket prepends to the whole list;
  * rehash re-inserts nodes in current iteration order into the new
    bucket array with the same placement rule;
  * bucket growth under one-at-a-time insertion follows the doubling
    prime sequence 13, 29, 59, ... (extracted from g++'s libstdc++ and
    differentially tested against a real unordered_set<unsigned> in
    tests/test_gnuorder.py via tests/cpp/uset_oracle.cpp).

`GnuOrderTracker` replays the traversal of the reference server
(metaserver.cpp:269-345) over the union trie to recover, per node, the
iteration order of its `treaders` set:

  * The root set is built by inserting 0..d-1 ascending
    (metaserver.cpp:735-738).
  * Nodes at depth <= server_prefix_len sit on the clients' enforced path
    (nextEnforced emits exactly one child per node,
    EnumerateQuery.cpp:240-290), so their reader set is built in a single
    readChildren round: a scan of the parent's order inserting every
    reader active in the child (metaserver.cpp:159-189).  The default
    server_prefix_len=1 models the production topology of one server per
    depth-1 DNA prefix (wrapper-SLURM/example-server.sh).
  * Deeper nodes follow the traverse() round structure: each round scans
    the set of readers that just finished a subtree (`atr`) and inserts
    each reader's next child symbol; the lexicographically smallest
    non-empty child set is recursed into and cleared
    (metaserver.cpp:322-339).  Because every reader emits its children in
    ascending A<C<G<T order (EnumerateQuery.cpp:184) the per-node
    simulation is level-local: it needs only the per-reader child-symbol
    lists, which both mining engines already compute.

Entropy must be re-accumulated in the same order: IEEE addition is not
commutative-associative, and the reference adds
((double)(freq+1) * log(freq+1)) / log(2) terms in set-iteration order
(metaserver.cpp:378-379).  `entropy_for` mirrors that with C library
doubles (math.log is glibc log).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

# bucket counts reachable by one-at-a-time insertion, starting from the
# first rehash (insert #1 -> 13 buckets); frozen from g++ libstdc++ and
# verified by tests/test_gnuorder.py
_GROWTH = (13, 29, 59, 127, 257, 541, 1109, 2357, 5087, 10273, 20753,
           42043, 85229, 172933, 351061, 701819, 1254739)

LOG2 = math.log(2.0)


class GnuHashSet:
    """Iteration-order-exact model of libstdc++ unordered_set<unsigned>
    under unique one-at-a-time inserts (no erase — the reference only
    ever inserts and clears, metaserver.cpp:184,338).

    The nodes of a bucket stay contiguous in the list and a node goes to
    its bucket's head, so the bucket's first node is the last key inserted
    into it: the list is kept doubly linked (`nxt`, `prv`) with each
    bucket's first node (`first`), which makes an insert O(1) where a scan
    of the list for the bucket made it O(n)."""

    __slots__ = ("nbkt", "head", "nxt", "prv", "first", "_growth_i")

    def __init__(self) -> None:
        self.nbkt = 1
        self.head: int | None = None   # begin()
        self.nxt: dict[int, int | None] = {}
        self.prv: dict[int, int | None] = {}
        self.first: dict[int, int] = {}   # bucket -> its first node
        self._growth_i = -1          # index into _GROWTH, -1 = pre-rehash

    def insert(self, k: int) -> None:
        if k in self.nxt:
            return
        # _Prime_rehash_policy(mlf=1.0): rehash when n_elt+1 > bucket_count
        if len(self.nxt) + 1 > (self.nbkt if self._growth_i >= 0 else 0):
            self._growth_i += 1
            self._rehash(_GROWTH[self._growth_i])
        self._place(k)

    def _place(self, k: int) -> None:
        """_M_insert_bucket_begin (hashtable.h): head of the key's bucket,
        or head of the whole list when the bucket is empty."""
        b = k % self.nbkt
        nxt = self.first.get(b, self.head)
        prv = None if nxt is None or nxt == self.head else self.prv[nxt]
        self.nxt[k], self.prv[k] = nxt, prv
        if prv is None:
            self.head = k
        else:
            self.nxt[prv] = k
        if nxt is not None:
            self.prv[nxt] = k
        self.first[b] = k

    def _rehash(self, new_nbkt: int) -> None:
        old = self.order()
        self.nbkt = new_nbkt
        self.head, self.nxt, self.prv, self.first = None, {}, {}, {}
        for k in old:  # _M_rehash walks the list in iteration order
            self._place(k)

    def order(self) -> list[int]:
        out, k, nxt = [], self.head, self.nxt
        while k is not None:
            out.append(k)
            k = nxt[k]
        return out

    def __len__(self) -> int:
        return len(self.nxt)


def root_order(d: int) -> list[int]:
    """Iteration order of the server's initial reader set: insert 0..d-1
    ascending (metaserver.cpp:735-738)."""
    s = GnuHashSet()
    for i in range(d):
        s.insert(i)
    return s.order()


def simulate_node(order: Sequence[int],
                  child_syms: dict[int, Sequence[int]]) -> dict[int, list[int]]:
    """Replay traverse()'s readChildren rounds at one union-trie node.

    order: iteration order of this node's reader set; child_syms[r]:
    ascending child symbols reader r emits here.  Returns, per child
    symbol, the iteration order of its reader set at recursion time
    (metaserver.cpp:322-339).
    """
    ptr = dict.fromkeys(order, 0)
    sets: list[GnuHashSet | None] = [None, None, None, None]
    atr: Sequence[int] = order
    result: dict[int, list[int]] = {}
    while True:
        for r in atr:
            syms = child_syms.get(r)
            if syms is not None and ptr[r] < len(syms):
                c = syms[ptr[r]]
                ptr[r] += 1
                if sets[c] is None:
                    sets[c] = GnuHashSet()
                sets[c].insert(r)
        i = next((c for c in range(4) if sets[c]), None)
        if i is None:
            return result
        result[i] = sets[i].order()
        atr = result[i]
        sets[i] = None  # children[i].clear()


class GnuOrderTracker:
    """Per-level reader-order bookkeeping for the mining engines.

    Call advance(depth, paths, children) after emitting each level, where
    `children` lists the next level's nodes as (parent_index, symbol,
    active_bool_per_reader) in frontier order; query order_for/entropy_for
    while emitting.
    """

    def __init__(self, d: int, server_prefix_len: int = 1) -> None:
        self.d = d
        self.server_prefix_len = server_prefix_len
        self.orders: dict[bytes, list[int]] = {b"": root_order(d)}

    def order_for(self, path: bytes) -> list[int]:
        return self.orders[path]

    def entropy_for(self, path: bytes, freq: np.ndarray, d: int) -> float:
        """metaserver.cpp:356-389 with the set-iteration accumulation
        order; freq is the (S,) per-reader occurrence row."""
        sumN = float(d + int(freq.sum()))
        sumNlogN = 0.0
        for r in self.orders[path]:
            f1 = float(int(freq[r]) + 1)
            sumNlogN += (f1 * math.log(f1)) / LOG2
        return math.log(sumN) / LOG2 - sumNlogN / sumN

    def advance(
        self,
        depth: int,
        paths: Sequence[bytes],
        children: Iterable[tuple[int, int, np.ndarray]],
    ) -> None:
        """Compute the next level's orders from this level's.

        depth: current level depth; paths: this level's node paths;
        children: (parent_index, symbol 0..3, (S,) active mask) per next-
        level node, in (parent, symbol)-ascending frontier order.
        """
        from ..index.alphabet import EXT_CHARS

        by_parent: dict[int, list[tuple[int, np.ndarray]]] = {}
        for u, c, act in children:
            by_parent.setdefault(u, []).append((c, act))

        next_orders: dict[bytes, list[int]] = {}
        single_round = depth < self.server_prefix_len
        for u, kids in by_parent.items():
            path = paths[u]
            order = self.orders[path]
            if single_round:
                # enforced-path node: one readChildren round per child
                for c, act in kids:
                    s = GnuHashSet()
                    for r in order:
                        if act[r]:
                            s.insert(r)
                    next_orders[path + EXT_CHARS[c:c + 1]] = s.order()
            else:
                child_syms: dict[int, list[int]] = {}
                for c, act in kids:
                    for r in np.flatnonzero(act):
                        child_syms.setdefault(int(r), []).append(c)
                sim = simulate_node(order, child_syms)
                for c, sub in sim.items():
                    next_orders[path + EXT_CHARS[c:c + 1]] = sub
        self.orders = next_orders
