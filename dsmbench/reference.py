"""The benchmark's plain reference miner, in PyTorch and NumPy.

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's FASTA files itself, builds its own index, and mines
the union trie with the semantics of the reference framework's
`metaenumerate` + `metaserver` pair:

  * sample s's texts: each record's sequence, upper-cased with every byte
    outside ACGT turned into N, followed by '-' and its reverse complement;
  * a node is a string p over ACGT; sample s is active at p when p occurs
    at least fmin times in its texts; p is in the trie when some sample is
    active at it and every proper prefix is (an enforced prefix allows only
    its own symbol at each of its depths); the root is not a node;
  * every node counts as a path; its entropy is
    log2(S) - sum_s (f_s + 1) log2(f_s + 1) / S, S = d + sum_s f_s, over
    the active samples' counts f_s (metaserver.cpp:356-389), with the
    reference's own expression shapes;
  * a node is printed when at least pmin (and at most pmax, if set) samples
    are active, emin <= entropy <= emax, it is right-branching (not exactly
    one child symbol into which every active sample descends) and
    left-branching (the active samples do not all see one base before
    every occurrence; metaserver.cpp:403-419).

The index is plain: a suffix array by prefix doubling (`torch.sort`) over
each sample's reversed texts, its BWT's cumulative base counts as a dense
(n + 1, 4) table, and backward search, which appends a symbol to p; the
base before p's occurrences is read by binary search over the suffix
array.  The level loop runs on whatever device the tensors are on;
entropies that decide a printed line are recomputed on the host in
`dtype` (float64 as the configuration states; the control passes
float32), summed in the job's reader order:

  * "ascending": each line's `id:occs` and its entropy's sum in ascending
    sample order;
  * "gnu": in the order the reference server iterates the node's
    `treaders`, a libstdc++ `unordered_set<unsigned>` (metaserver.cpp:23,
    :366-388, :478-484): `GnuSet` models that set and `gnu_orders`
    replays how the server fills it, for the printed nodes only.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field

import numpy as np
import torch

# symbol codes in ASCII order; terminators take ranks below all of them
SEP, A, C, G, N, T = 1, 2, 3, 4, 5, 6
BASE_CODES = (A, C, G, T)
CODE_CHAR = np.frombuffer(b"\x00-ACGNT", dtype=np.uint8)
# byte -> code after the normalisation (upper case; anything else is N)
BYTE_CODE = np.full(256, N, dtype=np.int8)
for _b, _c in zip(b"ACGTacgt", (A, C, G, T, A, C, G, T)):
    BYTE_CODE[_b] = _c
BYTE_CODE[ord("-")] = N   # a '-' in the input is not the separator
COMPLEMENT = np.array([0, SEP, T, G, C, N, A], dtype=np.int8)
# slack of the device's entropy gate; the host re-gates exactly
GATE_MARGIN = 1e-3
READER_ORDERS = ("ascending", "gnu")
# libstdc++'s bucket counts (src/shared/hashtable-aux.cc `__prime_list`,
# its entries up to the sets the reference's 273 readers can fill, and
# _Prime_rehash_policy::_M_next_bkt's `__fast_bkt` for small requests)
PRIME_LIST = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
              59, 61, 67, 71, 73, 79, 83, 89, 97, 103, 109, 113, 127, 137,
              139, 149, 157, 167, 179, 193, 199, 211, 227, 241, 257, 277,
              293, 313, 337, 359, 383, 409, 439, 467, 503, 541, 577, 619,
              661, 709, 761, 823, 887, 953, 1031, 1109)
FAST_BKT = (2, 2, 2, 3, 5, 5, 7, 7, 11, 11, 11, 11, 13, 13)


def fasta_records(path: str) -> list[bytes]:
    """The sequences of a FASTA file: the lines after each '>' header
    joined, records with no sequence dropped."""
    with open(path, "rb") as f:
        data = f.read()
    records, cur = [], []
    for line in data.split(b"\n"):
        if line[:1] == b">":
            if cur:
                records.append(b"".join(cur))
            cur = []
        else:
            cur.append(line)
    if cur and b"".join(cur):
        records.append(b"".join(cur))
    return [r for r in records if r]


def sample_codes(records: list[bytes], device="cpu"):
    """A sample's index text on `device`: for each record, the reverse of
    (sequence '-' reverse complement), that is (complement '-' reversed
    sequence), then a terminator; -> (codes int8 with terminators 0, the
    terminators' positions int64)."""
    lens = torch.tensor([len(r) for r in records], dtype=torch.int64,
                        device=device)
    raw = np.frombuffer(b"".join(records), dtype=np.uint8)
    fwd = torch.from_numpy(BYTE_CODE[raw]).to(device)
    size = 2 * lens + 2
    starts = torch.cumsum(size, 0) - size
    rec = torch.repeat_interleave(torch.arange(lens.numel(), device=device),
                                  lens)
    off = torch.arange(fwd.numel(), device=device) - (
        torch.cumsum(lens, 0) - lens)[rec]
    out = torch.empty(int(size.sum()), dtype=torch.int8, device=device)
    out[starts[rec] + off] = torch.from_numpy(COMPLEMENT).to(device)[
        fwd.to(torch.int64)]
    out[starts + lens] = SEP
    out[starts[rec] + 2 * lens[rec] - off] = fwd
    ends = starts + 2 * lens + 1
    out[ends] = 0
    return out, ends


def suffix_array(codes: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Suffix array of `codes` (int8, terminators 0 at `ends`, each
    terminator ranked by its position below every symbol) by prefix
    doubling: sort by (rank of i, rank of i + k), k = 1, 2, 4, ... until
    every rank differs."""
    n = codes.shape[0]
    x = codes.to(torch.int64) + ends.shape[0]
    x[ends] = torch.arange(ends.shape[0], device=codes.device)
    _, rank = torch.unique(x, return_inverse=True)
    k = 1
    while True:
        second = torch.zeros_like(rank)
        if k < n:
            second[:n - k] = rank[k:] + 1
        key = rank * (n + 1) + second
        skey, order = torch.sort(key)
        new = torch.zeros_like(rank)
        new[1:] = torch.cumsum(skey[1:] != skey[:-1], 0)
        rank = torch.empty_like(rank)
        rank[order] = new
        if int(new[-1]) == n - 1:
            return order
        k *= 2


@dataclass
class RefIndex:
    """All samples' plain indexes, concatenated on one device.

    x: the samples' texts (int8 codes) end to end, sample s from xoff[s];
    sa: each sample's suffix array (positions within the sample), sample s
    from xoff[s]; occ: each sample's (n_s + 1, 4) cumulative counts of
    A, C, G, T in its BWT, sample s from ooff[s]; cbase: (S, 4) the count
    of the sample's symbols below each base; n: (S,) text lengths."""

    x: torch.Tensor
    sa: torch.Tensor
    occ: torch.Tensor
    cbase: torch.Tensor
    xoff: torch.Tensor
    ooff: torch.Tensor
    n: np.ndarray

    @property
    def d(self) -> int:
        return int(self.n.shape[0])

    @classmethod
    def from_fasta(cls, paths: list[str], device) -> "RefIndex":
        xs, sas, occs, cbs, ns = [], [], [], [], []
        for p in paths:
            codes, ends = sample_codes(fasta_records(p), device)
            sa = suffix_array(codes, ends)
            prev = torch.where(sa > 0, sa - 1, torch.full_like(sa, len(codes) - 1))
            bwt = codes[prev]
            hot = torch.stack([bwt == c for c in BASE_CODES], 1).to(torch.int32)
            occ = torch.zeros((len(codes) + 1, 4), dtype=torch.int32,
                              device=device)
            occ[1:] = torch.cumsum(hot, 0, dtype=torch.int32)
            # (a bincount over 7 bins serialises on the card's atomics)
            counts = torch.stack([(codes == c).sum() for c in range(7)])
            below = torch.cumsum(counts, 0) - counts     # symbols below code
            cbs.append(below[list(BASE_CODES)])
            xs.append(codes)
            sas.append(sa)
            occs.append(occ)
            ns.append(len(codes))
        xoff = np.concatenate([[0], np.cumsum(ns)[:-1]])
        ooff = xoff + np.arange(len(ns))
        return cls(x=torch.cat(xs), sa=torch.cat(sas), occ=torch.cat(occs),
                   cbase=torch.stack(cbs), xoff=torch.as_tensor(xoff, device=device),
                   ooff=torch.as_tensor(ooff, device=device),
                   n=np.asarray(ns, dtype=np.int64))


@dataclass
class RefOutput:
    """What a mining job reports: lines (path, entropy, [(sample, count)]
    in the job's reader order) in post-order, and the counters."""

    lines: list = field(default_factory=list)
    total_paths: int = 0
    total_output: int = 0
    total_occs: int = 0
    smallest_entropy: float = 1000.0
    largest_entropy: float = -1000.0
    freq_histogram: np.ndarray | None = None


def entropy_np(freq: np.ndarray, d: int, dtype=np.float64) -> np.ndarray:
    """metaserver.cpp:356-389 for (m, d) counts (0 for an inactive
    sample), summed over samples in ascending order:
    log(S)/log(2) - (sum_s ((f+1) * log(f+1)) / log(2)) / S."""
    log2 = np.log(dtype(2.0))
    f1 = freq.astype(dtype) + dtype(1.0)
    term = (f1 * np.log(f1)) / log2
    acc = np.zeros(freq.shape[0], dtype=dtype)
    for s in range(freq.shape[1]):
        acc = acc + term[:, s]
    total = (d + freq.sum(axis=1)).astype(dtype)
    return (np.log(total) / log2 - acc / total).astype(dtype)


class GnuSet:
    """libstdc++'s `std::unordered_set<unsigned>` as the reference server
    uses it (inserts, iteration; `std::hash<unsigned>` is the identity, the
    maximum load factor 1.0): `order` is its iteration order.

    The set is one singly linked list, each bucket's keys a run in it.  A
    key goes to bucket key % bucket count; inserted into a bucket that
    holds keys, it goes to the head of that bucket's run, and into an empty
    bucket, to the head of the whole list.  Before an insert that would
    pass the next resize, `_Prime_rehash_policy` picks a larger bucket
    count, and the keys are placed again one by one, in their iteration
    order, by the same rule."""

    def __init__(self, keys=()):
        self.order: list[int] = []
        self.head: dict[int, int] = {}      # bucket -> the key at its head
        self.nbkt = 1
        self.next_resize = 0
        for k in keys:
            self.insert(k)

    def insert(self, key: int) -> None:
        if key in self.order:
            return
        nbkt = self._need_rehash()
        if nbkt:
            old, self.order, self.head, self.nbkt = self.order, [], {}, nbkt
            for k in old:
                self._place(k)
        self._place(key)

    def _place(self, key: int) -> None:
        b = key % self.nbkt
        at = self.order.index(self.head[b]) if b in self.head else 0
        self.order.insert(at, key)
        self.head[b] = key

    def _need_rehash(self) -> int | None:
        """`_M_need_rehash(bucket_count, size, 1)`: the new bucket count,
        or None; a set that never held a key asks for 11 at least."""
        n = len(self.order) + 1
        if n <= self.next_resize:
            return None
        least = max(n, 0 if self.next_resize else 11)
        if least < self.nbkt:
            self.next_resize = self.nbkt
            return None
        return self._next_bkt(max(least + 1, 2 * self.nbkt))

    def _next_bkt(self, n: int) -> int:
        """`_M_next_bkt(n)`: the first of `__prime_list` not below n."""
        if n < len(FAST_BKT):
            self.next_resize = FAST_BKT[n]
            return FAST_BKT[n]
        i = bisect.bisect_left(PRIME_LIST, n)
        if i == len(PRIME_LIST):
            raise ValueError(f"a set of {n} buckets: more readers than the "
                             "reference server merges")
        self.next_resize = PRIME_LIST[i]
        return PRIME_LIST[i]


def replay_node(order: list[int], kids: dict) -> dict:
    """traverse()'s rounds at one node (metaserver.cpp:322-339).  order:
    the node's `treaders` in iteration order; kids[r]: the child symbols
    (0..3 for A, C, G, T) that reader r sends here, ascending.  Each round
    scans the readers that have just finished a subtree (the first, every
    reader) and inserts each into the set of its next child symbol; the
    smallest symbol's non-empty set is recursed into, then cleared.
    -> {symbol: that child's `treaders` in iteration order}."""
    pending = {r: iter(kids.get(r, ())) for r in order}
    sets: dict[int, GnuSet] = {}
    out = {}
    scan = order
    while True:
        for r in scan:
            c = next(pending[r], None)
            if c is not None:
                sets.setdefault(c, GnuSet()).insert(r)
        if not sets:
            return out
        c = min(sets)
        scan = out[c] = sets.pop(c).order


def gnu_orders(ix: "RefIndex", paths, fmin: int, enforced: int) -> dict:
    """The reference server's `treaders` order at each of `paths` (bytes
    over ACGT) and at every ancestor of them, where the clients enforce a
    prefix of `enforced` symbols (one server a depth-1 prefix for the
    whole trie, wrapper-SLURM/example-server.sh): -> {path: reader ids}.

    The root's set takes the readers 0..d-1 in ascending order
    (metaserver.cpp:735-739).  Down to depth `enforced` each reader sends
    the enforced child alone, so a child's set is one scan of its
    parent's order (readChildren, :159-189); below it, `replay_node`.  A
    reader sends the children it holds at least fmin times: backward
    search, a depth at a time over the ancestors of that depth, says
    which."""
    dev = ix.x.device
    need: dict[int, set] = {}       # depth -> the ancestors of that depth
    for p in paths:
        for i in range(1, len(p) + 1):
            need.setdefault(i, set()).add(p[:i])
    level = [b""]
    orders = {b"": GnuSet(range(ix.d)).order}
    lo = torch.zeros((1, ix.d), dtype=torch.int64, device=dev)
    hi = torch.as_tensor(ix.n, device=dev)[None]
    for depth in range(1, len(need) + 1):
        nxt = sorted(need[depth])
        # (nodes, samples, symbols): each child's interval in each sample
        obase = ix.ooff[None, :]
        clo = ix.cbase[None] + ix.occ[obase + lo].to(torch.int64)
        chi = ix.cbase[None] + ix.occ[obase + hi].to(torch.int64)
        held = ((chi - clo) >= fmin).cpu().numpy()
        at = {q: u for u, q in enumerate(level)}
        parent = [at[q[:-1]] for q in nxt]
        sym = [b"ACGT".index(q[-1]) for q in nxt]
        replayed: dict[int, dict] = {}
        for q, u, c in zip(nxt, parent, sym):
            up = orders[q[:-1]]
            if len(q) <= enforced:
                orders[q] = GnuSet(r for r in up if held[u, r, c]).order
                continue
            if u not in replayed:
                rows = held[u].tolist()
                replayed[u] = replay_node(up, {
                    r: [b for b in range(4) if rows[r][b]] for r in up})
            orders[q] = replayed[u][c]
        pi = torch.as_tensor(parent, device=dev)
        ci = torch.as_tensor(sym, device=dev)
        lo, hi = clo[pi, :, ci], chi[pi, :, ci]
        level = nxt
    return orders


def gnu_entropy(order, freq: np.ndarray, d: int, dtype=np.float64) -> float:
    """metaserver.cpp:369-389 in `order`: sumNlogN += ((double)(f+1) *
    log(f+1)) / log(2), reader by reader, then log(sumN)/log(2) -
    sumNlogN/sumN, sumN = d + sum f; in `dtype`, with the C library's log
    for doubles.  freq: the node's (d,) counts."""
    t = np.dtype(dtype).type
    log = math.log if t is np.float64 else np.log
    ln2 = log(t(2.0))
    acc = t(0.0)
    for r in order:
        f1 = t(freq[r] + 1)
        acc = acc + (f1 * log(f1)) / ln2
    total = t(d + freq.sum())
    return float(log(total) / ln2 - acc / total)


def _next_base_counts(ix: RefIndex, sid, lo, hi, depth) -> torch.Tensor:
    """(K, 4) counts of A, C, G, T right after p's reversal in the sample
    texts (that is, right before p in the sample), over suffix-array rows
    [lo, hi) of sample `sid`, which all start with p reversed (p of length
    `depth`): a binary search a code for the first row whose next symbol
    reaches it."""
    codes = torch.tensor([A, C, G, N, T, T + 1], device=lo.device)
    sbase = ix.xoff[sid][:, None]
    lo6, hi6 = lo[:, None].expand(-1, 6), hi[:, None].expand(-1, 6)
    left, right = lo6.clone(), hi6.clone()
    for _ in range(int((hi - lo).max()).bit_length() + 1):
        open_ = left < right
        mid = torch.where(open_, (left + right) // 2, lo6)
        nxt = ix.x[sbase + ix.sa[sbase + mid] + depth[:, None]]
        below = nxt.to(torch.int64) < codes
        left = torch.where(open_ & below, mid + 1, left)
        right = torch.where(open_ & ~below, mid, right)
    b = left
    return torch.stack([b[:, 1] - b[:, 0], b[:, 2] - b[:, 1],
                        b[:, 3] - b[:, 2], b[:, 5] - b[:, 4]], 1)


def mine_jobs(ix: RefIndex, prefixes, fmin: int, pmin: int = 2,
              pmax: int = 0, emin: float = 0.0, emax: float = -1.0,
              mindepth: int = 0, maxdepth: int | None = None,
              dtype=np.float64, reader_order: str = "ascending") -> dict:
    """Mine the union trie under each of `prefixes` (b"": the whole trie)
    level by level, every job in one frontier: each node keeps its job,
    whose enforced prefix allows one symbol at each of its depths.
    Entropies are computed in `dtype` (np.float64 or np.float32) on the
    device and on the host alike; each printed line's `id:occs` and its
    entropy's sum follow `reader_order` (READER_ORDERS; "gnu": one server
    a job, enforcing max(1, len(prefix)) symbols).  -> {prefix:
    RefOutput}."""
    if reader_order not in READER_ORDERS:
        raise ValueError(f"reader_order {reader_order!r}: one of "
                         f"{READER_ORDERS}")
    dev = ix.x.device
    d, J = ix.d, len(prefixes)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    log2 = torch.log(torch.tensor(2.0, dtype=tdt, device=dev))
    pcodes = [[b"ACGT".index(ch) for ch in p] for p in prefixes]
    # the roots' pairs: every sample, [0, n_s), a root a job
    job = torch.arange(J, device=dev)
    node = torch.arange(J, device=dev).repeat_interleave(d)
    sid = torch.arange(d, device=dev).repeat(J)
    lo = torch.zeros(J * d, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(ix.n, device=dev)[sid]
    paths = [0] * J
    emin_j, emax_j = [np.inf] * J, [-np.inf] * J
    cands, seen, depth, nodes = [], 0, 0, J
    while nodes:
        allowed = torch.zeros((J, 4), dtype=torch.bool, device=dev)
        if maxdepth is None or depth < maxdepth:
            for j, pc in enumerate(pcodes):
                if depth < len(pc):
                    allowed[j, pc[depth]] = True
                else:
                    allowed[j] = True
        obase = ix.ooff[sid]
        clo = ix.cbase[sid] + ix.occ[obase + lo].to(torch.int64)
        chi = ix.cbase[sid] + ix.occ[obase + hi].to(torch.int64)
        cact = ((chi - clo) >= fmin) & allowed[job[node]]
        nact = torch.bincount(node, minlength=nodes)
        ccount = torch.zeros((nodes, 4), dtype=torch.int64, device=dev)
        ccount.index_add_(0, node, cact.to(torch.int64))
        union = ccount > 0
        first = union.to(torch.int8).argmax(1)
        single_full = (union.sum(1) == 1) & (
            ccount.gather(1, first[:, None])[:, 0] == nact)
        if depth > 0:
            freq = hi - lo
            f1 = (freq + 1).to(tdt)
            acc = torch.zeros(nodes, dtype=tdt, device=dev)
            acc.index_add_(0, node, (f1 * torch.log(f1)) / log2)
            total = torch.zeros(nodes, dtype=torch.int64, device=dev)
            total.index_add_(0, node, freq)
            total = (total + d).to(tdt)
            ent = torch.log(total) / log2 - acc / total
            # nodes stay in job order: each job's nodes are one run
            bounds = torch.searchsorted(
                job, torch.arange(J + 1, device=dev)).tolist()
            stat = nact > 1 if pmin > 1 else torch.ones_like(union[:, 0])
            for j in range(J):
                a, b = bounds[j], bounds[j + 1]
                paths[j] += b - a
                e = ent[a:b][stat[a:b]]
                if e.numel():
                    emin_j[j] = min(emin_j[j], float(e.min()))
                    emax_j[j] = max(emax_j[j], float(e.max()))
            cand = (nact >= pmin) & ~single_full
            if pmax:
                cand &= nact <= pmax
            if depth < mindepth:
                cand &= False
            if emax > 0:
                cand &= (ent >= emin - GATE_MARGIN) & (ent <= emax + GATE_MARGIN)
            keep = cand[node]
            cands.append((node[keep] + seen, job[node[keep]], sid[keep],
                          lo[keep], hi[keep],
                          torch.full_like(lo[keep], depth)))
        # the children: (node, symbol) cells in that order, pairs by sample
        cid = (torch.cumsum(union.reshape(-1), 0) - 1).reshape(nodes, 4)
        pi, ci = torch.nonzero(cact, as_tuple=True)
        child, order = torch.sort(cid[node[pi], ci], stable=True)
        sid, lo, hi = sid[pi][order], clo[pi, ci][order], chi[pi, ci][order]
        node = child
        job = job[:, None].expand(-1, 4)[union]
        seen += nodes
        nodes = int(job.numel())
        depth += 1
    outs = {}
    for j, p in enumerate(prefixes):
        em, eM = emin_j[j], emax_j[j]
        outs[p] = RefOutput(
            total_paths=paths[j],
            smallest_entropy=em if np.isfinite(em) else 1000.0,
            largest_entropy=eM if np.isfinite(eM) else -1000.0,
            freq_histogram=np.zeros(d, dtype=np.int64))
    enforced = [max(1, len(p)) for p in prefixes] \
        if reader_order == "gnu" else None
    _emit(ix, [outs[p] for p in prefixes],
          [torch.cat(c) for c in zip(*cands)] if cands else None, d, emin,
          emax, dtype, fmin, enforced)
    for out in outs.values():
        out.lines.sort(key=lambda t: t[0] + b"\xff")
        out.total_output = len(out.lines)
        out.total_occs = sum(len(occs) for _p, _e, occs in out.lines)
    return outs


def _emit(ix: RefIndex, outs: list, cand, d: int, emin: float, emax: float,
          dtype, fmin: int, enforced: list | None) -> None:
    """The printed lines among the candidate nodes' pairs `cand` (global
    node id, job, sample, lo, hi, depth): the left-branching gate, then
    the entropy window in `dtype` on the host; each line goes to its job's
    output.  With `enforced` (each job's enforced prefix length), each
    line's readers and entropy sum follow the gnu order, and the window
    judges that sum."""
    if cand is None or not cand[0].numel():
        return
    gnode, job, sid, lo, hi, depth = cand
    counts = _next_base_counts(ix, sid, lo, hi, depth)
    freq = hi - lo
    full = (counts == freq[:, None]) & (freq[:, None] > 0)
    # 2..5: every occurrence follows that base; 1: bases mixed; 0: none
    lc = torch.where(full.any(1), full.to(torch.int8).argmax(1) + 2,
                     torch.where((counts > 0).any(1), 1, 0))
    # each pair's path: its first suffix-array row's text, read backwards
    start = ix.xoff[sid] + ix.sa[ix.xoff[sid] + lo]
    text = ix.x[(start[:, None] + torch.arange(int(depth.max()),
                                               device=lo.device))
                .clamp(max=ix.x.numel() - 1)]
    gnode, job, sid, freq, lc, depth, text = (
        t.cpu().numpy() for t in (gnode, job, sid, freq, lc, depth, text))
    uniq, first, row = np.unique(gnode, return_index=True,
                                 return_inverse=True)
    fmat = np.zeros((uniq.size, d), dtype=np.int64)
    fmat[row, sid] = freq
    ent = entropy_np(fmat, d, dtype)
    lmin = np.full(uniq.size, 99)
    lmax = np.full(uniq.size, -1)
    np.minimum.at(lmin, row, lc)
    np.maximum.at(lmax, row, lc)
    ok = np.where(lmin == lmax, lmax, 1) < 2
    # the ascending sum's window, widened where the gnu sum decides
    slack = GATE_MARGIN if enforced else 0.0
    if emax > 0:
        ok &= (ent >= emin - slack) & (ent <= emax + slack)
    keep = np.flatnonzero(ok)
    paths = {u: CODE_CHAR[text[first[u], :depth[first[u]]][::-1]].tobytes()
             for u in keep}
    readers = {u: np.flatnonzero(fmat[u]).tolist() for u in keep}
    if enforced:
        for n in sorted({enforced[job[first[u]]] for u in keep}):
            group = [u for u in keep if enforced[job[first[u]]] == n]
            orders = gnu_orders(ix, [paths[u] for u in group], fmin, n)
            for u in group:
                order = orders[paths[u]]
                if sorted(order) != readers[u]:
                    raise RuntimeError(f"{paths[u]!r}: the gnu replay's "
                                       f"readers {sorted(order)} are not "
                                       f"the node's {readers[u]}")
                readers[u] = order
                ent[u] = gnu_entropy(order, fmat[u], d, dtype)
    for u in keep:
        if emax > 0 and not emin <= ent[u] <= emax:
            continue
        out = outs[job[first[u]]]
        out.lines.append((paths[u], float(ent[u]),
                          [(int(s), int(fmat[u, s])) for s in readers[u]]))
        out.freq_histogram[len(readers[u]) - 1] += 1
