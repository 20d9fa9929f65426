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
entropies that decide a printed line are recomputed on the host in NumPy,
summed in ascending sample order, in `dtype` (float64 as the
configuration states; the control passes float32).
"""

from __future__ import annotations

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
    in ascending sample order) in post-order, and the counters."""

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
              dtype=np.float64) -> dict:
    """Mine the union trie under each of `prefixes` (b"": the whole trie)
    level by level, every job in one frontier: each node keeps its job,
    whose enforced prefix allows one symbol at each of its depths.
    Entropies are computed in `dtype` (np.float64 or np.float32) on the
    device and on the host alike.  -> {prefix: RefOutput}."""
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
    _emit(ix, [outs[p] for p in prefixes],
          [torch.cat(c) for c in zip(*cands)] if cands else None, d, emin,
          emax, dtype)
    for out in outs.values():
        out.lines.sort(key=lambda t: t[0] + b"\xff")
        out.total_output = len(out.lines)
        out.total_occs = sum(len(occs) for _p, _e, occs in out.lines)
    return outs


def _emit(ix: RefIndex, outs: list, cand, d: int, emin: float, emax: float,
          dtype) -> None:
    """The printed lines among the candidate nodes' pairs `cand` (global
    node id, job, sample, lo, hi, depth): the entropy window in `dtype` on
    the host, then the left-branching gate; each line goes to its job's
    output."""
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
    ok = (ent >= emin) & (ent <= emax) if emax > 0 else np.ones(uniq.size, bool)
    lmin = np.full(uniq.size, 99)
    lmax = np.full(uniq.size, -1)
    np.minimum.at(lmin, row, lc)
    np.maximum.at(lmax, row, lc)
    ok &= np.where(lmin == lmax, lmax, 1) < 2
    for u in np.flatnonzero(ok):
        act = np.flatnonzero(fmat[u])
        j = first[u]
        out = outs[job[j]]
        out.lines.append((CODE_CHAR[text[j, :depth[j]][::-1]].tobytes(),
                          float(ent[u]),
                          [(int(s), int(fmat[u, s])) for s in act]))
        out.freq_histogram[act.size - 1] += 1
