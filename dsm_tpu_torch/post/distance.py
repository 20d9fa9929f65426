"""Pairwise sample-distance matrices from mined substring rows (the
port's copy of dsm_tpu/post/distance.py, its device function replaced).

Equivalent of the reference post-processing stage
``wrapper-distance-matrix/smtxt2entropy.c`` (see SURVEY.md §2.4): streams
``metaserver`` output rows (``path entropy id:freq id:freq ...``), bins
each row by its normalized cross-sample entropy, and accumulates four
pairwise matrices per entropy bin:

  * ``count``  — co-occurrence counts over present sample pairs
                 (upper triangle incl. diagonal; smtxt2entropy.c:168-170)
  * ``log``    — sum of (log(1+s) - log(1+t))^2        (c:179,187)
  * ``sqrt``   — sum of (sqrt(s) - sqrt(t))^2          (c:180,188)
  * ``lgamma`` — sum of lgamma(s+t+1) - lgamma(s+1) - lgamma(t+1)
                 - (s+t+1), only over pairs with s or t nonzero
                 (c:174,181-182 — the gate matters: an absent-absent
                 pair would otherwise contribute -1, not 0)

Entropy here is the smoothed row entropy normalized by its maximum:
``H = log2(d + sum f_i) - sum (f_i+1) log2(f_i+1) / (d + sum f_i)``
divided by ``log2(d)`` (smtxt2entropy.c:128-144).  Bins are NESTED: the
matrix for threshold m accumulates every row with entropy <= m
(accumulation from smaller to larger thresholds, c:726-756), and the
output file lists matrices from the smallest threshold up.

Two accumulation modes:
  * ``exact=True``  — row-by-row accumulation in input order; per matrix
    element the float addition order equals the reference's, so outputs
    are bit-compatible.  The per-row pair work is vectorized (d^2 <= a
    few 10^4), so this is still fast enough for millions of rows.
  * ``exact=False`` — whole chunks reduced at once on ``device`` by
    ``pairwise_matrices_torch``: on a CUDA device the pairwise-matrix
    kernel (ops/distance.py), on the CPU its plain PyTorch version; same
    math in f64, float association differs by O(ulp).  Use for bulk runs.

``pairwise_matrices`` is the NumPy f64 oracle of one chunk.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch
from scipy.special import gammaln as _gammaln  # type: ignore

from ..ops.distance import pairwise_matrices as _pairwise_matrices_device
from ..ops.distance import pairwise_matrices_plain  # noqa: F401
from ..utils.device import resolve_device

LOG2 = math.log(2.0)
KINDS = ("count", "log", "sqrt", "lgamma")


def parse_row(
    line: str,
    runs: int,
    runtosmpl: np.ndarray | None = None,
    minfreq: int = 0,
    has_entropy: bool | None = None,
) -> np.ndarray:
    """One output row -> dense per-sample frequency vector.

    Mirrors smtxt2entropy.c:84-126: drops pairs below ``minfreq``, maps
    run ids through ``runtosmpl`` (later pairs overwrite earlier ones on
    collision, c:106-108), errors on run ids >= ``runs``.  A row whose
    pairs are ALL filtered yields the zero vector — the reference still
    bins such a row (its smoothed entropy is exactly 1.0, c:683-705).
    ``has_entropy``: the reference sniffs a '.' in the second field of
    the first row (c:665-673); pass explicitly when known.
    """
    parts = line.split()
    start = 1
    if has_entropy is None:
        has_entropy = len(parts) > 1 and "." in parts[1]
    if has_entropy:
        start = 2
    nsmpl = runs if runtosmpl is None else int(runtosmpl.max()) + 1
    freq = np.zeros(nsmpl, dtype=np.int64)
    for p in parts[start:]:
        run_s, _, frq_s = p.partition(":")
        run, frq = int(run_s), int(frq_s)
        if run >= runs:
            raise ValueError(f"run id {run} >= declared runs {runs}")
        if frq < minfreq:
            continue
        if runtosmpl is not None:
            run = int(runtosmpl[run])
        freq[run] = frq
    return freq


def row_entropy(freq: np.ndarray, smpls: int,
                nfactor: np.ndarray | None = None) -> float:
    """Normalized smoothed entropy of one row (smtxt2entropy.c:128-162).

    Sum order follows ascending sample id (the reference iterates the
    sorted unique id list, c:115-125,135-140).
    """
    idx = np.flatnonzero(freq)
    sumN = float(smpls)
    sumNlogN = 0.0
    for i in idx:
        f = float(freq[i]) if nfactor is None else float(freq[i]) * nfactor[i]
        sumN += f
        sumNlogN += (f + 1.0) * math.log(f + 1.0) / LOG2
    h = math.log(sumN) / LOG2 - sumNlogN / sumN
    return LOG2 * h / math.log(smpls)


def _pair_terms(freq: np.ndarray, nfactor: np.ndarray | None):
    """Per-row pairwise addends for the 4 matrices, vectorized over pairs.

    Returns dict of (smpls, smpls) float64/int64 arrays, zero outside the
    triangle each matrix uses.
    """
    d = freq.shape[0]
    present = freq > 0
    f = freq.astype(np.float64)
    if nfactor is not None:
        f = f * nfactor
    upper_ge = np.triu(np.ones((d, d), dtype=bool), k=0)   # j <= k
    upper_gt = np.triu(np.ones((d, d), dtype=bool), k=1)   # j <  k
    either = (present[:, None] | present[None, :]) & upper_gt

    lg = np.log1p(f)
    sq = np.sqrt(f)
    count = (present[:, None] & present[None, :] & upper_ge).astype(np.int64)
    logm = np.where(upper_gt, (lg[:, None] - lg[None, :]) ** 2, 0.0)
    sqrtm = np.where(upper_gt, (sq[:, None] - sq[None, :]) ** 2, 0.0)
    s = f[:, None] + f[None, :]
    lgam = _gammaln(s + 1.0) - _gammaln(f + 1.0)[:, None] \
        - _gammaln(f + 1.0)[None, :] - (s + 1.0)
    lgam = np.where(either, lgam, 0.0)
    return {"count": count, "log": logm, "sqrt": sqrtm, "lgamma": lgam}


@dataclass
class DistanceAccumulator:
    """Streaming accumulator matching smtxt2entropy's main loop.

    ``maxents`` are the ``-m/--maxent`` thresholds (any order); each row
    lands in the SMALLEST threshold >= its entropy (c:692-705), and
    nested accumulation happens at output time (c:750-755).
    ``sizes`` enables ``-N/--normalize`` frequency scaling (c:584-614);
    the lgamma matrix is then left at zero, as the reference's
    normalized path has it disabled (c:196-229 "FIXME lgamma disabled").
    ``device`` is where ``exact=False`` reduces its chunks (a torch device
    or its name); ``chunk_rows`` defaults to 4096 rows on the CPU, where
    the plain version's (rows, smpls, smpls) temporaries bound it, and to
    2^18 on a CUDA device, where the kernel has none.
    """

    smpls: int
    maxents: list[float]
    runs: int | None = None
    runtosmpl: np.ndarray | None = None
    minfreq: int = 0
    sizes: np.ndarray | None = None
    exact: bool = True
    chunk_rows: int | None = None
    device: object = None

    _thresholds: np.ndarray = field(init=False)
    _mats: dict = field(init=False)
    _noutput: np.ndarray = field(init=False)
    _nfactor: np.ndarray | None = field(init=False)
    _pending: list = field(init=False, default_factory=list)
    _pending_bins: list = field(init=False, default_factory=list)
    rows_read: int = field(init=False, default=0)
    _has_entropy: bool | None = field(init=False, default=None)

    def __post_init__(self):
        if self.smpls < 2:
            raise ValueError("smpls must be >= 2 (smtxt2entropy.c:560)")
        if self.runs is None:
            self.runs = self.smpls
        if not self.exact:
            if self.device is None:
                raise ValueError("exact=False needs a device ('cuda' or "
                                 "'cpu')")
            self.device = resolve_device(self.device)
            if self.chunk_rows is None:
                self.chunk_rows = (1 << 18 if self.device.type == "cuda"
                                   else 4096)
        # descending sort as the reference's qsort (c:69-76,632)
        self._thresholds = np.sort(np.asarray(self.maxents, dtype=np.float64))[::-1]
        nb = len(self._thresholds)
        self._mats = {
            "count": np.zeros((nb, self.smpls, self.smpls), dtype=np.int64),
            "log": np.zeros((nb, self.smpls, self.smpls)),
            "sqrt": np.zeros((nb, self.smpls, self.smpls)),
            "lgamma": np.zeros((nb, self.smpls, self.smpls)),
        }
        self._noutput = np.zeros(nb, dtype=np.int64)
        self._nfactor = None
        if self.sizes is not None:
            sizes = np.asarray(self.sizes, dtype=np.float64)
            if sizes.shape[0] != self.smpls or (sizes == 0).any():
                raise ValueError("need one nonzero size per sample")
            self._nfactor = 1.0 / sizes

    # -- row ingestion ----------------------------------------------------

    def add_line(self, line: str) -> None:
        if self._has_entropy is None and line.split():
            parts = line.split()
            self._has_entropy = len(parts) > 1 and "." in parts[1]
        freq = parse_row(line, self.runs, self.runtosmpl, self.minfreq,
                         self._has_entropy)
        self.rows_read += 1
        self.add_freqs(freq)

    def add_freqs(self, freq: np.ndarray) -> None:
        entr = row_entropy(freq, self.smpls, self._nfactor)
        # smallest threshold >= entr; rows above every threshold are dropped
        bin_ = None
        for i in range(len(self._thresholds) - 1, -1, -1):
            if entr <= self._thresholds[i]:
                bin_ = i
                break
        if bin_ is None:
            return
        self._noutput[bin_] += 1
        if self.exact:
            terms = _pair_terms(freq, self._nfactor)
            for k in KINDS:
                if k == "lgamma" and self._nfactor is not None:
                    continue
                self._mats[k][bin_] += terms[k]
        else:
            self._pending.append(freq)
            self._pending_bins.append(bin_)
            if len(self._pending) >= self.chunk_rows:
                self._flush()

    def add_lines(self, lines) -> None:
        for line in lines:
            if line.strip():
                self.add_line(line)

    def _flush(self) -> None:
        if not self._pending:
            return
        F = np.stack(self._pending)
        bins = np.asarray(self._pending_bins)
        self._pending.clear()
        self._pending_bins.clear()
        batch = pairwise_matrices_torch(F, len(self._thresholds), bins,
                                        self._nfactor, device=self.device)
        for k in KINDS:
            if k == "lgamma" and self._nfactor is not None:
                continue
            self._mats[k] += batch[k].cpu().numpy()

    # -- results ----------------------------------------------------------

    def matrices(self) -> dict:
        """-> {kind: (nbins, smpls, smpls)} with NESTED bins, plus counts.

        Index 0 = smallest threshold.  Matches the reference's output
        accumulation (c:726-756).
        """
        self._flush()
        out = {}
        order = np.arange(len(self._thresholds))[::-1]  # ascending maxent
        for k in KINDS:
            out[k] = np.cumsum(self._mats[k][order], axis=0)
        out["thresholds"] = self._thresholds[order].copy()
        out["noutput"] = np.cumsum(self._noutput[order])
        return out

    def write(self, suffix: str, outdir: str = ".") -> list[str]:
        """Write count.<suffix> log.<suffix> sqrt.<suffix> lgamma.<suffix>
        in the reference's file format (c:726-756); refuses to overwrite
        (c:366-384)."""
        res = self.matrices()
        paths = []
        for k in KINDS:
            path = os.path.join(outdir, f"{k}.{suffix}")
            if os.path.exists(path):
                raise FileExistsError(f"output file {path} already exists")
            with open(path, "w") as fh:
                for b in range(len(res["thresholds"])):
                    fh.write(
                        f"Matrix for <max_entropy>=<{res['thresholds'][b]:f}>"
                        f" was computed from {res['noutput'][b]} substrings: \n")
                    m = res[k][b]
                    for j in range(self.smpls):
                        row = m[j]
                        if k == "count":
                            fh.write("".join(f" {int(v)}" for v in row) + "\n")
                        else:
                            fh.write("".join(f" {v:f}" for v in row) + "\n")
            paths.append(path)
        return paths


def pairwise_matrices(F: np.ndarray, nbins: int, bins: np.ndarray,
                      nfactor: np.ndarray | None = None) -> dict:
    """Batched pairwise matrices for a chunk of rows (numpy).

    F: (rows, smpls) int frequencies; bins: (rows,) bin index per row.
    Same math as _pair_terms but reduced over the whole chunk with
    einsums; float association differs from exact mode by O(ulp).
    """
    R, d = F.shape
    P = (F > 0)
    f = F.astype(np.float64)
    if nfactor is not None:
        f = f * nfactor
    onehot = np.zeros((R, nbins))
    onehot[np.arange(R), bins] = 1.0

    upper_ge = np.triu(np.ones((d, d), dtype=bool), k=0)
    upper_gt = np.triu(np.ones((d, d), dtype=bool), k=1)

    count = np.einsum("rb,rj,rk->bjk", onehot, P, P).astype(np.int64)
    count *= upper_ge

    lg, sq = np.log1p(f), np.sqrt(f)
    # (a_j - a_k)^2 = a_j^2 + a_k^2 - 2 a_j a_k, reduced per bin
    def sqdiff(a):
        s2 = np.einsum("rb,rj->bj", onehot, a * a)
        cross = np.einsum("rb,rj,rk->bjk", onehot, a, a)
        return (s2[:, :, None] + s2[:, None, :] - 2 * cross) * upper_gt

    s = f[:, None, :] + f[:, :, None]  # (R, d, d) — chunk_rows bounds this
    either = (P[:, :, None] | P[:, None, :]) & upper_gt
    lgam_terms = np.where(
        either,
        _gammaln(s + 1.0) - _gammaln(f + 1.0)[:, :, None]
        - _gammaln(f + 1.0)[:, None, :] - (s + 1.0),
        0.0,
    )
    lgam = np.einsum("rb,rjk->bjk", onehot, lgam_terms)
    return {"count": count, "log": sqdiff(lg), "sqrt": sqdiff(sq),
            "lgamma": lgam}


def pairwise_matrices_torch(F, nbins: int, bins, nfactor=None, *,
                            device) -> dict:
    """Device version of pairwise_matrices (the counterpart of dsm_tpu's
    pairwise_matrices_jax): F (rows, smpls) int frequencies, bins (rows,)
    and nfactor (smpls,) as NumPy arrays or tensors -> {kind: (nbins, smpls,
    smpls) tensor on `device`}, count int64 and the others f64.  On a CUDA
    device the rows go through the pairwise-matrix kernel; on the CPU
    through pairwise_matrices_plain.  With nfactor the lgamma matrix is
    zero (the accumulator leaves it out)."""
    device = resolve_device(device)
    F = torch.as_tensor(F)
    if F.dtype not in (torch.int32, torch.int64):
        F = F.to(torch.int64)
    if nfactor is not None:
        nfactor = torch.as_tensor(nfactor, dtype=torch.float64).to(device)
    return _pairwise_matrices_device(
        F.to(device).contiguous(), nbins, torch.as_tensor(bins).to(device),
        nfactor)


def entropy_steps(step: float) -> list[float]:
    """-e/--entstep thresholds: 0, step, 2*step, ..., 1.0
    (smtxt2entropy.c:258-282)."""
    if step <= 0.0 or step > 1.0:
        raise ValueError("entstep must be in (0, 1]")
    n = int(round(1.0 / step + 0.5))
    if (n - 1) * step < 1.0:
        n += 1
    vals, s = [], 0.0
    for _ in range(n - 1):
        vals.append(s)
        s += step
    vals.append(1.0)
    return vals
