"""Binned pairwise sample-distance matrices (kernel K11, csrc/distance.cu).

Counterpart of dsm_tpu/post/distance.py `pairwise_matrices_jax`: R mined
rows of d per-sample frequencies `F`, each row in one entropy bin
`bins[r]` of `nbins`, reduce to four (nbins, d, d) matrices,

    count [b,j,k] = #{r in bin b : F[r,j] > 0 and F[r,k] > 0}     j <= k
    log   [b,j,k] = sum (log1p f_j - log1p f_k)^2                 j <  k
    sqrt  [b,j,k] = sum (sqrt f_j - sqrt f_k)^2                   j <  k
    lgamma[b,j,k] = sum lgamma(f_j+f_k+1) - lgamma(f_j+1)
                        - lgamma(f_k+1) - (f_j+f_k+1)             j <  k
                    over the rows where f_j or f_k is nonzero

zero outside each triangle, with f = F, or F * nfactor when `nfactor`
((d,) f64, the -N/--normalize scaling) is given; then the lgamma matrix
stays zero, as the accumulator leaves it out.  count is int64, the others
f64.  The kernel splits the sums (see csrc/distance.cu): the cross sums
of log1p f and sqrt f are Gram products of each bin's rows on the f64
tensor cores, log = Q_j + Q_k - 2 sum a_j a_k with the column sums Q;
count is a popcount of the columns' row masks, and lgamma one sum over
the rows where both entries are nonzero less the column sums of f and of
f > 0.  Where Q_j + Q_k - 2G would cancel past 1e-10 of its size, it
takes the direct differences instead.  All of it in f64 (the JAX
function's products are f32).  The plain version below takes direct
differences everywhere, independent of the kernel.
"""

from __future__ import annotations

import torch

from . import _build

KINDS = ("count", "log", "sqrt", "lgamma")
MAX_BINS = 4096     # the sort's histogram of a block lives in shared memory
ROWS_STAGED = 32    # csrc/distance.cu kCh
PAIR_TILE = 32      # csrc/distance.cu kT
BLOCKS_PER_SM = 4   # of the count-and-lgamma kernel (the Gram kernel: 3)


def pairwise_matrices_plain(F: torch.Tensor, nbins: int, bins: torch.Tensor,
                            nfactor: torch.Tensor | None = None) -> dict:
    """Plain PyTorch version of the kernel (any device): the pair terms as
    (R, d, d) f64 tensors, reduced per bin by einsums with the one-hot bin
    matrix.  Memory is R * d * d * 8 bytes a temporary: chunk the rows."""
    R, d = F.shape
    dev = F.device
    present = F > 0
    f = F.to(torch.float64)
    if nfactor is not None:
        f = f * nfactor.to(torch.float64)
    onehot = torch.zeros((R, nbins), dtype=torch.float64, device=dev)
    onehot[torch.arange(R, device=dev), bins.to(torch.int64)] = 1.0
    ones = torch.ones((d, d), dtype=torch.bool, device=dev)
    upper_ge, upper_gt = torch.triu(ones), torch.triu(ones, diagonal=1)

    def per_bin(terms):
        return torch.einsum("rb,rjk->bjk", onehot, terms)

    both = (present[:, :, None] & present[:, None, :] & upper_ge)
    count = per_bin(both.to(torch.float64)).round().to(torch.int64)

    def sqdiff(a):
        diff = a[:, :, None] - a[:, None, :]
        return per_bin(torch.where(upper_gt, diff * diff, 0.0))

    out = {"count": count, "log": sqdiff(torch.log1p(f)),
           "sqrt": sqdiff(torch.sqrt(f))}
    if nfactor is not None:
        out["lgamma"] = torch.zeros_like(out["log"])
        return out
    s = f[:, None, :] + f[:, :, None]
    lf = torch.lgamma(f + 1.0)
    either = (present[:, :, None] | present[:, None, :]) & upper_gt
    out["lgamma"] = per_bin(torch.where(
        either,
        torch.lgamma(s + 1.0) - lf[:, :, None] - lf[:, None, :] - (s + 1.0),
        0.0))
    return out


def pairwise_matrices(F: torch.Tensor, nbins: int, bins: torch.Tensor,
                      nfactor: torch.Tensor | None = None) -> dict:
    """{kind: (nbins, d, d)} of the rows `F` (see the module docstring).
    F: (R, d) int32 or int64, contiguous, entries >= 0; bins: (R,) integer
    in [0, nbins) (the kernel leaves a row of another bin out; the plain
    version raises); nfactor: None or (d,) float64; all on one device.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if F.device.type == "cpu":
        return pairwise_matrices_plain(F, nbins, bins, nfactor)
    if F.device.type != "cuda":
        raise ValueError(f"pairwise_matrices: unsupported device {F.device}")
    if (F.dim() != 2 or F.dtype not in (torch.int32, torch.int64)
            or not F.is_contiguous()):
        raise ValueError("pairwise_matrices: F must be a contiguous (R, d) "
                         "int32 or int64 tensor")
    R, d = F.shape
    if d < 1 or not 1 <= nbins <= MAX_BINS or R >= 1 << 31:
        raise ValueError(f"pairwise_matrices: need d >= 1, 1 <= nbins <= "
                         f"{MAX_BINS} and fewer than 2**31 rows")
    if (bins.shape != (R,) or bins.device != F.device
            or bins.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"pairwise_matrices: bins must be (R,) int32 or "
                         f"int64 on {F.device}")
    bins = bins.to(torch.int32).contiguous()
    if nfactor is not None:
        if (nfactor.shape != (d,) or nfactor.dtype != torch.float64
                or nfactor.device != F.device):
            raise ValueError(f"pairwise_matrices: nfactor must be (d,) "
                             f"float64 on {F.device}")
        nfactor = nfactor.contiguous()
    f64 = dict(dtype=torch.float64, device=F.device)
    out = {"count": torch.zeros((nbins, d, d), dtype=torch.int64,
                                device=F.device),
           "log": torch.zeros((nbins, d, d), **f64),
           "sqrt": torch.zeros((nbins, d, d), **f64),
           "lgamma": torch.zeros((nbins, d, d), **f64)}
    if R == 0:
        return out
    # row slices: two whole waves of blocks (pair tiles x slices), never
    # one more block than that, and at least one staging step a slice
    ntile = -(-d // PAIR_TILE)
    tiles = ntile * (ntile + 1) // 2
    sms = torch.cuda.get_device_properties(F.device).multi_processor_count
    slices = max(1, min(2 * BLOCKS_PER_SM * sms // tiles,
                        -(-R // ROWS_STAGED), 65535))
    counts = torch.zeros(nbins + 1, dtype=torch.int32, device=F.device)
    order = torch.empty(R, dtype=torch.int32, device=F.device)
    _build.launch(
        "dsm_pairwise", "distance", F.device, F.data_ptr(),
        int(F.dtype == torch.int64), bins.data_ptr(),
        None if nfactor is None else nfactor.data_ptr(), R, d, nbins, slices,
        counts.data_ptr(), order.data_ptr(), out["count"].data_ptr(),
        out["log"].data_ptr(), out["sqrt"].data_ptr(),
        out["lgamma"].data_ptr())
    return out
