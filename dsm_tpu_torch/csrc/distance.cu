// Binned pairwise sample-distance matrices (kernel K11).
//
// Replaces dsm_tpu/post/distance.py pairwise_matrices_jax.  For R mined rows
// of d per-sample frequencies, each row in one of nbins entropy bins, it sums
// into four (nbins, d, d) matrices, over the rows r of each bin b:
//   count [b,j,k] += (F[r,j] > 0 && F[r,k] > 0)                      j <= k
//   log   [b,j,k] += (log1p f_j - log1p f_k)^2                       j <  k
//   sqrt  [b,j,k] += (sqrt f_j - sqrt f_k)^2                         j <  k
//   lgamma[b,j,k] += lgamma(f_j+f_k+1) - lgamma(f_j+1) - lgamma(f_k+1)
//                    - (f_j+f_k+1)      where f_j or f_k is nonzero, j <  k
// with f = F, or F * nfactor[sample] when nfactor is given (then the lgamma
// matrix is left alone, as smtxt2entropy's normalised path has it disabled).
//
// The JAX function turns the reduction into matrix products (a one-hot bin
// matrix and (a_j - a_k)^2 = a_j^2 + a_k^2 - 2 a_j a_k), in f32.  None of that
// is carried over: here every difference is taken directly, every term and
// sum is f64 (log1p, sqrt and lgamma are the f64 device functions), and
// count is an integer.
//
// Three steps, one entry point:
//  1. bin_count, bin_offsets, bin_scatter: a counting sort of the row
//     numbers by bin (a histogram in shared memory per block of rows, one
//     global atomicAdd a bin a block to reserve its range).  Rows of one bin
//     come out in no fixed order; rows whose bin is outside [0, nbins) are
//     left out.
//  2. pairwise_kernel: a block owns one 16 x 16 tile of (j, k) pairs of the
//     upper triangle (blockIdx.x) and one slice of the sorted rows
//     (blockIdx.y); a thread owns one pair.  The block stages 32 rows at a
//     time in shared memory: for the tile's 16 + 16 columns the value f and
//     its log1p, sqrt and lgamma(f + 1), computed once per element and not
//     once per pair (zero entries, the most of a mined row, cost nothing).
//     Each thread walks the staged rows with its pair's four sums of the
//     current bin in registers, and when the bin changes (the rows are
//     sorted, so at most nbins times a slice, and for the whole block at
//     once) adds them into the output with f64 and 64-bit integer atomicAdd.
// The row slices of one pair and the rows of one bin meet in an order that
// changes from run to run, so the f64 sums agree between runs to rounding,
// not bit for bit; count is exact.
//
// What bounds it on an H100: f64 operations, not bytes.  A row is 4 d bytes
// and d^2/2 pair terms.  The costly term is lgamma(f_j + f_k + 1), one
// evaluation of a few hundred f64 instructions for every pair with both
// entries nonzero, and a warp pays for it when any of its lanes does.
// Frequencies are integers with a long tail, so a table of lgamma(n + 1) for
// n < kTab in shared memory, filled by the same device function, answers
// most of them with one load and the same bits; only larger sums evaluate.
// An earlier design kept every bin's accumulators in shared memory instead
// of sorting: 206 KB a block at 21 bins, one block an SM, and a dependent
// read-modify-write through shared memory for every term.  At 2^20 rows of
// 64 samples in 21 bins it took 37.7 ms against this design's 9.5 ms (NVIDIA
// H100 80GB HBM3, 700 W, CUDA events over 10 launches, both in one process
// each, in turns).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                  // pairs tile: kTile x kTile
constexpr int kThreads = kTile * kTile;    // one pair a thread
constexpr int kCols = 2 * kTile;           // staged columns: j tile, k tile
constexpr int kRows = 32;                  // staged rows
constexpr int kTab = 2048;                 // lgamma(n + 1) table entries
constexpr int kSortBlock = 256;            // threads of a sort block
constexpr int kSortRows = 4096;            // rows of a sort block
constexpr size_t kPairSmem = (size_t)(kTab + 4 * kRows * kCols) * 8;

// counts[b] += rows of this block in bin b
__global__ void __launch_bounds__(kSortBlock)
bin_count(const int32_t* __restrict__ bins, long long R, int nbins,
          int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  for (int b = threadIdx.x; b < nbins; b += kSortBlock) hist[b] = 0;
  __syncthreads();
  long long r0 = (long long)blockIdx.x * kSortRows;
  for (int i = threadIdx.x; i < kSortRows && r0 + i < R; i += kSortBlock) {
    int b = bins[r0 + i];
    if (b >= 0 && b < nbins) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += kSortBlock)
    if (hist[b]) atomicAdd(&counts[b], hist[b]);
}

// counts[b] -> first sorted position of bin b; counts[nbins] = rows kept
__global__ void bin_offsets(int nbins, int32_t* __restrict__ counts) {
  int run = 0;
  for (int b = 0; b < nbins; ++b) {
    int c = counts[b];
    counts[b] = run;
    run += c;
  }
  counts[nbins] = run;
}

// order[sorted position] = row; cursor[b] moves from bin b's start to its end
__global__ void __launch_bounds__(kSortBlock)
bin_scatter(const int32_t* __restrict__ bins, long long R, int nbins,
            int32_t* __restrict__ cursor, int32_t* __restrict__ order) {
  extern __shared__ int32_t sh[];
  int32_t* hist = sh;
  int32_t* base = sh + nbins;
  for (int b = threadIdx.x; b < nbins; b += kSortBlock) hist[b] = 0;
  __syncthreads();
  long long r0 = (long long)blockIdx.x * kSortRows;
  for (int i = threadIdx.x; i < kSortRows && r0 + i < R; i += kSortBlock) {
    int b = bins[r0 + i];
    if (b >= 0 && b < nbins) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += kSortBlock) {
    base[b] = hist[b] ? atomicAdd(&cursor[b], hist[b]) : 0;
    hist[b] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSortRows && r0 + i < R; i += kSortBlock) {
    int b = bins[r0 + i];
    if (b >= 0 && b < nbins)
      order[base[b] + atomicAdd(&hist[b], 1)] = (int32_t)(r0 + i);
  }
}

// lgamma(f + 1) of an integral f >= 0
__device__ __forceinline__ double lgamma1(double f, const double* tab) {
  return f < (double)kTab ? tab[(int)f] : lgamma(f + 1.0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const T* __restrict__ F, const int32_t* __restrict__ bins,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ kept,
                const double* __restrict__ nfactor, int d,
                unsigned long long* __restrict__ out_count,
                double* __restrict__ out_log, double* __restrict__ out_sqrt,
                double* __restrict__ out_lgamma) {
  extern __shared__ double smem[];
  __shared__ int st_bin[kRows];
  double* tab = smem;
  double* st_f = tab + kTab;
  double* st_lg = st_f + kRows * kCols;
  double* st_sq = st_lg + kRows * kCols;
  double* st_lf = st_sq + kRows * kCols;

  const int tid = threadIdx.x;
  const bool scaled = nfactor != nullptr;

  // the tile (tj <= tk) of the upper triangle this block owns
  int ntile = (d + kTile - 1) / kTile;
  int t = blockIdx.x, tj = 0;
  for (int len = ntile; t >= len; --len) {
    t -= len;
    ++tj;
  }
  const int tk = tj + t;
  const int ty = tid / kTile, tx = tid % kTile;
  const int j = tj * kTile + ty, k = tk * kTile + tx;
  const bool valid = j <= k && k < d;
  const bool upper = valid && j < k;

  // this block's slice of the sorted rows
  const long long M = *kept;
  const long long per = (M + gridDim.y - 1) / gridDim.y;
  const long long pos_begin = (long long)blockIdx.y * per;
  long long pos_end = pos_begin + per;
  if (pos_end > M) pos_end = M;
  if (pos_begin >= pos_end) return;

  if (!scaled)
    for (int n = tid; n < kTab; n += kThreads) tab[n] = lgamma(n + 1.0);

  int cur = -1;      // the bin of the sums below
  int cnt = 0;
  double slog = 0.0, ssqrt = 0.0, slgam = 0.0;
  auto flush = [&](long long o) {   // add the sums into output entry o
    if (cnt) atomicAdd(out_count + o, (unsigned long long)cnt);
    if (slog != 0.0) atomicAdd(out_log + o, slog);
    if (ssqrt != 0.0) atomicAdd(out_sqrt + o, ssqrt);
    if (slgam != 0.0) atomicAdd(out_lgamma + o, slgam);
  };

  for (long long pos0 = pos_begin; pos0 < pos_end; pos0 += kRows) {
    __syncthreads();   // the table is filled; the last rows are consumed
    // stage kRows rows of the tile's columns: a warp takes one row
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      int r = e / kCols, c = e % kCols;
      long long pos = pos0 + r;
      int col = c < kTile ? tj * kTile + c : tk * kTile + (c - kTile);
      double f = 0.0, lg = 0.0, sq = 0.0, lf = 0.0;
      int b = -1;
      if (pos < pos_end) {
        long long row = order[pos];
        b = bins[row];
        if (col < d) {
          T v = F[row * d + col];
          if (v > 0) {
            f = (double)v;
            if (scaled) {
              f *= nfactor[col];
            } else {
              lf = lgamma1(f, tab);
            }
            lg = log1p(f);
            sq = sqrt(f);
          }
        }
      }
      st_f[e] = f;
      st_lg[e] = lg;
      st_sq[e] = sq;
      st_lf[e] = lf;
      if (c == 0) st_bin[r] = b;
    }
    __syncthreads();

    for (int r = 0; r < kRows; ++r) {
      int b = st_bin[r];     // the same for the whole block
      if (b < 0) break;      // past the slice's end
      if (b != cur) {
        if (cur >= 0 && valid) flush(((long long)cur * d + j) * d + k);
        cur = b;
        cnt = 0;
        slog = ssqrt = slgam = 0.0;
      }
      int ej = r * kCols + ty, ek = r * kCols + kTile + tx;
      double fj = st_f[ej], fk = st_f[ek];
      bool both = fj > 0.0 && fk > 0.0;
      cnt += both;
      if (upper) {
        double dl = st_lg[ej] - st_lg[ek];
        double ds = st_sq[ej] - st_sq[ek];
        slog += dl * dl;
        ssqrt += ds * ds;
        if (!scaled && (fj > 0.0 || fk > 0.0)) {
          double s = fk + fj;
          double lfj = st_lf[ej], lfk = st_lf[ek];
          // one entry zero: its lgamma(1) is 0 and s is the other entry
          double ls = both ? lgamma1(s, tab) : lfj + lfk;
          slgam += ls - lfj - lfk - (s + 1.0);
        }
      }
    }
  }
  if (cur >= 0 && valid) flush(((long long)cur * d + j) * d + k);
}

template <typename T>
int launch_pairs(const void* F, const void* bins, const void* order,
                 const int32_t* kept, const void* nfactor, int d, int slices,
                 void* count, void* logm, void* sqrtm, void* lgam,
                 cudaStream_t stream) {
  int ntile = (d + kTile - 1) / kTile;
  dim3 grid((unsigned)(ntile * (ntile + 1) / 2), (unsigned)slices);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPairSmem);
  if (err != cudaSuccess) return (int)err;
  pairwise_kernel<T><<<grid, kThreads, kPairSmem, stream>>>(
      (const T*)F, (const int32_t*)bins, (const int32_t*)order, kept,
      (const double*)nfactor, d, (unsigned long long*)count, (double*)logm,
      (double*)sqrtm, (double*)lgam);
  return (int)cudaGetLastError();
}

}  // namespace

// Adds the rows' terms into the four zeroed (nbins, d, d) outputs.
// F: (R, d) int32 (f_is64 = 0) or int64 (1), row-major, R < 2^31; bins: (R,)
// int32; nfactor: (d,) f64 or null; counts: (nbins + 1,) int32 zeros and
// order: (R,) int32, both scratch; slices: row slices (grid.y), 1..65535;
// nbins <= 4096.
extern "C" int dsm_pairwise(const void* F, int f_is64, const void* bins,
                            const void* nfactor, long long R, int d,
                            int nbins, int slices, void* counts, void* order,
                            void* count, void* logm, void* sqrtm, void* lgam,
                            void* stream) {
  if (nbins < 1 || nbins > 4096 || slices < 1 || slices > 65535 || d < 1 ||
      R < 1 || R >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned sort_blocks = (unsigned)((R + kSortRows - 1) / kSortRows);
  int32_t* c = (int32_t*)counts;
  bin_count<<<sort_blocks, kSortBlock, nbins * 4, s>>>(
      (const int32_t*)bins, R, nbins, c);
  bin_offsets<<<1, 1, 0, s>>>(nbins, c);
  bin_scatter<<<sort_blocks, kSortBlock, 2 * nbins * 4, s>>>(
      (const int32_t*)bins, R, nbins, c, (int32_t*)order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return f_is64 ? launch_pairs<int64_t>(F, bins, order, c + nbins, nfactor, d,
                                        slices, count, logm, sqrtm, lgam, s)
                : launch_pairs<int32_t>(F, bins, order, c + nbins, nfactor, d,
                                        slices, count, logm, sqrtm, lgam, s);
}
