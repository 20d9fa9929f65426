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
// The sums are split so that only one of them is left a pair.  Over the
// rows of a bin, with a = log1p f or sqrt f and the column sums
// Q_j = sum a_j^2, C_j = sum f_j, N_j = #{f_j > 0}:
//   count  = #{rows where both are nonzero}    (popcount of two row masks)
//   log    = Q_j + Q_k - 2 sum a_j a_k         (a Gram product; sqrt alike)
//   lgamma = sum over the rows where BOTH are nonzero of
//            [lgamma(f_j+f_k+1) - lgamma(f_j+1) - lgamma(f_k+1)]
//            - (C_j + C_k) - (N_j + N_k - count)
// (a row with only f_j nonzero adds -f_j - 1 to the direct sum, which C and
// N carry; C and N are integers, exact in f64).  Every term of the direct
// lgamma sum is negative and at least 0.3 (s + 1) in size, so the split
// cancels nothing there.  Everything is f64; count is an integer.
//
// Three steps, one entry point:
//  1. fill_tables: the tables of lgamma(n + 1) and log1p(n) of step 2.
//     bin_count, bin_offsets, bin_scatter: a counting sort of the row
//     numbers by bin (a histogram in shared memory per block of rows, one
//     global atomicAdd a bin a block to reserve its range).  Rows of one bin
//     come out in no fixed order; rows whose bin is outside [0, nbins) are
//     left out.  counts[b] ends as bin b's end in the sorted order.
//  2. Two kernels on the same grid: a block (4 warps) owns one 32 x 32 tile
//     of (j, k) pairs of the upper triangle (blockIdx.x) and one slice of
//     the sorted rows (blockIdx.y), which it walks a bin's run at a time,
//     staging 32 rows of the run at a time in shared memory for the tile's
//     columns (32 on the diagonal, read as both sides; 32 + 32 elsewhere).
//     - gram_kernel stages log1p f and sqrt f, computed by the warp over the
//       nonzero entries only (step 1's table of log1p(n) for n < kLogTab),
//       and each column's Q in the staging thread's registers.  The two
//       Gram products run on the f64 tensor cores (mma.sync m8n8k4 f64;
//       wgmma has no f64 form): a warp holds a 16 x 16 quarter of the
//       tile of each in registers, a k-step is 4 staged rows, and a step
//       never mixes two bins, because a run's last step is padded with zero
//       rows.  At the run's end the block adds log = Q_j + Q_k - 2G (and
//       sqrt) into the output with f64 atomicAdd, through the guard (3.).
//     - both_kernel stages min(F, kBig) and lgamma(F + 1) (step 1's table
//       of lgamma(n + 1) for n < kTab, by the same device function), each
//       row's and each column's mask of nonzero entries, and each column's
//       C and N.  A warp owns 8 j columns and a lane one k column: count is
//       the popcount of the two columns' masks; the lgamma sum goes a row at
//       a time, the lane's k entry read once a row, then each of the warp's
//       j columns that is nonzero in the row (the same for the whole warp),
//       the table read only where both entries are nonzero.  At the run's
//       end it adds count and lgamma = sum - (C_j + C_k) - (N_j + N_k -
//       count) with 64-bit integer and f64 atomicAdd.
//     The two kernels are apart so that each holds at most 128 registers a
//     thread: 3 and 4 blocks an SM, where one kernel held ~250 and 2.
//  3. The cancellation guard, in gram_kernel's epilogue.  Q_j + Q_k - 2G
//     loses what the three sums' rounding leaves when the two samples are
//     near each other (a sample given twice gives Q_j = Q_k = G).  The f64
//     error of the run's value is at most E = (m + 40) 2^-53 (Q_j + Q_k +
//     2G) for a run of m rows (all terms are >= 0).  A pair whose E is above
//     1e-10 of its value (v - E) is not added: the block walks the run's
//     rows once more and adds the direct sum of (a_j - a_k)^2 for those
//     pairs alone.  So every value added is within 1e-10 of its own size,
//     and the total within 1e-10 of the matrix entry; duplicated columns
//     come out 0.
// The row slices of one pair and the rows of one bin meet in an order that
// changes from run to run, so the f64 sums agree between runs to rounding,
// not bit for bit; count is exact.
//
// What bounds it on an H100.  At 2^20 rows of 64 samples in 21 bins, 30%
// nonzero, the least time is the bytes' (F read once, 0.082 ms); the Gram
// products' terms where both entries are nonzero would take ~0.05 ms on the
// CUDA cores, the dense products 0.130 on the f64 tensor cores.  What sets
// this design's time (chip_smoke.distance_times) is both_kernel's lgamma
// sum: shared-memory reads, where a broadcast read costs the wavefronts of
// its width however few lanes want it (4 for 16 bytes), and where a row's
// reads chain.  The guard costs a second walk of a run for the whole block
// where any of its pairs trips it, so columns that are replicates of a few
// samples pay it in many runs though few of their pairs trip it.  At 5
// samples the two kernels' two walks of the rows cost more than the first
// design's one.  Tried and slower at 64 samples: one fused kernel (~250
// registers, 2 blocks an SM), rounds of four rows over the rows where j is
// nonzero, the warp's 8 j entries read as one 16-byte entry each with no
// branch, eight rows a round (spills).
// The first design of this file (one thread a pair, the two squared
// differences and the lgamma term of every pair with either entry nonzero
// on the CUDA cores) took 9.449 ms at that shape on an NVIDIA H100 80GB
// HBM3 at 700 W; a design before it, every bin's accumulators in shared
// memory, 37.7 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;                    // pair tile: kT x kT (j, k)
constexpr int kCols = 2 * kT;             // staged columns: j tile, k tile
constexpr int kCh = 32;                   // rows staged a step
constexpr int kPitch = kCols + 4;         // doubles a staged row (= 4 mod
                                          // 16: fragment loads conflict-free)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTab = 2048;                // lgamma(n + 1) table entries
constexpr int kLogTab = 1024;             // log1p(n) table entries
constexpr int kBig = 1 << 29;             // F past it is staged as kBig in xi
constexpr int kSortBlock = 256;           // threads of a sort block
constexpr int kSortRows = 4096;           // rows of a sort block
constexpr double kUnit = 1.1102230246251565e-16;   // 2^-53
constexpr double kRel = 1e-10;            // the guard's share of a value

// the Gram kernel's shared memory
struct GramSmem {
  double ltab[kLogTab];                   // log1p(n)
  double xl[kCh * kPitch];                // log1p f
  double xs[kCh * kPitch];                // sqrt f; at a run's end, the
                                          // column sums' partials
  double xf[kCh * kPitch];                // F
  double nf[kCols];                       // nfactor of each staged column
  uint16_t list[kWarps][kCh * 32 / 2];    // a warp's nonzero (row, column)s
};

// the count-and-lgamma kernel's shared memory
struct BothSmem {
  double tab[kTab];                       // lgamma(n + 1)
  double xlf[kCh * kPitch];               // lgamma(F + 1); at a run's end,
                                          // the column sums' partials
  int32_t xi[kCh * kPitch];               // min(F, kBig)
  uint32_t colbits[4][kCols];             // [row group][staged column]: the
                                          // rows where the column is nonzero
  uint32_t jmask[kCh];                    // [row]: the j side's columns
                                          // where the row is nonzero
};

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

// lgamma(n + 1) and log1p(n) of the small n, made once a call by
// fill_tables and copied by each block into its shared memory, so that no
// block spends its start on transcendentals.  Calls on two streams write the
// same values, so one may read while the other writes.
__device__ double g_lgam[kTab];
__device__ double g_log1p[kLogTab];

__global__ void fill_tables() {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < kTab) g_lgam[n] = lgamma(n + 1.0);
  if (n < kLogTab) g_log1p[n] = log1p((double)n);
}

// lgamma(f + 1) past the table, out of line: it is rare
__device__ __noinline__ double lgamma_big(double f) { return lgamma(f + 1.0); }

// c += a b over one k-step: an 8 x 4 by 4 x 8 product, an 8 x 8 sum.  The
// thread holds A[lane / 4][lane % 4], B[lane % 4][lane / 4] and C[lane / 4]
// [2 (lane % 4) + 0, 1].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// A block's tile (tj <= tk) of the upper triangle (blockIdx.x) and slice of
// the sorted rows (blockIdx.y), and how it stages them: a diagonal tile
// stages its 32 columns once and reads them as both sides (koff = 0); a
// thread stages one column c in every step-th row from rg, so that a warp's
// lanes are one side's 32 columns of one row.
struct Tile {
  int tj, tk, koff;
  bool diag;
  long long p0, p1;
  int ncols, step, nrow, c, rg, gcol;
  bool colok;
};

__device__ __forceinline__ Tile block_tile(int d, int nbins,
                                           const int32_t* ends) {
  Tile t;
  const int ntile = (d + kT - 1) / kT;
  int x = blockIdx.x, tj = 0;
  for (int len = ntile; x >= len; --len) {
    x -= len;
    ++tj;
  }
  t.tj = tj;
  t.tk = tj + x;
  t.diag = t.tj == t.tk;
  t.koff = t.diag ? 0 : kT;
  const long long M = ends[nbins];
  const long long per = (M + gridDim.y - 1) / gridDim.y;
  t.p0 = (long long)blockIdx.y * per;
  t.p1 = t.p0 + per < M ? t.p0 + per : M;
  t.ncols = t.diag ? kT : kCols;
  t.step = kThreads / t.ncols;
  t.nrow = kCh / t.step;
  t.c = threadIdx.x % t.ncols;
  t.rg = threadIdx.x / t.ncols;
  t.gcol = t.c < kT ? t.tj * kT + t.c : t.tk * kT + t.c - kT;
  t.colok = t.gcol < d;
  return t;
}

// the end of the run of one bin's rows that starts at pos
__device__ __forceinline__ long long run_end(const Tile& t, long long pos,
                                             const int32_t* bins,
                                             const int32_t* order,
                                             const int32_t* ends, int& b) {
  b = bins[order[pos]];
  return (long long)ends[b] < t.p1 ? (long long)ends[b] : t.p1;
}

// F of the thread's staged rows c0 + rg, c0 + rg + step, ... (0 past n)
template <typename T>
__device__ __forceinline__ void load_rows(const Tile& t, const T* F,
                                          const int32_t* order, int d,
                                          long long c0, int n,
                                          T (&v)[kCh / 2]) {
  long long at[kCh / 2];
#pragma unroll
  for (int i = 0; i < kCh / 2; ++i) {
    const int r = t.rg + t.step * i;
    at[i] = i < t.nrow && r < n && t.colok
                ? (long long)order[c0 + r] * d + t.gcol : -1;
  }
#pragma unroll
  for (int i = 0; i < kCh / 2; ++i) v[i] = at[i] >= 0 ? F[at[i]] : 0;
}

// The Gram products of log1p f and sqrt f, log and sqrt through the guard.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
gram_kernel(const T* __restrict__ F, const int32_t* __restrict__ bins,
            const int32_t* __restrict__ order,
            const int32_t* __restrict__ ends,
            const double* __restrict__ nfactor, int d, int nbins,
            double* __restrict__ out_log, double* __restrict__ out_sqrt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GramSmem& sm = *reinterpret_cast<GramSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool scaled = nfactor != nullptr;
  const Tile t = block_tile(d, nbins, ends);
  if (t.p0 >= t.p1) return;
  if (!scaled)
    for (int n = tid; n < kLogTab; n += kThreads) sm.ltab[n] = g_log1p[n];
  if (tid < t.ncols) sm.nf[tid] = scaled && t.colok ? nfactor[t.gcol] : 1.0;
  double q_log = 0.0, q_sqrt = 0.0;
  uint16_t* list = sm.list[warp];
  const unsigned below = (1u << lane) - 1u;

  // stage rows c0..c0+n-1 (zero rows up to kCh): F and the warp's list of
  // nonzero entries by the column's thread; log1p and sqrt by the warp over
  // the nonzero entries only; then the column sums by the column's thread
  auto stage = [&](long long c0, int n) {
    T v[kCh / 2];
    load_rows(t, F, order, d, c0, n, v);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kCh / 2; ++i) {
      if (i >= t.nrow) break;
      const int e = (t.rg + t.step * i) * kPitch + t.c;
      const bool nz = v[i] > 0;
      sm.xf[e] = nz ? (double)v[i] : 0.0;
      sm.xl[e] = 0.0;
      sm.xs[e] = 0.0;
      const unsigned m = __ballot_sync(0xffffffffu, nz);
      if (nz) list[cnt + __popc(m & below)] = (uint16_t)e;
      cnt += __popc(m);
    }
    __syncwarp();
    for (int x = lane; x < cnt; x += 32) {
      const int e = list[x];
      const double raw = sm.xf[e];
      if (scaled) {
        const double f = raw * sm.nf[e % kPitch];
        sm.xl[e] = log1p(f);
        sm.xs[e] = sqrt(f);
      } else {
        sm.xl[e] = raw < (double)kLogTab ? sm.ltab[(int)raw] : log1p(raw);
        sm.xs[e] = sqrt(raw);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kCh / 2; ++i) {
      if (i >= t.nrow) break;
      const int e = (t.rg + t.step * i) * kPitch + t.c;
      q_log += sm.xl[e] * sm.xl[e];
      q_sqrt += sm.xs[e] * sm.xs[e];
    }
  };

  // warp w holds the quarter (jw.., kw..) of the tile, 2 x 2 fragments of
  // 8 x 8 a product
  const int gid = lane >> 2, tig = lane & 3;
  const int jw = 16 * (warp >> 1), kw = 16 * (warp & 1);
  const bool mma_on = !(t.diag && jw > kw);   // wholly below the diagonal
  double acc[2][2][2][2];

  long long pos = t.p0;
  while (pos < t.p1) {
    int b;
    const long long lo = pos, hi = run_end(t, pos, bins, order, ends, b);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
          acc[q][i][i2][0] = acc[q][i][i2][1] = 0.0;
    q_log = q_sqrt = 0.0;

    for (long long c0 = lo; c0 < hi; c0 += kCh) {
      const int n = hi - c0 < kCh ? (int)(hi - c0) : kCh;
      __syncthreads();   // the table is filled; the last rows are consumed
      stage(c0, n);
      __syncthreads();
      if (!mma_on) continue;
      for (int s = 0; s < (n + 3) / 4; ++s) {
        const int row = (4 * s + tig) * kPitch + gid;
        double a[2][2], bk[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ja = row + jw + 8 * i, kb = row + t.koff + kw + 8 * i;
          a[0][i] = sm.xl[ja];
          a[1][i] = sm.xs[ja];
          bk[0][i] = sm.xl[kb];
          bk[1][i] = sm.xs[kb];
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int i2 = 0; i2 < 2; ++i2)
              dmma(acc[q][i][i2], a[q][i], bk[q][i2]);
      }
    }

    // the run's epilogue: the column sums through xs' room
    __syncthreads();
    double(*part)[2][kCols] = reinterpret_cast<double(*)[2][kCols]>(sm.xs);
    part[t.rg][0][t.c] = q_log;
    part[t.rg][1][t.c] = q_sqrt;
    __syncthreads();
    const double m_err = (double)(hi - lo + 40) * kUnit;
    unsigned flags = 0;   // bit (i, i2, e) + 8 q: the direct sum is needed
    if (mma_on) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = jw + 8 * i + gid, kl = kw + 8 * i2 + 2 * tig + e;
            const int j = t.tj * kT + jl, k = t.tk * kT + kl;
            if (k >= d || j >= k) continue;
            const long long o = ((long long)b * d + j) * d + k;
            double* outs[2] = {out_log, out_sqrt};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              double qj = 0.0, qk = 0.0;
              for (int g = 0; g < t.step; ++g) {
                qj += part[g][q][jl];
                qk += part[g][q][t.koff + kl];
              }
              const double g = acc[q][i][i2][e];
              const double v = qj + qk - 2.0 * g;
              const double err = m_err * (qj + qk + 2.0 * g);
              if (err <= kRel * (v - err)) {
                if (v != 0.0) atomicAdd(outs[q] + o, v);
              } else {
                flags |= 1u << (((i * 2 + i2) * 2 + e) + 8 * q);
              }
            }
          }
    }

    // the guard's pairs: the direct sum over the run's rows once more
    if (__syncthreads_or(flags != 0)) {
      double dsum[2][8] = {};
      for (long long c0 = lo; c0 < hi; c0 += kCh) {
        const int n = hi - c0 < kCh ? (int)(hi - c0) : kCh;
        __syncthreads();
        stage(c0, n);
        __syncthreads();
        if (!flags) continue;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int i = x >> 2, i2 = (x >> 1) & 1, e = x & 1;
          const int jl = jw + 8 * i + gid;
          const int kl = t.koff + kw + 8 * i2 + 2 * tig + e;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (!((flags >> (x + 8 * q)) & 1u)) continue;
            const double* xa = q ? sm.xs : sm.xl;
            double s = dsum[q][x];
            for (int r = 0; r < n; ++r) {
              const double dv = xa[r * kPitch + jl] - xa[r * kPitch + kl];
              s += dv * dv;
            }
            dsum[q][x] = s;
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = x >> 2, i2 = (x >> 1) & 1, e = x & 1;
        const int j = t.tj * kT + jw + 8 * i + gid;
        const int k = t.tk * kT + kw + 8 * i2 + 2 * tig + e;
        const long long o = ((long long)b * d + j) * d + k;
        if ((flags >> x) & 1u && dsum[0][x] != 0.0)
          atomicAdd(out_log + o, dsum[0][x]);
        if ((flags >> (x + 8)) & 1u && dsum[1][x] != 0.0)
          atomicAdd(out_sqrt + o, dsum[1][x]);
      }
    }
    pos = hi;
  }
}

// count, and (with_lgamma != 0) the lgamma matrix: a warp owns 8 j
// columns and a lane one k column of the tile
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
both_kernel(const T* __restrict__ F, const int32_t* __restrict__ bins,
            const int32_t* __restrict__ order,
            const int32_t* __restrict__ ends, int d, int nbins,
            int with_lgamma, unsigned long long* __restrict__ out_count,
            double* __restrict__ out_lgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BothSmem& sm = *reinterpret_cast<BothSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = block_tile(d, nbins, ends);
  if (t.p0 >= t.p1) return;
  if (with_lgamma)
    for (int n = tid; n < kTab; n += kThreads) sm.tab[n] = g_lgam[n];
  double c_sum = 0.0, n_sum = 0.0;

  // stage rows c0..c0+n-1: lgamma(F + 1) and min(F, kBig), the rows' (j
  // side) and the column's masks, C and N by the column's thread
  auto stage = [&](long long c0, int n) {
    T v[kCh / 2];
    load_rows(t, F, order, d, c0, n, v);
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kCh / 2; ++i) {
      if (i >= t.nrow) break;
      const int r = t.rg + t.step * i;
      const bool nz = v[i] > 0;
      bits |= (nz ? 1u : 0u) << r;
      const int e = r * kPitch + t.c;
      sm.xi[e] = nz ? (v[i] < (T)kBig ? (int32_t)v[i] : kBig) : 0;
      sm.xlf[e] = !nz || !with_lgamma ? 0.0
                  : v[i] < (T)kTab ? sm.tab[(int)v[i]]
                                   : lgamma_big((double)v[i]);
      const unsigned m = __ballot_sync(0xffffffffu, nz);
      if (lane == 0 && t.c < kT) sm.jmask[r] = m;
      c_sum += nz ? (double)v[i] : 0.0;
      n_sum += nz ? 1.0 : 0.0;
    }
    sm.colbits[t.rg][t.c] = bits;
  };
  auto colbits = [&](int col) {
    unsigned m = 0;
    for (int g = 0; g < t.step; ++g) m |= sm.colbits[g][col];
    return m;
  };

  // a warp's j columns jb..jb+7; on a diagonal tile of at most 16 valid
  // columns, `share` warps have the same ones and take every share-th row
  // from rstart
  const int vcols = d - t.tj * kT;
  const int share = !t.diag || vcols > 16 ? 1 : vcols > 8 ? 2 : kWarps;
  const int owners = kWarps / share;
  const int jb = 8 * (warp % owners), rstart = warp / owners;
  // bit x: the pair (jb + x, lane) is above the diagonal
  const unsigned upper8 =
      !t.diag ? 0xffu : lane > jb ? (1u << min(lane - jb, 8)) - 1u : 0u;
  double lsum[8];
  int cnt[8];

  long long pos = t.p0;
  while (pos < t.p1) {
    int b;
    const long long lo = pos, hi = run_end(t, pos, bins, order, ends, b);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      lsum[x] = 0.0;
      cnt[x] = 0;
    }
    c_sum = n_sum = 0.0;

    for (long long c0 = lo; c0 < hi; c0 += kCh) {
      const int n = hi - c0 < kCh ? (int)(hi - c0) : kCh;
      __syncthreads();   // the table is filled; the last rows are consumed
      stage(c0, n);
      __syncthreads();
      // count from the columns' row masks
      const unsigned kbits = colbits(t.koff + lane);
      if (rstart == 0)
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (!t.diag || lane >= jb + x)
            cnt[x] += __popc(colbits(jb + x) & kbits);
      if (!with_lgamma) continue;
      // the lgamma sum, a row at a time: the lane's k entry read once a
      // row, then each of the warp's 8 j columns that is nonzero in the row
      // (the same for the whole warp), the table read only where both
      // entries are nonzero; a sum past the table is added after the row
      for (int r = rstart; r < n; r += share) {
        const unsigned mj = (sm.jmask[r] >> jb) & 0xffu;
        if (!mj) continue;   // the same for the whole warp
        const int row = r * kPitch;
        const int fk = sm.xi[row + t.koff + lane];
        const double lfk = sm.xlf[row + t.koff + lane];
        unsigned big = 0;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          if (!((mj >> x) & 1u)) continue;
          const int fj = sm.xi[row + jb + x];
          const double lfj = sm.xlf[row + jb + x];
          const int s = fj + fk;
          const bool both = ((upper8 >> x) & 1u) && fk > 0;
          if (both && s >= kTab) big |= 1u << x;
          if (both && s < kTab) lsum[x] += sm.tab[s] - (lfj + lfk);
        }
        if (big) {
          const long long at = (long long)order[c0 + r] * d;
#pragma unroll
          for (int x = 0; x < 8; ++x)
            if ((big >> x) & 1u)
              lsum[x] += lgamma_big((double)F[at + t.tj * kT + jb + x] +
                                    (double)F[at + t.tk * kT + lane]) -
                         (sm.xlf[row + jb + x] + lfk);
        }
      }
    }

    // the run's epilogue: the column sums, and the sums of warps that share
    // j columns, through xlf's room
    __syncthreads();
    double(*part)[2][kCols] = reinterpret_cast<double(*)[2][kCols]>(sm.xlf);
    double(*shared)[8][32] =
        reinterpret_cast<double(*)[8][32]>(sm.xlf + 4 * 2 * kCols);
    part[t.rg][0][t.c] = c_sum;
    part[t.rg][1][t.c] = n_sum;
    if (share > 1)
#pragma unroll
      for (int x = 0; x < 8; ++x) shared[warp][x][lane] = lsum[x];
    __syncthreads();
    if (rstart != 0) {
      pos = hi;
      continue;
    }
    if (share > 1)
#pragma unroll
      for (int x = 0; x < 8; ++x)
        for (int w = warp + owners; w < kWarps; w += owners)
          lsum[x] += shared[w][x][lane];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int jl = jb + x, j = t.tj * kT + jl, k = t.tk * kT + lane;
      if (k >= d || j > k) continue;
      const long long o = ((long long)b * d + j) * d + k;
      if (cnt[x]) atomicAdd(out_count + o, (unsigned long long)cnt[x]);
      if (!with_lgamma || j == k) continue;
      double cj = 0.0, ck = 0.0, nj = 0.0, nk = 0.0;
      for (int g = 0; g < t.step; ++g) {
        cj += part[g][0][jl];
        ck += part[g][0][t.koff + lane];
        nj += part[g][1][jl];
        nk += part[g][1][t.koff + lane];
      }
      if (nj + nk > 0.0)
        atomicAdd(out_lgamma + o,
                  lsum[x] - (cj + ck) - (nj + nk - (double)cnt[x]));
    }
    pos = hi;
  }
}

template <typename T>
int launch_pairs(const void* F, const void* bins, const void* order,
                 const int32_t* ends, const void* nfactor, int d, int nbins,
                 int slices, void* count, void* logm, void* sqrtm, void* lgam,
                 cudaStream_t stream) {
  int ntile = (d + kT - 1) / kT;
  dim3 grid((unsigned)(ntile * (ntile + 1) / 2), (unsigned)slices);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(GramSmem));
  if (err != cudaSuccess) return (int)err;
  gram_kernel<T><<<grid, kThreads, sizeof(GramSmem), stream>>>(
      (const T*)F, (const int32_t*)bins, (const int32_t*)order, ends,
      (const double*)nfactor, d, nbins, (double*)logm, (double*)sqrtm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(both_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(BothSmem));
  if (err != cudaSuccess) return (int)err;
  both_kernel<T><<<grid, kThreads, sizeof(BothSmem), stream>>>(
      (const T*)F, (const int32_t*)bins, (const int32_t*)order, ends, d,
      nbins, nfactor == nullptr, (unsigned long long*)count, (double*)lgam);
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
  fill_tables<<<kTab / kSortBlock, kSortBlock, 0, s>>>();
  bin_count<<<sort_blocks, kSortBlock, nbins * 4, s>>>(
      (const int32_t*)bins, R, nbins, c);
  bin_offsets<<<1, 1, 0, s>>>(nbins, c);
  bin_scatter<<<sort_blocks, kSortBlock, 2 * nbins * 4, s>>>(
      (const int32_t*)bins, R, nbins, c, (int32_t*)order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return f_is64 ? launch_pairs<int64_t>(F, bins, order, c, nfactor, d, nbins,
                                        slices, count, logm, sqrtm, lgam, s)
                : launch_pairs<int32_t>(F, bins, order, c, nfactor, d, nbins,
                                        slices, count, logm, sqrtm, lgam, s);
}
