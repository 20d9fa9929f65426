// The stats step of one trie level: per-node segment statistics, the output
// gates, and the level's sums, in one launch.
//
// Replaces the stats block of dsm_tpu/mining/engine_device.py _level_single
// (:726-787: the (6+nwin, B) cumsum + forward cummax + reverse cummin
// segment broadcasts, the int32 fixed-point entropy windows _nln_windows_w,
// and the level's total_paths, ent_min/ent_max, child_total and pair_count
// taken in the same block).  Those broadcasts existed because the TPU has
// no int64 and no f64; here a node's pairs are the contiguous range
// [nb[n], nb[n+1]) (at most MAX_SAMPLES = 512 of them) and the sums are
// exact: the int64 frequency sum, the f64 sum of (f+1)*log(f+1)/log(2), the
// per-symbol counts of active children and the number of active readers.
//
// Outputs per node: flags (bit 0 present, bit 1 counts for the entropy
// min/max, bit 2 gated for output, bits 4-7 the existing child symbols)
// and the f64 entropy; per pair: the node's output gate.  The gate is a
// prefilter with a margin on the entropy window, as on the TPU; the host
// drain re-gates in f64 with the reference's expression shapes.  Per level,
// six f64 values (`sums`): the kept lanes (popcount of cbits & sym_mask over
// pairs), the children (popcount of the exists bits over nodes), the pairs
// of gated nodes, the present nodes, and the minimum and maximum entropy
// over the nodes with bit 1 (+inf and -inf when there is none).  Counts are
// far below 2^53, so f64 holds them exactly and one readback takes all six.
//
// What bounds it on an H100: bytes (per pair 4 + 1 read and 1 written, per
// node 4 + 4 + 8 + 4) near 14 us at 4.2M pairs, and the f64 log and
// divisions of every pair and node (tens of f64 instructions each); in
// practice the latency of a tile's chain of loads, hidden only by the
// blocks in flight.  The design:
//
//   * Node tiles.  A block takes tiles of `tile` consecutive nodes (512,
//     halved where nodes are wide, so that a tile holds about 7/8 of
//     kChunk pairs) on a grid the card holds at once.  A tile's pairs are
//     the contiguous range [nb[n0], nb[n0 + tile]); the block cuts it at
//     node boundaries into chunks of at most kChunk pairs (no node spans
//     two), stages a chunk with coalesced loads of freq and cact into
//     shared memory, and the thread that loads a pair computes its term
//     there (pair-parallel: a warp never waits on a node's chain of logs).
//     The term of f < kLut comes from a table the kernel makes once a
//     device with the same expression, so it is bit-equal to the computed
//     one and the log leaves the common case.
//   * A node of at most kWide pairs is summed by a thread from shared
//     memory in ascending pair order, so its entropy is bit-equal to a
//     sequential sum (the plain version's on the CPU).  A wider node (the
//     collections near the reference's 273 readers) goes on the chunk's
//     list, which the warps share out: a warp's lanes stride over its
//     pairs and meet in a butterfly of shuffles, a fixed order (the same
//     input gives the same bits) within 1e-9 of a sequential sum.
//   * pair_out: each node's thread (or warp) writes its gate over its
//     pairs in shared memory, and the block stores the chunk's bytes
//     coalesced.  Every pair is written, so no memset comes first.
//   * The level's sums: each thread adds its staged pairs' kept lanes and
//     its nodes' children, present nodes, gated pairs and entropy range;
//     the block reduces them and adds them to the level's running sums
//     with integer atomics (the entropy range as order-preserving keys),
//     exact whatever the order of the blocks; the last block to finish (a
//     ticket) writes `sums` and zeroes the running sums and the ticket for
//     the next launch, which spares a memset a level.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 512;  // the most nodes a tile
constexpr int kMinTile = 32;   // the fewest
constexpr int kChunk = 2048;   // pairs a block stages at once
constexpr int kWide = 64;      // a node of more pairs is summed by a warp
constexpr int kLut = 4096;     // terms tabulated for f < kLut
constexpr int kMaxDevices = 64;
constexpr double kLog2 = 0.69314718055994530942;

struct Gates {
  int depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask;
  double emin_lo, emax_hi;  // emin - margin, emax + margin
};

// A node's running sums.  cnt: the four child-symbol counts in 16-bit
// fields (a node holds at most kChunk pairs).
struct Acc {
  int nact;
  long long sumf;
  double nln;
  unsigned long long cnt;
};

// The level's sums a thread gathers from the pairs it stages and the nodes
// it finalises.
struct Sums {
  unsigned kept, child, present, gated_pairs;
  double emin, emax;
};

// (f+1)log(f+1)/log 2 for 0 <= f < kLut, 0 at f = 0
__device__ double g_term[kLut];

__device__ __forceinline__ double nln_term(int f) {
  const double f1 = (double)f + 1.0;
  return (f1 * log(f1)) / kLog2;
}

__global__ void term_table_kernel() {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < kLut) g_term[f] = f > 0 ? nln_term(f) : 0.0;
}

__device__ __forceinline__ double pair_term(int f) {
  if ((unsigned)f < (unsigned)kLut) return g_term[f];
  return nln_term(f);
}

__device__ __forceinline__ double pos_inf() {
  return __longlong_as_double(0x7FF0000000000000ll);
}

__device__ __forceinline__ unsigned long long spread4(unsigned b) {
  return (unsigned long long)(b & 1u) |
         ((unsigned long long)(b & 2u) << 15) |
         ((unsigned long long)(b & 4u) << 30) |
         ((unsigned long long)(b & 8u) << 45);
}

// A staged pair into a node's sums.
__device__ __forceinline__ void add_pair(Acc& a, int f, double term,
                                         unsigned bits) {
  if (f > 0) {
    ++a.nact;
    a.sumf += f;
    a.nln += term;
  }
  a.cnt += spread4(bits);
}

// A double's order as an unsigned key: a < b iff key(a) < key(b), and 0 is
// below every key, so 0 stands for "none yet".
__device__ __forceinline__ unsigned long long order_key(double d) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(d);
  return (b >> 63) ? ~b : b | 0x8000000000000000ull;
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double((long long)((k >> 63) ? k & ~0x8000000000000000ull
                                                     : ~k));
}

// A node's flags, entropy and gate from its sums: writes them and adds the
// node's share of the level's sums.
__device__ __forceinline__ bool finalise(const Acc& a, int npairs,
                                         const Gates& g, long long n,
                                         int32_t* flags, double* ent,
                                         Sums& sums) {
  int exists = 0, numchildren = 0, sum_ex = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int cnt = (int)((a.cnt >> (16 * c)) & 0xFFFFu);
    if (cnt > 0 && ((g.sym_mask >> c) & 1)) {
      exists |= 1 << c;
      ++numchildren;
      sum_ex += cnt;
    }
  }
  bool single_full = numchildren == 1 && sum_ex == a.nact;
  double sum_n = (double)((long long)g.s_total + a.sumf);
  double h = log(sum_n) / kLog2 - a.nln / sum_n;
  bool present = a.nact > 0 && g.depth >= 1;
  bool egate = !g.use_egate || (h >= g.emin_lo && h <= g.emax_hi);
  bool gated = present && g.depth >= g.mindepth && a.nact >= g.pmin &&
               (g.pmax == 0 || a.nact <= g.pmax) && egate && !single_full;
  bool stat = present && !(a.nact == 1 && g.pmin > 1);
  flags[n] = (int)present | ((int)stat << 1) | ((int)gated << 2) |
             (exists << 4);
  ent[n] = h;
  sums.child += numchildren;
  sums.present += present;
  sums.gated_pairs += gated ? npairs : 0;
  if (stat) {
    sums.emin = fmin(sums.emin, h);
    sums.emax = fmax(sums.emax, h);
  }
  return gated;
}

__global__ void __launch_bounds__(kThreads)
segstats_kernel(const int32_t* __restrict__ nb,
                const int32_t* __restrict__ freq,
                const uint8_t* __restrict__ cact, long long n_nodes, int tile,
                Gates g, int32_t* __restrict__ flags,
                double* __restrict__ ent, uint8_t* __restrict__ pair_out,
                unsigned long long* __restrict__ state,
                double* __restrict__ sums) {
  __shared__ int s_nb[kMaxTile + 1];
  __shared__ double s_term[kChunk];
  __shared__ int s_f[kChunk];
  __shared__ uint8_t s_b[kChunk];  // the chunk's cact, then its gates
  __shared__ int s_wide[kChunk / (kWide + 1) + 1];
  __shared__ int s_nwide;
  __shared__ unsigned s_red[kWarps][4];
  __shared__ double s_redd[kWarps][2];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Sums acc{0, 0, 0, 0, pos_inf(), -pos_inf()};
  const long long n_tiles = (n_nodes + tile - 1) / tile;
  for (long long ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const long long n0 = ti * tile;
    const int cnt = (int)min((long long)tile, n_nodes - n0);
    for (int i = t; i <= cnt; i += kThreads) s_nb[i] = nb[n0 + i];
    __syncthreads();
    for (int m = 0; m < cnt;) {
      // the chunk: nodes [m, m1), the most whose pairs fit in kChunk
      const int c0 = s_nb[m];
      int lo = m + 1, hi = cnt;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_nb[mid] - c0 <= kChunk) lo = mid; else hi = mid - 1;
      }
      const int m1 = lo, c1 = s_nb[m1];
      if (c1 - c0 > kChunk) __trap();  // a node of more than kChunk pairs
      for (int p = c0 + t; p < c1; p += kThreads) {
        const int f = freq[p];
        const unsigned b = cact[p];
        s_f[p - c0] = f;
        s_term[p - c0] = pair_term(f);
        s_b[p - c0] = (uint8_t)b;
        acc.kept += __popc(b & (unsigned)g.sym_mask);
      }
      if (t == 0) s_nwide = 0;
      __syncthreads();
      // a narrow node by its thread; a wide one onto the warps' list
      for (int k = m + t; k < m1; k += kThreads) {
        const int s = s_nb[k], e = s_nb[k + 1];
        if (e - s > kWide) {
          s_wide[atomicAdd(&s_nwide, 1)] = k;
          continue;
        }
        Acc a{0, 0, 0.0, 0};
        for (int p = s; p < e; ++p)
          add_pair(a, s_f[p - c0], s_term[p - c0], s_b[p - c0]);
        const uint8_t v = finalise(a, e - s, g, n0 + k, flags, ent, acc);
        for (int p = s; p < e; ++p) s_b[p - c0] = v;
      }
      __syncthreads();
      for (int j = warp; j < s_nwide; j += kWarps) {
        const int k = s_wide[j], s = s_nb[k], e = s_nb[k + 1];
        Acc x{0, 0, 0.0, 0};
        for (int p = s + lane; p < e; p += 32)
          add_pair(x, s_f[p - c0], s_term[p - c0], s_b[p - c0]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          x.nact += __shfl_xor_sync(0xFFFFFFFFu, x.nact, o);
          x.sumf += __shfl_xor_sync(0xFFFFFFFFu, x.sumf, o);
          x.nln += __shfl_xor_sync(0xFFFFFFFFu, x.nln, o);
          x.cnt += __shfl_xor_sync(0xFFFFFFFFu, x.cnt, o);
        }
        int v = 0;
        if (lane == 0) v = finalise(x, e - s, g, n0 + k, flags, ent, acc);
        v = __shfl_sync(0xFFFFFFFFu, v, 0);
        for (int p = s + lane; p < e; p += 32) s_b[p - c0] = (uint8_t)v;
      }
      __syncthreads();
      for (int p = c0 + t; p < c1; p += kThreads) pair_out[p] = s_b[p - c0];
      __syncthreads();  // the chunk is stored before the next is staged
      m = m1;
    }
  }

  // the block's sums into the level's: exact integer atomics (the entropy
  // range as order keys), then the last block to finish (a ticket) turns
  // them into `sums` and zeroes them and the ticket for the next launch
  unsigned v4[4] = {acc.kept, acc.child, acc.gated_pairs, acc.present};
  double emin = acc.emin, emax = acc.emax;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v4[i] += __shfl_xor_sync(0xFFFFFFFFu, v4[i], o);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    emin = fmin(emin, __shfl_xor_sync(0xFFFFFFFFu, emin, o));
    emax = fmax(emax, __shfl_xor_sync(0xFFFFFFFFu, emax, o));
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s_red[warp][i] = v4[i];
    s_redd[warp][0] = emin;
    s_redd[warp][1] = emax;
  }
  __syncthreads();
  if (t != 0) return;
  unsigned long long r[4] = {0, 0, 0, 0};
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] += s_red[w][i];
    emin = fmin(emin, s_redd[w][0]);
    emax = fmax(emax, s_redd[w][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r[i]) atomicAdd(state + 1 + i, r[i]);
  if (emax >= emin) {  // the block has a node with F_STAT
    atomicMax(state + 5, order_key(emax));
    atomicMax(state + 6, ~order_key(emin));
  }
  __threadfence();
  if (atomicAdd(state, 1ull) != gridDim.x - 1) return;
  __threadfence();
  volatile unsigned long long* vs = state;
#pragma unroll
  for (int i = 0; i < 4; ++i) sums[i] = (double)vs[1 + i];
  const unsigned long long hi = vs[5], lo = vs[6];
  sums[4] = lo ? key_value(~lo) : pos_inf();
  sums[5] = hi ? key_value(hi) : -pos_inf();
  for (int i = 0; i < 7; ++i) vs[i] = 0;  // every block of this launch is done
}

}  // namespace

// nb: (n_nodes + 1,) int32; freq: (n_pairs,) int32; cact, pair_out:
// (n_pairs,) uint8; flags: (n_nodes,) int32; ent: (n_nodes,) f64; state: 7
// uint64 (a ticket and the level's running sums) that are 0 at the launch
// and 0 again when the kernel ends, used by one stream at a time; sums: 6
// f64.  n_nodes >= 1; a node holds at most kChunk pairs (MAX_SAMPLES = 512
// in the port), else the launch stops with a fault.
extern "C" int dsm_segstats(const void* nb, const void* freq, const void* cact,
                            long long n_nodes, long long n_pairs, int depth,
                            int s_total, int mindepth, int pmin, int pmax,
                            int use_egate, int sym_mask, double emin_lo,
                            double emax_hi, void* flags, void* ent,
                            void* pair_out, void* state, void* sums,
                            void* stream) {
  if (n_nodes < 1 || n_pairs < 0) return (int)cudaErrorInvalidValue;
  // once a device: the blocks the card holds at once, and the term table
  // (made on the launch's stream, waited for once)
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, segstats_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    term_table_kernel<<<(kLut + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>();
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaStreamSynchronize((cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = sms * per_sm;
  }
  // the tile: kMaxTile nodes, halved while a tile would hold more than 7/8
  // of kChunk pairs on average
  long long tile = kMaxTile;
  while (tile > kMinTile && 8 * tile * n_pairs > 7ll * kChunk * n_nodes)
    tile /= 2;
  Gates g{depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask,
          emin_lo, emax_hi};
  long long blocks = (n_nodes + tile - 1) / tile;
  if (blocks > resident[dev]) blocks = resident[dev];
  segstats_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nb, (const int32_t*)freq, (const uint8_t*)cact, n_nodes,
      (int)tile, g, (int32_t*)flags, (double*)ent, (uint8_t*)pair_out,
      (unsigned long long*)state, (double*)sums);
  return (int)cudaGetLastError();
}
