// The per-level engines' analyse-and-compact step (K13): from a dense
// level's per-node sums, the right-branching flag of every node and the
// next frontier, the union children of each prefix row compacted in
// (node, symbol) order.
//
// Replaces dsm_tpu/mining/engine.py analyze_children + compact_children
// (:335-379) as _level_step_impl (:382) and, a row each under a vmap,
// parallel/engine_sharded.py _sharded_step_impl (:125) run them.  For row
// r, node u and symbol c (A, C, G, T), union(r, u, c) = child_counts > 0
// and sym_mask[r, c]; single_full(r, u) = exactly one union child and its
// count equal to the node's active samples.  The union flags of a row, in
// flat order u * 4 + c, are compacted stably: the j-th set flag (j < CAP)
// gives parent_row[j] = u, sym[j] = c, valid[j] = 1 and the next state's
// row j, the child's S-wide (lo, hi, rlo) where its cell is active, else
// 0; child_count[r] is the number of set flags, past CAP when the level
// overflows (the host then regrows and redoes it).  Rows j from the count
// on (j < CAP) hold what dsm_tpu's stable argsort leaves there: the flags
// that are NOT set, in flat order, as parent_row and sym, with valid 0 and
// a zero state.
//
// The TPU did it with one argsort of the R x CAP x 4 flags and gathers.  On
// Hopper it is one pass with a decoupled look-back (lookback.cuh) a row: a
// tile is 1,024 nodes (4,096 flags) of one row, four nodes a thread; the
// tiles are handed out in order by an atomic counter to a persistent grid
// (as many blocks as the card holds at once), each row's first tile
// publishes a prefix, so a look-back never leaves its row.  A tile lists
// its set flags in shared memory, learns their first rank from the look-
// back, and writes their parent_row, sym, valid and S-wide rows (a thread
// a sample column, so the copies are coalesced).  When every tile is
// taken, each block learns the rows' counts by a look-back from past each
// row's last tile, block 0 writes child_count, and the grid fills rows from
// the count on: the zero state, and the unset flags' ranks (from the
// tile's look-back and a block scan) for the tiles whose unset flags reach
// below CAP.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNodesPer = 4;                     // nodes a thread
constexpr int kTileNodes = kThreads * kNodesPer;
constexpr int kTileFlags = kTileNodes * 4;
constexpr int kSumCols = 5;   // ops/level.py: active samples, then A C G T
constexpr int kMaxRows = 1024;                   // ops/level.py MAX_ROWS

struct Args {
  const int32_t* sums;                   // (R, CAP, 5)
  const uint8_t* sym_mask;               // (R, 4) bool
  const int32_t* clo;                    // (R, CAP, 4, S)
  const int32_t* chi;
  const int32_t* crlo;
  const uint8_t* cact;
  int R, S;
  long long cap;
  int32_t* lo;                           // (R, CAP, S)
  int32_t* hi;
  int32_t* rlo;
  uint8_t* valid;                        // (R, CAP)
  int32_t* parent_row;                   // (R, CAP)
  int32_t* sym;
  int32_t* child_count;                  // (R,)
  uint8_t* single_full;                  // (R, CAP)
  unsigned long long* status;            // ntiles words, then the counter
  long long tpr, ntiles;                 // tiles a row, in all
};

// The union flags of this thread's four nodes of tile k of row r (bit
// 4j + c for node j, symbol c; none for nodes past CAP); with write_sf the
// nodes' single_full written too.
__device__ __forceinline__ unsigned node_flags(const Args& a, int r,
                                               long long k, bool write_sf) {
  unsigned sm = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) sm |= (a.sym_mask[r * 4 + c] ? 1u : 0u) << c;
  const long long u0 = k * kTileNodes + (long long)threadIdx.x * kNodesPer;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kNodesPer; ++j) {
    const long long u = u0 + j;
    if (u >= a.cap) break;
    const int32_t* sm5 = a.sums + ((long long)r * a.cap + u) * kSumCols;
    int32_t cc[4];
    unsigned f = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cc[c] = sm5[1 + c];
      f |= (cc[c] > 0 ? 1u : 0u) << c;
    }
    f &= sm;
    bits |= f << (4 * j);
    if (write_sf) {
      const int first = f ? __ffs(f) - 1 : 0;
      int32_t pick = cc[0];
#pragma unroll
      for (int c = 1; c < 4; ++c)
        if (c == first) pick = cc[c];
      a.single_full[(long long)r * a.cap + u] =
          (uint8_t)(__popc(f) == 1 && pick == sm5[0]);
    }
  }
  return bits;
}

// Exclusive block scan of `cnt`: this thread's first slot and the block's
// total.  All threads call it.
__device__ __forceinline__ int block_scan(int cnt, int* warp_sum,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int slot = incl - cnt, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) slot += warp_sum[w];
    all += warp_sum[w];
  }
  *total = all;
  return slot;
}

__global__ void __launch_bounds__(kThreads) level_compact_kernel(const Args a) {
  __shared__ uint16_t list[kTileFlags];  // a tile's set flags, in order
  __shared__ int warp_sum[kWarps];
  __shared__ long long tile_sh;
  __shared__ unsigned long long excl_sh;
  __shared__ long long total_sh[kMaxRows];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* next_tile = a.status + a.ntiles;
  const long long S = a.S;

  for (;;) {
    if (t == 0) tile_sh = (long long)atomicAdd(next_tile, 1ull);
    __syncthreads();
    const long long tile = tile_sh;
    if (tile >= a.ntiles) break;
    const int r = (int)(tile / a.tpr);
    const long long k = tile - (long long)r * a.tpr;

    const unsigned bits = node_flags(a, r, k, true);
    int kept;
    int slot = block_scan(__popc(bits), warp_sum, &kept);
    if (t == 0) {
      dsm::put(a.status + tile,
               (k == 0 ? dsm::kPrefix : dsm::kAggregate) | (unsigned)kept);
      if (k == 0) excl_sh = 0;
    }
    for (unsigned b = bits; b; b &= b - 1)
      list[slot++] = (uint16_t)(t * 16 + __ffs(b) - 1);
    if (warp == 0 && k > 0) {
      const unsigned long long e = dsm::lookback_exclusive(a.status, tile);
      if (lane == 0) {
        dsm::put(a.status + tile, dsm::kPrefix | (unsigned)(e + kept));
        excl_sh = e;
      }
    }
    __syncthreads();
    const long long excl = (long long)excl_sh;
    const long long room = a.cap - excl;
    const int nk = room <= 0 ? 0 : (room < kept ? (int)room : kept);
    const long long row0 = (long long)r * a.cap;
    for (int e = t; e < nk; e += kThreads) {
      const long long f = k * kTileFlags + list[e];
      const long long j = row0 + excl + e;
      a.parent_row[j] = (int32_t)(f >> 2);
      a.sym[j] = (int32_t)(f & 3);
      a.valid[j] = 1;
    }
    // the kept children's S-wide rows, a thread a sample column
    const long long W = (long long)nk * S;
    for (long long e = t; e < W; e += kThreads) {
      const long long i = e / S;
      const long long s = e - i * S;
      const long long f = k * kTileFlags + list[i];
      const long long src = (row0 * 4 + f) * S + s;   // (r, u, c, s)
      const long long dst = (row0 + excl + i) * S + s;
      const bool keep = a.cact[src] != 0;
      a.lo[dst] = keep ? a.clo[src] : 0;
      a.hi[dst] = keep ? a.chi[src] : 0;
      a.rlo[dst] = keep ? a.crlo[src] : 0;
    }
    __syncthreads();
  }

  // ---- every tile is taken: each row's count ---------------------------
  if (warp == 0) {
    for (int r = 0; r < a.R; ++r) {
      const unsigned long long e =
          dsm::lookback_exclusive(a.status, (long long)(r + 1) * a.tpr);
      if (lane == 0) total_sh[r] = (long long)e;
    }
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int r = t; r < a.R; r += kThreads)
      a.child_count[r] = (int32_t)total_sh[r];

  // ---- rows from the count on: the zero state, valid 0 -----------------
  const long long gt = (long long)blockIdx.x * kThreads + t;
  const long long gstride = (long long)gridDim.x * kThreads;
  for (int r = 0; r < a.R; ++r) {
    const long long z0 = total_sh[r] < a.cap ? total_sh[r] : a.cap;
    const long long row0 = (long long)r * a.cap;
    for (long long e = gt; e < (a.cap - z0) * S; e += gstride) {
      const long long dst = (row0 + z0) * S + e;
      a.lo[dst] = 0;
      a.hi[dst] = 0;
      a.rlo[dst] = 0;
    }
    for (long long j = z0 + gt; j < a.cap; j += gstride) a.valid[row0 + j] = 0;
  }

  // ---- and the unset flags, in flat order, as parent_row and sym -------
  for (long long tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int r = (int)(tile / a.tpr);
    const long long k = tile - (long long)r * a.tpr;
    const long long total = total_sh[r];
    if (total >= a.cap) continue;
    if (warp == 0) {
      const unsigned long long e =
          k == 0 ? 0ull : dsm::lookback_exclusive(a.status, tile);
      if (lane == 0) excl_sh = e;
    }
    __syncthreads();
    // unset flags before this tile: its flags before it less its set ones
    const long long first = total + k * kTileFlags - (long long)excl_sh;
    __syncthreads();
    if (first >= a.cap) continue;
    const long long u0 = k * kTileNodes + (long long)t * kNodesPer;
    const long long nodes = a.cap - u0 < kNodesPer
                                ? (a.cap - u0 > 0 ? a.cap - u0 : 0)
                                : kNodesPer;
    const unsigned live = nodes >= 4 ? 0xFFFFu : (1u << (4 * nodes)) - 1;
    const unsigned unset = ~node_flags(a, r, k, false) & live;
    int n_unset;
    int slot = block_scan(__popc(unset), warp_sum, &n_unset);
    const long long row0 = (long long)r * a.cap;
    for (unsigned b = unset; b; b &= b - 1, ++slot) {
      const long long j = first + slot;
      if (j >= a.cap) break;
      const long long f = k * kTileFlags + t * 16 + __ffs(b) - 1;
      a.parent_row[row0 + j] = (int32_t)(f >> 2);
      a.sym[row0 + j] = (int32_t)(f & 3);
    }
    __syncthreads();
  }
}

}  // namespace

// The analyse-and-compact step (K13): sums (R, CAP, 5) int32 (K12's, summed
// over every process's samples), sym_mask (R, 4) bool, clo, chi, crlo
// (R, CAP, 4, S) int32 and cact (R, CAP, 4, S) bool (K12's); outputs lo, hi,
// rlo (R, CAP, S) int32, valid (R, CAP) bool, parent_row, sym (R, CAP)
// int32, child_count (R,) int32, single_full (R, CAP) bool, none of them
// initialised; scratch: R * ceil(4 CAP / 4096) + 1 int64.  1 <= R <=
// kMaxRows, CAP >= 1.
extern "C" int dsm_level_compact(const void* sums, const void* sym_mask,
                                 const void* clo, const void* chi,
                                 const void* crlo, const void* cact, int R,
                                 long long cap, int S, void* lo, void* hi,
                                 void* rlo, void* valid, void* parent_row,
                                 void* sym, void* child_count,
                                 void* single_full, void* scratch,
                                 void* stream) {
  if (R < 1 || R > kMaxRows || cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int kCards = 64;
  static int resident_of[kCards] = {};
  int err, dev = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  int resident = dev < kCards ? resident_of[dev] : 0;
  if (!resident) {
    int sms = 0, per = 0;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, level_compact_kernel, kThreads, 0)))
      return err;
    resident = sms * (per > 0 ? per : 1);
    if (dev < kCards) resident_of[dev] = resident;
  }
  Args a{};
  a.sums = (const int32_t*)sums;
  a.sym_mask = (const uint8_t*)sym_mask;
  a.clo = (const int32_t*)clo;
  a.chi = (const int32_t*)chi;
  a.crlo = (const int32_t*)crlo;
  a.cact = (const uint8_t*)cact;
  a.R = R;
  a.S = S;
  a.cap = cap;
  a.lo = (int32_t*)lo;
  a.hi = (int32_t*)hi;
  a.rlo = (int32_t*)rlo;
  a.valid = (uint8_t*)valid;
  a.parent_row = (int32_t*)parent_row;
  a.sym = (int32_t*)sym;
  a.child_count = (int32_t*)child_count;
  a.single_full = (uint8_t*)single_full;
  a.status = (unsigned long long*)scratch;
  a.tpr = (4 * cap + kTileFlags - 1) / kTileFlags;
  a.ntiles = a.tpr * R;
  if ((err = (int)cudaMemsetAsync(scratch, 0, (size_t)(a.ntiles + 1) * 8, st)))
    return err;
  const long long grid = a.ntiles < resident ? a.ntiles : resident;
  level_compact_kernel<<<(unsigned)grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
