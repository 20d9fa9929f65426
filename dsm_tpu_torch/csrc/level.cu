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
// a zero state.  The TPU did it with one argsort of the R x CAP x 4 flags
// and gathers.
//
// What bounds it on an H100: bytes, the next state's R x CAP x S x 12
// written whole (at D512's widest level, where nothing is kept, 25 MB of
// zeros) and the kept children's S-wide rows read.
//
// The first design did everything inside the tiles of the flags' scan: a
// persistent grid of min(tiles, resident) blocks, where a tile is 1,024
// nodes of one row, so 4 blocks at D512 and 64 at AC's one-row level on a
// 132-SM card, wrote the zero fill past each row's count with 4-byte
// stores and the S-wide copy of every kept child by the one block that
// owned its flag tile (0.11 ms on an H100 for D512's 25 MB, 15x its
// bound), and its pass over the unset flags repeated a look-back and
// re-read the sums for every tile.
//
// The design: one cooperative launch (cudaLaunchCooperativeKernel) of the
// card's resident blocks, whatever the tile count, in two phases.
//   * Phase 1 scans the flags: tile k of row r (four nodes a thread) is
//     taken by block (r * tiles a row + k) mod grid, in order, reads its
//     nodes' sums once, writes their single_full, keeps its 4,096 flag
//     bits (a 16-bit word a thread) for phase 2, chains its count to its
//     row's earlier tiles by a decoupled look-back (lookback.cuh; each
//     row's first tile publishes a prefix, so a look-back never leaves its
//     row), and writes parent_row and sym of its set flags below CAP.
//   * A grid-wide barrier, cooperative_groups' grid.sync(): phase 2 reads
//     what other blocks stored in phase 1 (parent_row, sym, the flag bits,
//     the status words), and a look-back proves only that a count was
//     published, not that those stores are visible.  grid.sync() orders
//     every block's phase-1 stores (it fences) before any block's phase-2
//     loads; the cooperative launch guarantees that every block is
//     resident, so the barrier cannot deadlock, and a launch the card
//     cannot hold resident is refused (an error the wrapper raises).
//   * Phase 2 spreads the rows over the whole grid: each block reads the
//     rows' counts from the status words (a row's last tile holds its
//     total) and block 0 writes child_count; every output cell of
//     (R, CAP, S) takes its kept child's cell (keep ? clo : 0, and
//     likewise chi, crlo) below its row's count and zero from it on, four
//     cells a thread with 16-byte stores (and 16-byte loads where
//     S % 4 == 0 keeps a row's start aligned); the tiles whose unset flags
//     reach below CAP rank them from their exclusive prefix (the previous
//     tile's status word) and their kept flag bits, with no second
//     look-back and no second read of the sums; valid is written for every
//     slot.
// The status words and the ticket are a running state a (device, stream)
// (ops/level.py): made zero, and the last block to finish (a ticket taken
// after its last read of them) zeroes them for the next launch, which
// spares a memset a level.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNodesPer = 4;                     // nodes a thread
constexpr int kTileNodes = kThreads * kNodesPer;
constexpr int kTileFlags = kTileNodes * 4;
constexpr int kSumCols = 5;   // ops/level.py: active samples, then A C G T
constexpr int kMaxRows = 1024;                   // ops/level.py MAX_ROWS
constexpr int kBlocksPerSm = 4;  // the grid: resident blocks, at most these

struct Args {
  const int32_t* sums;                   // (R, CAP, 5)
  const uint8_t* sym_mask;               // (R, 4) bool
  const int32_t* clo;                    // (R, CAP, 4, S)
  const int32_t* chi;
  const int32_t* crlo;
  const uint8_t* cact;
  int R, S, cap;
  bool vec;                // S % 4 == 0 and clo, chi, crlo, cact aligned
  int32_t* lo;                           // (R, CAP, S), 16-byte aligned
  int32_t* hi;
  int32_t* rlo;
  uint8_t* valid;                        // (R, CAP)
  int32_t* parent_row;                   // (R, CAP)
  int32_t* sym;
  int32_t* child_count;                  // (R,)
  uint8_t* single_full;                  // (R, CAP)
  unsigned long long* status;            // ntiles words, then the ticket
  uint16_t* bits;                        // (ntiles, kThreads) flag words
  int tpr, ntiles;                       // tiles a row, in all
};

// The union flags of this thread's four nodes of tile k of row r (bit
// 4j + c for node j, symbol c; none for nodes past CAP); their
// single_full written too.
__device__ __forceinline__ unsigned node_flags(const Args& a, int r, int k) {
  unsigned sm = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) sm |= (a.sym_mask[r * 4 + c] ? 1u : 0u) << c;
  const long long u0 = (long long)k * kTileNodes + threadIdx.x * kNodesPer;
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
    const int first = f ? __ffs(f) - 1 : 0;
    int32_t pick = cc[0];
#pragma unroll
    for (int c = 1; c < 4; ++c)
      if (c == first) pick = cc[c];
    a.single_full[(long long)r * a.cap + u] =
        (uint8_t)(__popc(f) == 1 && pick == sm5[0]);
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

// Output cell e of the next state (flat (R, CAP, S) index): the kept
// child's cell below its row's count, else zeros.  parent_row and sym were
// stored by phase 1 (other blocks): plain loads, after the grid barrier.
__device__ __forceinline__ void cell_of(const Args& a, const int* total,
                                        unsigned e, int32_t& l, int32_t& h,
                                        int32_t& r3) {
  const unsigned q = e / (unsigned)a.S;
  const unsigned s = e - q * (unsigned)a.S;
  const unsigned r = q / (unsigned)a.cap;
  const unsigned j = q - r * (unsigned)a.cap;
  l = h = r3 = 0;
  if ((int)j < total[r]) {
    // the child's cell: its activity and its values loaded together
    const long long src =
        (((long long)r * a.cap + a.parent_row[q]) * 4 + a.sym[q]) * a.S + s;
    const bool keep = __ldg(a.cact + src);
    const int32_t x = __ldg(a.clo + src), y = __ldg(a.chi + src),
                  z = __ldg(a.crlo + src);
    if (keep) {
      l = x;
      h = y;
      r3 = z;
    }
  }
}

__global__ void __launch_bounds__(kThreads) level_compact_kernel(const Args a) {
  __shared__ uint16_t list[kTileFlags];  // a tile's set flags, in order
  __shared__ int warp_sum[kWarps];
  __shared__ unsigned long long excl_sh;
  __shared__ int total_sh[kMaxRows];     // phase 2: the rows' counts
  __shared__ bool last_sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long cap = a.cap;

  // ---- phase 1: the flags, a tile a block in order ----------------------
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int r = tile / a.tpr;
    const int k = tile - r * a.tpr;
    const unsigned bits = node_flags(a, r, k);
    a.bits[(long long)tile * kThreads + t] = (uint16_t)bits;
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
    const long long room = cap - excl;
    const int nk = room <= 0 ? 0 : (room < kept ? (int)room : kept);
    const long long row0 = (long long)r * cap;
    for (int e = t; e < nk; e += kThreads) {
      const long long f = (long long)k * kTileFlags + list[e];
      a.parent_row[row0 + excl + e] = (int32_t)(f >> 2);
      a.sym[row0 + excl + e] = (int32_t)(f & 3);
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  // ---- phase 2: the rows, over the whole grid ---------------------------
  for (int r = t; r < a.R; r += kThreads)
    total_sh[r] = (int)(uint32_t)dsm::get(
        a.status + (long long)r * a.tpr + a.tpr - 1);
  __syncthreads();
  if (blockIdx.x == 0)
    for (int r = t; r < a.R; r += kThreads) a.child_count[r] = total_sh[r];
  const long long gt = (long long)blockIdx.x * kThreads + t;
  const long long gs = (long long)gridDim.x * kThreads;
  // the next state: four output cells a thread, 16-byte stores
  const long long cells = (long long)a.R * cap * a.S;
  const long long nvec = cells >> 2;
  for (long long v = gt; v < nvec; v += gs) {
    const unsigned e0 = (unsigned)(v << 2);
    int4 l, h, r3;
    if (a.vec) {
      // the four cells of one slot, at a 16-byte-aligned sample
      const unsigned q = e0 / (unsigned)a.S;
      const unsigned s = e0 - q * (unsigned)a.S;
      const unsigned r = q / (unsigned)a.cap;
      const unsigned j = q - r * (unsigned)a.cap;
      l = h = r3 = make_int4(0, 0, 0, 0);
      if ((int)j < total_sh[r]) {
        const long long src =
            (((long long)r * a.cap + a.parent_row[q]) * 4 + a.sym[q]) * a.S +
            s;
        const unsigned keep = __ldg(reinterpret_cast<const unsigned*>(
            a.cact + src));
        const int4 x = __ldg(reinterpret_cast<const int4*>(a.clo + src));
        const int4 y = __ldg(reinterpret_cast<const int4*>(a.chi + src));
        const int4 z = __ldg(reinterpret_cast<const int4*>(a.crlo + src));
        const bool k0 = keep & 0xFFu, k1 = keep & 0xFF00u,
                   k2 = keep & 0xFF0000u, k3 = keep & 0xFF000000u;
        l = make_int4(k0 ? x.x : 0, k1 ? x.y : 0, k2 ? x.z : 0,
                      k3 ? x.w : 0);
        h = make_int4(k0 ? y.x : 0, k1 ? y.y : 0, k2 ? y.z : 0,
                      k3 ? y.w : 0);
        r3 = make_int4(k0 ? z.x : 0, k1 ? z.y : 0, k2 ? z.z : 0,
                       k3 ? z.w : 0);
      }
    } else {
      cell_of(a, total_sh, e0, l.x, h.x, r3.x);
      cell_of(a, total_sh, e0 + 1, l.y, h.y, r3.y);
      cell_of(a, total_sh, e0 + 2, l.z, h.z, r3.z);
      cell_of(a, total_sh, e0 + 3, l.w, h.w, r3.w);
    }
    reinterpret_cast<int4*>(a.lo)[v] = l;
    reinterpret_cast<int4*>(a.hi)[v] = h;
    reinterpret_cast<int4*>(a.rlo)[v] = r3;
  }
  for (long long e = (nvec << 2) + gt; e < cells; e += gs)
    cell_of(a, total_sh, (unsigned)e, a.lo[e], a.hi[e], a.rlo[e]);

  // the unset flags, in flat order, as parent_row and sym past the count;
  // the tiles go to the last blocks first, which the cells above leave
  // idle where the state is small
  for (int tile = gridDim.x - 1 - blockIdx.x; tile < a.ntiles;
       tile += gridDim.x) {
    const int r = tile / a.tpr;
    const int k = tile - r * a.tpr;
    const long long total = total_sh[r];
    if (total >= cap) continue;
    // unset flags before this tile: its flags before it less its set ones
    const long long excl =
        k == 0 ? 0 : (long long)(uint32_t)dsm::get(a.status + tile - 1);
    const long long first = total + (long long)k * kTileFlags - excl;
    if (first >= cap) continue;
    const long long u0 = (long long)k * kTileNodes + (long long)t * kNodesPer;
    const long long nodes = cap - u0 < kNodesPer
                                ? (cap - u0 > 0 ? cap - u0 : 0)
                                : kNodesPer;
    const unsigned live = nodes >= 4 ? 0xFFFFu : (1u << (4 * nodes)) - 1;
    const unsigned unset = ~(unsigned)a.bits[(long long)tile * kThreads + t]
                           & live;
    int n_unset;
    int slot = block_scan(__popc(unset), warp_sum, &n_unset);
    const long long row0 = (long long)r * cap;
    for (unsigned b = unset; b; b &= b - 1, ++slot) {
      const long long j = first + slot;
      if (j >= cap) break;
      const long long f = (long long)k * kTileFlags + t * 16 + __ffs(b) - 1;
      a.parent_row[row0 + j] = (int32_t)(f >> 2);
      a.sym[row0 + j] = (int32_t)(f & 3);
    }
    __syncthreads();
  }

  const long long slots = (long long)a.R * cap;
  for (long long q = gt; q < slots; q += gs) {
    const int r = slots < (1ll << 32) ? (int)((unsigned)q / (unsigned)cap)
                                      : (int)(q / cap);
    a.valid[q] = (uint8_t)(q - r * cap < total_sh[r]);
  }

  // ---- the last block out zeroes the status words and the ticket --------
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last_sh = atomicAdd(a.status + a.ntiles, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_sh)
    for (int i = t; i <= a.ntiles; i += kThreads) a.status[i] = 0;
}

}  // namespace

// The analyse-and-compact step (K13): sums (R, CAP, 5) int32 (K12's, summed
// over every process's samples), sym_mask (R, 4) bool, clo, chi, crlo
// (R, CAP, 4, S) int32 and cact (R, CAP, 4, S) bool (K12's); outputs lo, hi,
// rlo (R, CAP, S) int32 (16-byte aligned), valid (R, CAP) bool, parent_row,
// sym (R, CAP) int32, child_count (R,) int32, single_full (R, CAP) bool,
// none of them initialised; status: R * ceil(4 CAP / 4096) + 1 int64, ZERO
// (the launch leaves them zero); bits: R * ceil(4 CAP / 4096) * 256 int16.
// 1 <= R <= kMaxRows, 1 <= CAP, 4 CAP < 2^31, R x CAP x S < 2^31.  One
// cooperative launch: an error if the card cannot hold its grid resident.
extern "C" int dsm_level_compact(const void* sums, const void* sym_mask,
                                 const void* clo, const void* chi,
                                 const void* crlo, const void* cact, int R,
                                 long long cap, int S, void* lo, void* hi,
                                 void* rlo, void* valid, void* parent_row,
                                 void* sym, void* child_count,
                                 void* single_full, void* status, void* bits,
                                 void* stream) {
  if (R < 1 || R > kMaxRows || cap < 1 || 4 * cap >= (1ll << 31) || S < 0 ||
      (long long)R * cap * S >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const void* stores[] = {lo, hi, rlo};
  for (const void* p : stores)
    if (reinterpret_cast<uintptr_t>(p) & 15)
      return (int)cudaErrorMisalignedAddress;
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
    resident = sms * (per < kBlocksPerSm ? per : kBlocksPerSm);
    if (dev < kCards) resident_of[dev] = resident;
  }
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a{};
  a.sums = (const int32_t*)sums;
  a.sym_mask = (const uint8_t*)sym_mask;
  a.clo = (const int32_t*)clo;
  a.chi = (const int32_t*)chi;
  a.crlo = (const int32_t*)crlo;
  a.cact = (const uint8_t*)cact;
  a.R = R;
  a.S = S;
  a.cap = (int)cap;
  a.vec = S % 4 == 0 &&
          !((reinterpret_cast<uintptr_t>(clo) | reinterpret_cast<uintptr_t>(chi) |
             reinterpret_cast<uintptr_t>(crlo)) & 15) &&
          !(reinterpret_cast<uintptr_t>(cact) & 3);
  a.lo = (int32_t*)lo;
  a.hi = (int32_t*)hi;
  a.rlo = (int32_t*)rlo;
  a.valid = (uint8_t*)valid;
  a.parent_row = (int32_t*)parent_row;
  a.sym = (int32_t*)sym;
  a.child_count = (int32_t*)child_count;
  a.single_full = (uint8_t*)single_full;
  a.status = (unsigned long long*)status;
  a.bits = (uint16_t*)bits;
  a.tpr = (int)((4 * cap + kTileFlags - 1) / kTileFlags);
  a.ntiles = a.tpr * R;
  void* args[] = {&a};
  if ((err = (int)cudaLaunchCooperativeKernel(
           (const void*)level_compact_kernel, dim3((unsigned)resident),
           dim3(kThreads), args, 0, (cudaStream_t)stream)))
    return err;
  return (int)cudaGetLastError();
}
