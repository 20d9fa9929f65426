// Order-preserving masked row compaction in one pass: the rows whose mask
// byte is set move, in order, to the front of out (width, C); rows of out
// from the count on are zeroed, rows past width are dropped, and count
// receives the number of set mask bytes whatever width is.
//
// Three entries share the kernel.  dsm_compact_rows takes its rows from a
// (N, C) int32 matrix.  dsm_stage_rows is the emit step of a trie level:
// row p is made on the fly from pair row p as (hi - lo, rlo, sid, nid,
// depth), so the level never builds the (P, 5) matrix it keeps a handful
// of rows of.  dsm_compact_kidx (K14) writes the set rows' indices.
//
// Replaces dsm_tpu/ops/pallas_compact.py compact_rows (kernel _kernel), with
// the semantics of ops/compact.py compact_kidx_sort followed by a row take,
// the emit block of dsm_tpu/mining/engine_device.py _level_single
// (build_stage: orows, compact_kidx_sort, take), and ops/compact.py
// compact_kidx and compact_kidx_sort themselves (:33, :88).  On the TPU the grid ran in
// order on one core and carried the running output offset in SMEM from one
// step to the next, and each 128-row tile was permuted on the MXU over
// 16-bit halves.  Blocks on Hopper run in no order on 132 SMs, so the
// carried offset becomes a decoupled look-back (lookback.cuh) inside the
// one launch.
//
// What bounds it on an H100: bytes, the mask once, the kept rows in and out.
// The design, a tile of 4096 rows at a time:
//
//   * A block takes its tiles from an atomic counter (a persistent grid of
//     as many blocks as the card holds at once), so every earlier tile is
//     running or done and the look-back cannot wait on a block that has not
//     started.
//   * A thread reads 16 mask bytes with one 16-byte load where the pointer
//     allows (byte loads at an unaligned mask and at the ragged end),
//     squeezes them to 16 bits and counts them with __popc.  A block scan
//     gives each thread its first slot; the tile's count goes into its
//     status word, warp 0 looks back for the tile's offset while the other
//     warps list the tile's kept rows, in order, in shared memory (2 bytes
//     a row).
//   * The tile's output is one contiguous run of kept x C words.  Threads
//     own consecutive words of the run: the ragged head and tail are stored
//     word by word and the body with 16-byte stores, each word gathered
//     from its row through the list.  The same loop is both read paths:
//     where a tile keeps most of its rows, consecutive words of the run are
//     consecutive words of the source and a warp's loads are whole lines;
//     where it keeps few, only the 32-byte sectors that hold a kept row are
//     touched.  So there is no switch to place: the read cost follows the
//     share kept by itself, and the rows never pass through shared memory.
//   * No memset of out.  When every tile is taken, each block learns the
//     total by a look-back from past the last tile and the grid zeroes rows
//     [min(count, width), width) between its blocks.  On a level's emit
//     width == count and nothing is zeroed.
//
// The one memset beside the launch clears the status words and the tile
// counter (8 bytes a tile).

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // mask bytes a thread
constexpr int kTile = kThreads * kPer;   // rows a tile

// Rows of a contiguous (N, c) int32 matrix.  The width stays a run-time
// value: one division a 16-byte store does not show in the time.
struct MatrixRows {
  const int32_t* values;
  int c;
  __device__ __forceinline__ int cols() const { return c; }
  __device__ __forceinline__ int32_t word(long long row, int col) const {
    return values[row * c + col];
  }
};

// The emit rows of a level: (hi - lo, rlo, sid, nid, depth) of pair rows
// (lo, hi, rlo, sid, soff, nid).
struct EmitRows {
  const int32_t* pairs;
  int32_t depth;
  __device__ __forceinline__ int cols() const { return 5; }
  __device__ __forceinline__ int32_t word(long long row, int col) const {
    const int32_t* p = pairs + row * 6;
    switch (col) {
      case 0: return (int32_t)((uint32_t)p[1] - (uint32_t)p[0]);
      case 1: return p[2];
      case 2: return p[3];
      case 3: return p[5];
      default: return depth;
    }
  }
};

// The indices of the rows themselves: compact_kidx (K14), a (width, 1)
// output of the set rows' indices.
struct IndexRows {
  __device__ __forceinline__ int cols() const { return 1; }
  __device__ __forceinline__ int32_t word(long long row, int) const {
    return (int32_t)row;
  }
};

// Bit j of the result: byte j of w is not zero.
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t w) {
  uint32_t nz = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((nz >> 7) * 0x10204080u) >> 28;
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const uint8_t* __restrict__ mask, long long n, bool vec,
                   Rows rows, int32_t* __restrict__ out, long long width,
                   unsigned long long* status, long long ntiles,
                   long long* __restrict__ count) {
  __shared__ uint16_t kept_row[kTile];   // the tile's kept rows, in order
  __shared__ int warp_sum[kWarps];
  __shared__ long long tile_sh;
  __shared__ unsigned long long excl_sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int C = rows.cols();
  unsigned long long* next_tile = status + ntiles;

  for (;;) {
    if (t == 0) tile_sh = (long long)atomicAdd(next_tile, 1ull);
    __syncthreads();
    const long long tile = tile_sh;
    if (tile >= ntiles) break;

    const long long base = tile * kTile + (long long)t * kPer;
    unsigned bits = 0;
    if (vec && base + kPer <= n) {
      const uint4 m = *reinterpret_cast<const uint4*>(mask + base);
      bits = nonzero_bytes(m.x) | nonzero_bytes(m.y) << 4 |
             nonzero_bytes(m.z) << 8 | nonzero_bytes(m.w) << 12;
    } else {
      for (int j = 0; j < kPer; ++j)
        if (base + j < n && mask[base + j]) bits |= 1u << j;
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int slot = incl - cnt, kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) slot += warp_sum[w];
      kept += warp_sum[w];
    }
    if (t == 0) {
      dsm::put(status + tile,
               (tile == 0 ? dsm::kPrefix : dsm::kAggregate) | (unsigned)kept);
      if (tile == 0) excl_sh = 0;
    }
    for (unsigned b = bits; b; b &= b - 1)
      kept_row[slot++] = (uint16_t)(t * kPer + __ffs(b) - 1);
    if (warp == 0 && tile > 0) {
      const unsigned long long e = dsm::lookback_exclusive(status, tile);
      if (lane == 0) {
        dsm::put(status + tile, dsm::kPrefix | (unsigned)(e + kept));
        excl_sh = e;
      }
    }
    __syncthreads();
    const long long excl = (long long)excl_sh;
    if (tile == ntiles - 1 && t == 0) *count = excl + kept;

    // the tile's run of out: rows [excl, excl + nrows)
    const long long room = width - excl;
    const int nrows = room <= 0 ? 0 : (room < kept ? (int)room : kept);
    if (nrows == 0) continue;
    const long long src0 = tile * kTile;
    int32_t* dst = out + excl * C;
    const int W = nrows * C;
    int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
    if (head > W) head = W;
    const int nvec = (W - head) >> 2;
    for (int v = t; v < nvec; v += kThreads) {
      const int w = head + 4 * v;
      int r = w / C, c = w - r * C;
      long long s = src0 + kept_row[r];
      int32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = rows.word(s, c);
        if (++c == C && i < 3) {
          c = 0;
          s = src0 + kept_row[++r];
        }
      }
      *reinterpret_cast<int4*>(dst + w) = make_int4(q[0], q[1], q[2], q[3]);
    }
    const int ragged = W - 4 * nvec;   // head words, then tail words
    for (int e = t; e < ragged; e += kThreads) {
      const int w = e < head ? e : 4 * nvec + e;
      const int r = w / C;
      dst[w] = rows.word(src0 + kept_row[r], w - r * C);
    }
  }

  // every tile is taken: the total, then the tail's zeroes over the grid
  if (warp == 0) {
    const unsigned long long e = dsm::lookback_exclusive(status, ntiles);
    if (lane == 0) excl_sh = e;
  }
  __syncthreads();
  const long long total = (long long)excl_sh;
  const long long z0 = (total < width ? total : width) * C, z1 = width * C;
  if (z0 >= z1) return;
  long long a0 = z0 + (long long)(((16 - ((uintptr_t)(out + z0) & 15)) & 15) >> 2);
  if (a0 > z1) a0 = z1;
  const long long nvec = (z1 - a0) >> 2;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (long long v = (long long)blockIdx.x * kThreads + t; v < nvec;
       v += (long long)gridDim.x * kThreads)
    *reinterpret_cast<int4*>(out + a0 + 4 * v) = zero;
  if (blockIdx.x == 0) {
    for (long long w = z0 + t; w < a0; w += kThreads) out[w] = 0;
    for (long long w = a0 + 4 * nvec + t; w < z1; w += kThreads) out[w] = 0;
  }
}

// scratch: ceil(n / 4096) status words and the tile counter, 8 bytes each.
template <typename Rows>
int run(const void* mask, long long n, Rows rows, void* out, long long width,
        void* scratch, void* count, cudaStream_t s) {
  // blocks of this kernel that each card holds at once, found at a card's
  // first call (cards beyond the table are asked every call)
  constexpr int kCards = 64;
  static int resident_of[kCards] = {};
  int err, dev = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  int resident = dev < kCards ? resident_of[dev] : 0;
  if (!resident) {
    int sms = 0, per = 0;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                           dev)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, compact_kernel<Rows>, kThreads, 0)))
      return err;
    resident = sms * (per > 0 ? per : 1);
    if (dev < kCards) resident_of[dev] = resident;
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  if ((err = (int)cudaMemsetAsync(scratch, 0, (size_t)(ntiles + 1) * 8, s)))
    return err;
  const long long grid = ntiles < resident ? ntiles : resident;
  compact_kernel<Rows><<<(unsigned)grid, kThreads, 0, s>>>(
      (const uint8_t*)mask, n, ((uintptr_t)mask & 15) == 0, rows,
      (int32_t*)out, width, (unsigned long long*)scratch, ntiles,
      (long long*)count);
  return (int)cudaGetLastError();
}

}  // namespace

// mask: n bytes; values: (n, c) int32; out: (width, c) int32, not
// initialised; scratch: ceil(n / 4096) + 1 int64; count: one int64.  n >= 1.
extern "C" int dsm_compact_rows(const void* mask, const void* values,
                                long long n, int c, void* out, long long width,
                                void* scratch, void* count, void* stream) {
  return run(mask, n, MatrixRows{(const int32_t*)values, c}, out, width,
             scratch, count, (cudaStream_t)stream);
}

// The emit step: pairs (n, 6) int32; out (width, 5) int32 receives
// (hi - lo, rlo, sid, nid, depth) of the marked pairs; the rest as above.
extern "C" int dsm_stage_rows(const void* mask, const void* pairs, long long n,
                              int depth, void* out, long long width,
                              void* scratch, void* count, void* stream) {
  return run(mask, n, EmitRows{(const int32_t*)pairs, (int32_t)depth}, out,
             width, scratch, count, (cudaStream_t)stream);
}

// compact_kidx (K14): out (width,) int32 receives the indices of the set
// mask bytes, in order, then zeroes; the rest as in dsm_compact_rows.
extern "C" int dsm_compact_kidx(const void* mask, long long n, void* out,
                                long long width, void* scratch, void* count,
                                void* stream) {
  return run(mask, n, IndexRows{}, out, width, scratch, count,
             (cudaStream_t)stream);
}
