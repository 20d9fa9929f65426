// The gather of a sharded drain: the count-bounded int32 rows of several
// blocks (a process's staged output rows, its live pair rows, or the
// slices of an all-gathered tensor) packed into one list in block order, each
// block's LOCAL sample ids rewritten to global ones, and the blocks' int8
// leftChar codes placed beside them where there are any.
//
// Replaces dsm_tpu/parallel/engine_episode.py _jitted_gather_counts,
// _jitted_gather_rows and _jitted_lc_sharded's gather (:205-267) and the
// host loop that cut each shard's padded slice to its count and added the
// shard's first sample id (:350-364, :443-447): there every shard's buffer
// was padded to one power-of-two length so that `all_gather` could stack
// them; here the blocks are wherever they lie on the device.
//
// What bounds it on an H100: bytes, 4*C (+ 1 with codes) read and written
// a row.  The design:
//   * the block table rides in the launch's parameters (a
//     __grid_constant__ struct: each block's rows, its codes, its first
//     output row, its row count, its sample-id base and its first CUDA
//     block), so nothing is uploaded before the launch and nothing in global
//     memory is searched: a CUDA block bisects the table's first CUDA blocks
//     once, with uniform loads from the parameter bank;
//   * a CUDA block copies a tile of kTileRows rows of one block as a flat
//     span of words: a block's rows are contiguous, and so is their
//     destination.  Its stores are 16 bytes, aligned, after a scalar head
//     of at most 3 words; its loads are the aligned 16 bytes around each
//     chunk, joined by shifts where source and destination differ mod 16
//     (a slice of an all-gathered tensor is only 4-byte aligned; the codes
//     at any byte), as P4's dynamic_store does (csrc/repro.cu);
//   * the base is added to each word whose index mod C is sid_col on its
//     way through registers; the codes span is copied the same way;
//   * kInFlight chunks a thread are loaded before any is stored.
// A drain and a live-pair gather hand it one block (a process keeps one
// list of its shards' pairs and stages its rows in one buffer); the table
// holds kMaxBlocks = 128 40-byte entries (5 KB of the 32,764 bytes of
// parameters sm_90 takes): one launch for an all-gather of up to 128 ranks;
// ops/gatherpack.py launches once per kMaxBlocks blocks above that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 1024;   // rows a CUDA block copies
constexpr int kInFlight = 4;      // 16-byte chunks a thread loads at once
constexpr int kMaxBlocks = 128;   // ops/gatherpack.py MAX_BLOCKS

struct Block {
  const int32_t* src;   // m rows of C words
  const int8_t* lc;     // m codes, or null
  long long row0;       // its first output row
  long long m;          // its rows, >= 1
  int32_t base;         // added to column sid_col
  int32_t cta0;         // the first CUDA block that copies it
};

struct Table {
  Block b[kMaxBlocks];
  int nblk;
};

// 16 bytes of a span from the aligned 16 bytes `a16` holding its first
// byte, `sb` bytes in, and the next aligned 16 (read only when sb > 0,
// and then they hold a byte of the same chunk, so they lie in the source's
// allocation).
__device__ __forceinline__ uint4 load16(const uint4* a16, int sb) {
  const uint4 a = __ldg(a16);
  if (sb == 0) return a;
  const uint4 b = __ldg(a16 + 1);
  uint32_t e0, e1, e2, e3, e4;
  switch (sb >> 2) {
    case 0: e0 = a.x; e1 = a.y; e2 = a.z; e3 = a.w; e4 = b.x; break;
    case 1: e0 = a.y; e1 = a.z; e2 = a.w; e3 = b.x; e4 = b.y; break;
    case 2: e0 = a.z; e1 = a.w; e2 = b.x; e3 = b.y; e4 = b.z; break;
    default: e0 = a.w; e1 = b.x; e2 = b.y; e3 = b.z; e4 = b.w; break;
  }
  const int bs = 8 * (sb & 3);
  return make_uint4(__funnelshift_r(e0, e1, bs), __funnelshift_r(e1, e2, bs),
                    __funnelshift_r(e2, e3, bs), __funnelshift_r(e3, e4, bs));
}

// word w of a row at column c (then the next column): + base at sid_col
__device__ __forceinline__ uint32_t fix(uint32_t w, int& c, int C,
                                        int sid_col, uint32_t base) {
  w += c == sid_col ? base : 0u;
  c = c + 1 == C ? 0 : c + 1;
  return w;
}

// nw words of whole rows from src to dst (both 4-byte aligned), + base in
// column sid_col.
__device__ __forceinline__ void copy_rows(const int32_t* __restrict__ src,
                                          int32_t* __restrict__ dst, int nw,
                                          int C, int sid_col, uint32_t base) {
  const int t = threadIdx.x;
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
  head = head < nw ? head : nw;
  const int m4 = (nw - head) >> 2;
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src + head);
  const int sb = (int)(reinterpret_cast<uintptr_t>(s) & 15);
  const uint4* a16 = reinterpret_cast<const uint4*>(s - sb);
  uint4* d16 = reinterpret_cast<uint4*>(dst + head);
  for (int j0 = t; j0 < m4; j0 += kThreads * kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u * kThreads;
      if (j < m4) v[u] = load16(a16 + j, sb);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = j0 + u * kThreads;
      if (j < m4) {
        int c = (head + 4 * j) % C;
        uint4 w = v[u];
        w.x = fix(w.x, c, C, sid_col, base);
        w.y = fix(w.y, c, C, sid_col, base);
        w.z = fix(w.z, c, C, sid_col, base);
        w.w = fix(w.w, c, C, sid_col, base);
        d16[j] = w;
      }
    }
  }
  const int tail = nw - head - 4 * m4;
  int i = -1;
  if (t < head) i = t;
  else if (t >= 4 && t - 4 < tail) i = head + 4 * m4 + (t - 4);
  if (i >= 0) {
    int c = i % C;
    dst[i] = (int32_t)fix((uint32_t)src[i], c, C, sid_col, base);
  }
}

// nb bytes from src to dst, any alignment.
__device__ __forceinline__ void copy_bytes(const int8_t* __restrict__ src,
                                           int8_t* __restrict__ dst, int nb) {
  const int t = threadIdx.x;
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  head = head < nb ? head : nb;
  const int m16 = (nb - head) >> 4;
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src + head);
  const int sb = (int)(reinterpret_cast<uintptr_t>(s) & 15);
  const uint4* a16 = reinterpret_cast<const uint4*>(s - sb);
  uint4* d16 = reinterpret_cast<uint4*>(dst + head);
  for (int j = t; j < m16; j += kThreads) d16[j] = load16(a16 + j, sb);
  const int tail = nb - head - 16 * m16;
  // the last threads take the head and the tail: the first take the body
  const int r = kThreads - 1 - t;
  if (r < head) dst[r] = src[r];
  else if (r >= 16 && r - 16 < tail) {
    const int i = head + 16 * m16 + (r - 16);
    dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_pack_kernel(const __grid_constant__ Table tab, int C,
                       int sid_col, int32_t* __restrict__ out,
                       int8_t* __restrict__ lc_out) {
  const int cta = (int)blockIdx.x;
  int lo = 0, hi = tab.nblk - 1;     // the last block whose cta0 <= cta
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.b[mid].cta0 <= cta) lo = mid; else hi = mid - 1;
  }
  const Block b = tab.b[lo];
  const long long r0 = (long long)(cta - b.cta0) * kTileRows;
  const int rows = (int)(b.m - r0 < kTileRows ? b.m - r0 : kTileRows);
  copy_rows(b.src + r0 * C, out + (b.row0 + r0) * C, rows * C, C, sid_col,
            (uint32_t)b.base);
  if (lc_out) copy_bytes(b.lc + r0, lc_out + b.row0 + r0, rows);
}

}  // namespace

// table: nblk x (rows pointer, codes pointer, first output row, rows m >= 1,
// base) int64 in HOST memory, copied into the launch's parameters;
// out: the output rows (C int32 words each); lc_out: the output codes, or
// null (then the table's codes pointers are not read).  1 <= nblk <=
// kMaxBlocks, 0 <= sid_col < C, C * kTileRows < 2^31.
extern "C" int dsm_gather_pack(const void* table, int nblk, int C, int sid_col,
                               void* out, void* lc_out, void* stream) {
  if (nblk < 1 || nblk > kMaxBlocks || C < 1 || sid_col < 0 || sid_col >= C ||
      (long long)C * kTileRows >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const long long* h = (const long long*)table;
  Table tab;
  tab.nblk = nblk;
  long long ctas = 0;
  for (int k = 0; k < nblk; ++k) {
    const long long* e = h + 5 * k;
    if (e[3] < 1) return (int)cudaErrorInvalidValue;
    tab.b[k] = Block{(const int32_t*)e[0], (const int8_t*)e[1], e[2], e[3],
                     (int32_t)e[4], (int32_t)ctas};
    ctas += (e[3] + kTileRows - 1) / kTileRows;
  }
  if (ctas >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  gather_pack_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      tab, C, sid_col, (int32_t*)out, (int8_t*)lc_out);
  return (int)cudaGetLastError();
}

