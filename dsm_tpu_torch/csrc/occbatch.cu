// Rank of a symbol on the raw BWT blocks (K15): out[i] = occ[pos[i] >> 7,
// syms[i]] + the count of syms[i] among the first pos[i] & 127 codes of
// block pos[i] >> 7.
//
// Replaces dsm_tpu/ops/rank.py occ_batch (:270): the XLA take of the
// (Q, 128) int8 block rows, a compare under a lane mask and a sum.
//
// What bounds it.  By DRAM bytes: 12 B a query (pos, sym in, out) plus each
// distinct block's 128-byte row and 32-byte occ row once.  On random
// positions over a table the 50 MB L2 holds, the L2's sector rate sets it
// instead: a query reads one 32-byte occ sector and the row's sectors that
// hold the codes it counts; counting from the row's start, ceil(r / 32) of
// them (r = pos & 127), about 2.5 on average, so ~3.5 sectors a query.
// Past the L2 those sectors come from DRAM.  The queries' positions are
// data, so the latency of every row read is exposed unless many are in
// flight at once, and the compares (16 to 64 codes a query) cost issue
// slots of their own.
//
// What the design does about it.
// - Fewer sectors: a query counts from the row's nearer end.  Past the
//   middle (r > 64) it takes occ[b + 1, sym] less the count of sym among
//   codes r..127, which equals occ[b, sym] plus the count below r because
//   occ's row b + 1 is row b plus block b's counts.  The last block is
//   counted from its start: an OccTable's last occ row leaves the padding
//   out of PAD's count.  A query then reads at most 64 bytes of its row,
//   ~1.5 row sectors on average, ~2.5 sectors in all.
// - Many queries in flight: a group of 4 lanes takes a query, lane k the
//   k-th 16-byte vector of the span it counts.  A warp takes 32 queries a
//   round: each lane loads its own query's position and symbol (coalesced;
//   a round ahead) and its occ entry; the group gets its 4 queries'
//   positions by shuffles and issues every row load of the round before
//   any count.  Only the vectors that hold counted codes are read.  Four
//   lanes a query: one load instruction then reads 8 queries' 64-byte
//   halves, fewer L1 requests a query than a thread a query makes on
//   random positions; 8 lanes would leave half their lanes idle at the
//   nearer end.
// - Cheap compares: four codes a word at once (the word XOR the symbol in
//   every byte, then a zero-byte test that leaves each byte's top bit:
//   three instructions a word, fewer than __vcmpeq4's, and faster by
//   timing: chip_smoke.occ_batch_times), a vector's four words' bits in
//   one word, one mask a vector from a table of 17 in shared memory, one
//   __popc.  The group's counts meet by a recursive-halving exchange (two
//   rounds of __shfl_xor_sync) that leaves lane k its own query's count,
//   so the outputs are stored a lane a query, coalesced.
// - A forward count past 64 codes (the last block, r > 64) needs a second
//   window: the warp loads it only when one of its queries needs it.
// - Rows through the read-only path (ld.global.nc); 16-byte vector loads
//   where `blocks` is 16-byte aligned, four 4-byte loads otherwise, in the
//   same kernel.  The grid is the card's resident blocks (its SM count and
//   the kernel's occupancy, read once a device), a grid-stride loop over
//   the rounds.
// A query whose offset r is 0 reads no row (pos = n with n a multiple of
// 128 points at the row past the last).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint4 load16(const int8_t* p, bool vec16) {
  if (vec16) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int* w = reinterpret_cast<const unsigned int*>(p);
  return make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
}

// The codes of v (16) equal to the symbol (sym4: it, below 128, in every
// byte) below `below` (0..16), or at and past it when `back`.  `masks[c]`
// marks the first c codes in the word the zero-byte tests make (code
// 4 w + i at bit 8 i + 7 - w).
__device__ __forceinline__ uint32_t count16(uint4 v, uint32_t sym4,
                                            int below, bool back,
                                            const uint32_t* masks) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t t = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // a byte of w ^ sym4 is zero where the code matches: its low seven
    // bits are zero (no carry into the top bit of their sum with 0x7F) and
    // its top bit, w's own since sym < 128, is zero
    const uint32_t a = ((w[k] ^ sym4) & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
    t |= (~(a | w[k]) & 0x80808080u) >> k;
  }
  const uint32_t m = masks[below];
  return __popc(t & (back ? ~m : m));
}

// Whether a query at p counts from its row's end (see the note).
__device__ __forceinline__ bool from_end(uint32_t p, uint32_t nb) {
  return (p & 127u) > 64u && (p >> 7) + 1u < nb;
}

// Vector vi (16 codes) of a row, loaded where it holds counted codes: below
// r forward; from r >> 4 to the row's end backward.  The others are zero.
__device__ __forceinline__ uint4 load_part(const int8_t* row, int vi, int r,
                                           bool back, bool vec16) {
  const bool need = vi < 8 && (back || 16 * vi < r);
  return need ? load16(row + 16 * vi, vec16) : make_uint4(0, 0, 0, 0);
}

// Vector vi's share of the count (a vector past the row's end was not
// loaded: its zeros would match code 0).
__device__ __forceinline__ uint32_t count_part(uint4 v, int vi, int r,
                                               bool back, uint32_t sym4,
                                               const uint32_t* masks) {
  return vi < 8 ? count16(v, sym4, min(max(r - 16 * vi, 0), 16), back, masks)
                : 0u;
}

__global__ void __launch_bounds__(kThreads)
    occ_batch_kernel(const int8_t* __restrict__ blocks, uint32_t nb,
                     int vec16, const int32_t* __restrict__ occ, int sigma,
                     const int32_t* __restrict__ syms,
                     const int32_t* __restrict__ pos,
                     int32_t* __restrict__ out, long long q) {
  __shared__ uint32_t masks[17];
  if (threadIdx.x < 17) {
    uint32_t m = 0;
    for (int j = 0; j < (int)threadIdx.x; ++j)
      m |= 1u << (8 * (j & 3) + 7 - (j >> 2));
    masks[threadIdx.x] = m;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int k = lane & 3;  // this lane's place in its group of 4
  const long long stride = (long long)gridDim.x * kThreads;
  long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
  // this lane's own query, a round ahead: position (>= 0) and symbol
  auto fetch = [&](long long at, uint32_t& pp, int& ss) {
    const long long i = at + lane;
    pp = i < q ? (uint32_t)__ldg(pos + i) : 0u;
    ss = i < q ? __ldg(syms + i) : 0;
  };
  uint32_t p;
  int s;
  fetch(base, p, s);
  for (; base < q; base += stride) {
    uint32_t pn;
    int sn;
    fetch(base + stride, pn, sn);
    const bool mine = base + lane < q;
    // 1. the occ entry at the nearer end
    const int32_t o =
        mine ? __ldg(occ + ((p >> 7) + from_end(p, nb)) * (long long)sigma + s)
             : 0;
    // 2. the group's queries (query j of the group is lane j's): every row
    // load of the round before any count
    uint32_t sj[4];
    int r[4], vi[4];
    bool back[4];
    const int8_t* row[4];
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pj = __shfl_sync(kFull, p, j, 4);
      sj[j] = ((uint32_t)__shfl_sync(kFull, s, j, 4) & 0xFFu) * 0x01010101u;
      r[j] = pj & 127u;
      back[j] = from_end(pj, nb);
      row[j] = blocks + (pj & ~127u);
      vi[j] = (back[j] ? r[j] >> 4 : 0) + k;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = load_part(row[j], vi[j], r[j], back[j], vec16);
    // 3. this lane's share of each query's count
    uint32_t c[4];
    bool wide = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = count_part(v[j], vi[j], r[j], back[j], sj[j], masks);
      wide |= !back[j] && r[j] > 64;
    }
    // a forward count past 64 codes (the last block): the row's second
    // half, loaded only when a query of the warp needs it
    if (__any_sync(kFull, wide)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = load_part(row[j], 4 + k, back[j] ? 0 : r[j], false, vec16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] += count_part(v[j], 4 + k, back[j] ? 0 : r[j], false, sj[j],
                           masks);
    }
    // 4. recursive halving over the group: lane k keeps query k's count
#pragma unroll
    for (int half = 2; half >= 1; half /= 2) {
      const bool hi = k & half;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const uint32_t keep = hi ? c[j + half] : c[j];
        const uint32_t send = hi ? c[j] : c[j + half];
        c[j] = keep + __shfl_xor_sync(kFull, send, half, 4);
      }
    }
    if (mine) {
      const int32_t n = (int32_t)c[0];
      out[base + lane] = from_end(p, nb) ? o - n : o + n;
    }
    p = pn;
    s = sn;
  }
}

// The card's resident blocks of the kernel (SMs x blocks an SM), read once
// a device.
int resident_blocks(int* blocks_out) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks_out = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, occ_batch_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks_out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *blocks_out;
  return 0;
}

}  // namespace

// blocks (nb, 128) int8 contiguous, 4-byte aligned, nb < 2^32; occ (nb +
// 1, sigma) int32 contiguous, the cumulative counts of the rows (row b + 1
// = row b + block b's counts, except the last row's padding), as an
// OccTable's are: a query past the middle of a block other than the last
// takes occ[b + 1] less the codes from pos on, so another occ gives other
// counts; syms, pos (q,) int32 contiguous, 0 <= sym < min(sigma, 128),
// 0 <= pos <= 128 nb; out (q,) int32.
extern "C" int dsm_occ_batch(const void* blocks, long long nb,
                             const void* occ, int sigma, const void* syms,
                             const void* pos, void* out, long long q,
                             void* stream) {
  if (q <= 0) return 0;
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err) return err;
  long long grid = (q + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  occ_batch_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)blocks, (uint32_t)nb, ((uintptr_t)blocks & 15) == 0,
      (const int32_t*)occ, sigma, (const int32_t*)syms, (const int32_t*)pos,
      (int32_t*)out, q);
  return (int)cudaGetLastError();
}
