// The children step of a trie level: the kept (pair, symbol) lanes become the
// next level's pair rows in (node, symbol, pair) order, with the child ids,
// the next node starts and the history entries.
//
// Replaces the children block of dsm_tpu/mining/engine_device.py
// _level_single: a 5-operand lax.sort of the 4B lanes keyed on
// hv = (nid*4 + c)*P2 + poff (with a drop sentinel), a boundary cumsum for
// the child ids, and a second sort that writes the history entries and the
// nb boundaries.  A node's pairs are already contiguous and in pair order,
// so every output slot follows from scans and no sort is needed:
//
//   1. count:   one thread per node counts its kept lanes per symbol (a node
//               has at most MAX_SAMPLES = 512 pairs) and the block sums the
//               packed value (kept lanes << 32 | symbols with one);
//   2. scan:    one block turns the block sums into exclusive block offsets;
//   3. scatter: each block scans its nodes' packed values again (warp
//               shuffles), so node u knows its first output row and its
//               first child id; it gives each of its symbols with kept lanes
//               a child id, writes that child's nb_next entry and history
//               entry u*4 + c, and walks its pairs writing each kept lane's
//               row at its symbol's next slot.  The last node writes
//               nb_next[child_total] = pair_count.
//
// What bounds it on an H100: bytes.  Per pair it reads the keep mask twice
// (4 + 4 bytes), 12 bytes of the pair row and, per kept lane, 16 bytes of the
// rank outputs; it writes 24 bytes a kept lane.  Neighbouring threads walk
// neighbouring pair ranges; the row writes of one thread are contiguous per
// symbol.  Writes past pair_count or child_total are dropped (the host's
// counts size the outputs).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // nodes (and threads) per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long packed(int4 c) {
  long long lanes = (long long)c.x + c.y + c.z + c.w;
  long long kids = (c.x > 0) + (c.y > 0) + (c.z > 0) + (c.w > 0);
  return (lanes << 32) | kids;
}

__global__ void count_kernel(const int32_t* __restrict__ nb,
                             const uint8_t* __restrict__ keep, long long U,
                             long long P, int4* __restrict__ cnt,
                             long long* __restrict__ block_sum) {
  __shared__ long long warp_sum[kWarps];
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long v = 0;
  if (u < U) {
    int s = nb[u], e = nb[u + 1];
    int4 c = make_int4(0, 0, 0, 0);
    for (int p = s; p < e; ++p) {
      c.x += keep[p];
      c.y += keep[P + p];
      c.z += keep[2 * P + p];
      c.w += keep[3 * P + p];
    }
    cnt[u] = c;
    v = packed(c);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_sum[w];
    block_sum[blockIdx.x] = t;
  }
}

// One block of 1024 threads: thread t owns a contiguous chunk of the block
// sums, so any number of blocks is scanned in one launch.
__global__ void scan_kernel(const long long* __restrict__ block_sum,
                            long long nblocks,
                            long long* __restrict__ block_off) {
  __shared__ long long part[1024];
  int t = threadIdx.x;
  long long chunk = (nblocks + 1023) / 1024;
  long long b0 = t * chunk;
  long long b1 = b0 + chunk < nblocks ? b0 + chunk : nblocks;
  long long s = 0;
  for (long long b = b0; b < b1; ++b) s += block_sum[b];
  part[t] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the 1024 chunk sums
  for (int o = 1; o < 1024; o <<= 1) {
    long long v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - s;  // exclusive
  for (long long b = b0; b < b1; ++b) {
    block_off[b] = run;
    run += block_sum[b];
  }
}

__global__ void scatter_kernel(
    const int32_t* __restrict__ nb, const int32_t* __restrict__ pairs,
    const int32_t* __restrict__ olo, const int32_t* __restrict__ ohi,
    const uint8_t* __restrict__ keep, long long U, long long P,
    const int4* __restrict__ cnt, const long long* __restrict__ block_off,
    long long pair_count, long long child_total, int32_t* __restrict__ newp,
    int32_t* __restrict__ nb_next, int32_t* __restrict__ hist) {
  __shared__ long long warp_off[kWarps];
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  int4 c = u < U ? cnt[u] : make_int4(0, 0, 0, 0);
  long long v = packed(c);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long run = 0;
    for (int w = 0; w < kWarps; ++w) {
      long long t = warp_off[w];
      warp_off[w] = run;
      run += t;
    }
  }
  __syncthreads();
  if (u >= U) return;
  long long first = block_off[blockIdx.x] + warp_off[warp] + incl - v;
  long long row = first >> 32;             // the node's first output row
  long long kid = first & 0xFFFFFFFFll;    // the node's first child id
  const int count[4] = {c.x, c.y, c.z, c.w};
  long long slot[4];
  int child[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    slot[s] = row;
    row += count[s];
    child[s] = (int)kid;
    if (count[s] > 0) {
      if (kid < child_total) {
        nb_next[kid] = (int32_t)slot[s];
        hist[kid] = (int32_t)(u * 4 + s);
      }
      ++kid;
    }
  }
  if (u == U - 1 && kid <= child_total) nb_next[kid] = (int32_t)row;
  int pb = nb[u], pe = nb[u + 1];
  for (int p = pb; p < pe; ++p) {
    const int32_t* src = pairs + (long long)p * 6;
    uint32_t rlo = (uint32_t)src[2];
    int32_t sid = src[3], soff = src[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!keep[s * P + p]) continue;
      long long d = slot[s]++;
      if (d >= pair_count) continue;
      int32_t* to = newp + d * 6;
      to[0] = olo[s * P + p];
      to[1] = ohi[s * P + p];
      to[2] = (int32_t)(rlo + ((uint32_t)ohi[(4 + s) * P + p] -
                               (uint32_t)olo[(4 + s) * P + p]));
      to[3] = sid;
      to[4] = soff;
      to[5] = child[s];
    }
  }
}

}  // namespace

// cnt: (U, 4) int32; scratch: 2 * nblocks int64 (block sums, then block
// offsets), nblocks = ceil(U / 256).  U >= 1.
extern "C" int dsm_children(const void* nb, const void* pairs, const void* olo,
                            const void* ohi, const void* keep, long long U,
                            long long P, long long pair_count,
                            long long child_total, void* cnt, void* scratch,
                            void* newp, void* nb_next, void* hist,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long nblocks = (U + kThreads - 1) / kThreads;
  long long* block_sum = (long long*)scratch;
  long long* block_off = block_sum + nblocks;
  count_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
      (const int32_t*)nb, (const uint8_t*)keep, U, P, (int4*)cnt, block_sum);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, 1024, 0, s>>>(block_sum, nblocks, block_off);
  err = (int)cudaGetLastError();
  if (err) return err;
  scatter_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
      (const int32_t*)nb, (const int32_t*)pairs, (const int32_t*)olo,
      (const int32_t*)ohi, (const uint8_t*)keep, U, P, (const int4*)cnt,
      block_off, pair_count, child_total, (int32_t*)newp, (int32_t*)nb_next,
      (int32_t*)hist);
  return (int)cudaGetLastError();
}
