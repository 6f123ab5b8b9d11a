// K1: reverse_select on one Hopper card (sm_90a).
//
// Replaces partisan_tpu/ops/route_kernel.py::reverse_select_kernel (the
// pallas_call of _rs_call; body _rs_kernel, network _bitonic/_cmpex, rank
// _rank_in_buckets/_cummax) and computes exactly
// ops/shard_exchange.reverse_select: node i proposes to targets[i] (-1 or
// out of [0, n) = none); each target t keeps the first c proposers in the
// order of the packed key
//     key_i = (sk_i << bits) | (mix32(i ^ salt) >> (32 - bits)),
//     sk_i  = targets[i] if valid else n,  bits = 31 - bitlen(n),
// ties in key_i broken by i (lax.sort's stable order); out[t*c + pos] is
// that proposer's id, -1 elsewhere.
//
// Design.  The 64-bit composite key (key_i << 32 | i) is unique, so its
// ascending order IS the stable order and any correct sort meets the
// contract.  This first version keeps the TPU kernel's bitonic network
// over M = pow2 >= m keys (padding 0xFFFFFFFF << 32 | i sorts last):
//   - rs_tile sorts each tile of TILE keys in shared memory (all strides
//     j < TILE of every merge size k <= TILE), then, for each larger k,
//     finishes the strides j < TILE in one more shared-memory launch;
//   - rs_merge runs each stride j >= TILE as one global compare-exchange
//     launch (at M = 2^20: 36 of them, plus 9 tile launches);
//   - rs_emit reads the sorted keys: its bucket offset is the count of
//     the up to c preceding entries with the same target, which equals the
//     reference's prefix-max rank wherever it is < c, so no scan is
//     needed; it writes straight into out (pre-filled with -1), fused with
//     the scatter, which has no conflicts because targets are unique.
// Bound on this card: bytes.  The call must read m int32 targets, write
// n*c int32 and move the m 8-byte keys once each way; the sort's
// log^2(M)/2 passes over the keys are what this version spends beyond
// that (a radix sort, or fewer passes, is later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;          // keys per shared-memory tile: 32 KB
constexpr int TILE_THREADS = 1024;  // two compare-exchanges per thread
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Lower element of compare-exchange pair p at stride j (bit j clear).
__device__ __forceinline__ int pair_lo(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Ascending where bit k of the flat position is clear; keys are unique.
__device__ __forceinline__ bool out_of_order(uint64_t a, uint64_t b,
                                             bool asc) {
  return (a > b) == asc;
}

__global__ void rs_pack(const int* __restrict__ targets, uint32_t salt,
                        int m, int M, int n, int bits,
                        uint64_t* __restrict__ keys) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += gridDim.x * blockDim.x) {
    uint32_t hi = 0xFFFFFFFFu;
    if (i < m) {
      int t = targets[i];
      uint32_t sk = (t >= 0 && t < n) ? (uint32_t)t : (uint32_t)n;
      uint32_t r = mix32((uint32_t)i ^ salt);
      hi = (sk << bits) | (r >> (32 - bits));
    }
    keys[i] = ((uint64_t)hi << 32) | (uint32_t)i;
  }
}

// All strides j < tile of merge sizes k_lo..k_hi (powers of two), one
// tile of keys per block in shared memory.
__global__ void rs_tile(uint64_t* __restrict__ keys, int tile, int k_lo,
                        int k_hi) {
  extern __shared__ uint64_t sh[];
  const int base = blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) sh[t] = keys[base + t];
  __syncthreads();
  for (int k = k_lo;; k <<= 1) {
    for (int j = min(k, tile) >> 1; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < (tile >> 1); p += blockDim.x) {
        int i = pair_lo(p, j);
        uint64_t a = sh[i], b = sh[i + j];
        if (out_of_order(a, b, ((base + i) & k) == 0)) {
          sh[i] = b;
          sh[i + j] = a;
        }
      }
      __syncthreads();
    }
    if (k >= k_hi) break;  // (k <= k_hi would overflow at k = 2^30)
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) keys[base + t] = sh[t];
}

// One stride j >= tile of merge size k, over device memory.
__global__ void rs_merge(uint64_t* __restrict__ keys, int half, int j,
                         int k) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < half;
       p += gridDim.x * blockDim.x) {
    int i = pair_lo(p, j);
    uint64_t a = keys[i], b = keys[i + j];
    if (out_of_order(a, b, (i & k) == 0)) {
      keys[i] = b;
      keys[i + j] = a;
    }
  }
}

__global__ void rs_emit(const uint64_t* __restrict__ keys, int m, int n,
                        int c, int bits, int* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x) {
    uint64_t s = keys[i];
    uint32_t st = (uint32_t)(s >> 32) >> bits;
    if (st >= (uint32_t)n) continue;
    int pos = 0;
    while (pos < c && i - pos > 0 &&
           ((uint32_t)(keys[i - pos - 1] >> 32) >> bits) == st)
      ++pos;
    if (pos < c) out[st * c + pos] = (int)(uint32_t)s;
  }
}

int blocks_for(long long items) {
  long long b = (items + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > (1 << 20) ? (1 << 20) : b));
}

}  // namespace

// targets [m] int32 on the card; scratch >= M uint64 (M = pow2 >= m);
// out [n*c] int32.  The wrapper checks 1 <= m <= 2^30, 1 <= n < 2^27,
// c >= 1, n*c < 2^31 and bits = 31 - bitlen(n).  All launches go to
// `stream`; returns the first launch error (0 = none).
extern "C" int route_select_run(const int* targets, unsigned salt, int m,
                                int n, int c, int bits, void* scratch,
                                int* out, cudaStream_t stream) {
  uint64_t* keys = static_cast<uint64_t*>(scratch);
  int M = 1;
  while (M < m) M <<= 1;
  cudaError_t err;
#define RS_CHECK()                                  \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  rs_pack<<<blocks_for(M), THREADS, 0, stream>>>(targets, salt, m, M, n,
                                                 bits, keys);
  RS_CHECK();
  const int tile = M < TILE ? M : TILE;
  const int tile_threads = tile / 2 < TILE_THREADS ? tile / 2 : TILE_THREADS;
  const size_t smem = (size_t)tile * sizeof(uint64_t);
  if (tile > 1) {
    rs_tile<<<M / tile, tile_threads, smem, stream>>>(keys, tile, 2, tile);
    RS_CHECK();
  }
  for (long long k = 2LL * tile; k <= M; k <<= 1) {
    for (long long j = k / 2; j >= tile; j >>= 1) {
      rs_merge<<<blocks_for(M / 2), THREADS, 0, stream>>>(keys, M / 2,
                                                          (int)j, (int)k);
      RS_CHECK();
    }
    rs_tile<<<M / tile, tile_threads, smem, stream>>>(keys, tile, (int)k,
                                                      (int)k);
    RS_CHECK();
  }
  err = cudaMemsetAsync(out, 0xFF, (size_t)n * c * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  rs_emit<<<blocks_for(m), THREADS, 0, stream>>>(keys, m, n, c, bits, out);
  RS_CHECK();
#undef RS_CHECK
  return 0;
}
