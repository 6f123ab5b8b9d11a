// K2: bucket_pack on one Hopper card (sm_90a).
//
// Replaces partisan_tpu/ops/route_kernel.py::bucket_pack_kernel (the
// pallas_call of _bp_call at :216; body _bp_kernel, a bitonic network over
// (key, index) and the first-change + prefix-max rank).  For each mail row
// i of a shard's outbox, key_i = shard[i] in [0, d] (d = "no shard": an
// invalid row) is its destination shard; in the stable order of the keys
// (lax.sort's order: by key, ties by i), the row at sorted position pos is
//     order[pos] = i,
//     tgt[pos]   = key * b + rank   if key < d and rank < b, else d * b,
// where rank = pos - (start of key's run), and dropped counts the valid
// rows with rank >= b: sum over s < d of max(0, count_s - b).
//
// Design.  The keys take only d + 1 values, so this is a stable counting
// sort, not a comparison sort: the rank of a row in its bucket is the
// number of earlier rows with the same key, whatever sort produced it.
//   1. bp_hist: each warp counts the keys of one chunk of CHUNK consecutive
//      rows, 32 at a time (__match_any_sync groups the lanes of one key;
//      the group's lowest lane adds its size), into a shared-memory
//      histogram, and writes it to counts[key * n_chunks + chunk].
//   2. bp_scan: one block per shard scans counts in that (key, chunk)
//      order, which gives each (key, chunk) its first sorted position; the
//      positions of chunk 0 are the bucket starts, and their differences
//      give `dropped`.
//   3. bp_scatter: each warp walks its chunk again in row order; a row's
//      position is its (key, chunk) offset plus the count of earlier rows
//      of its key in the chunk (the running count, plus the lanes below it
//      in its __match_any_sync group), so equal keys keep row order.
// One call packs every shard's outbox: blockIdx.y is the shard.
// Bound on this card: bytes.  The call must read the m int32 keys of each
// shard and write tgt and order, 12 bytes a row; its operations (~10 a
// row) take a fifth of that time.  This design reads the keys twice and
// writes the positions in d + 1 interleaved streams a warp, so it moves
// ~16 bytes a row, partly uncoalesced; the scan adds (d + 1) / CHUNK int32
// reads and writes a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // warps a block, one chunk each
constexpr int CHUNK = 256;           // rows a warp ranks (8 steps of 32);
                                     // ops/route_kernel.py BUCKET_CHUNK
constexpr int MAX_BUCKETS = 256;     // d + 1 <= 256 (the wrapper checks)
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The row's bucket, or -1 past the end; ids outside [0, d] count as d.
__device__ __forceinline__ int key_of(const int* sh, long long row, int m,
                                      int d) {
  if (row >= m) return -1;
  const int k = sh[row];
  return (k >= 0 && k <= d) ? k : d;
}

__global__ void bp_hist(const int* __restrict__ shard, int m, int d,
                        int n_chunks, int* __restrict__ counts) {
  __shared__ int cnt[WARPS][MAX_BUCKETS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * WARPS + warp;
  if (chunk >= n_chunks) return;  // the whole warp
  const int* sh = shard + (size_t)blockIdx.y * m;
  int* cn = counts + (size_t)blockIdx.y * (d + 1) * n_chunks;
  for (int k = lane; k <= d; k += 32) cnt[warp][k] = 0;
  __syncwarp();
  for (int step = 0; step < CHUNK / 32; ++step) {
    const long long row = (long long)chunk * CHUNK + step * 32 + lane;
    const int key = key_of(sh, row, m, d);
    const unsigned peers = __match_any_sync(FULL, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      cnt[warp][key] += __popc(peers);
    __syncwarp();
  }
  for (int k = lane; k <= d; k += 32)
    cn[(size_t)k * n_chunks + chunk] = cnt[warp][k];
}

__global__ void bp_scan(int* __restrict__ counts, int m, int d, int b,
                        int n_chunks, int* __restrict__ bstart,
                        int* __restrict__ dropped) {
  __shared__ int part[SCAN_THREADS];
  const int t = threadIdx.x;
  int* cn = counts + (size_t)blockIdx.x * (d + 1) * n_chunks;
  int* bs = bstart + (size_t)blockIdx.x * (d + 2);
  const long long len = (long long)(d + 1) * n_chunks;
  const long long per = (len + blockDim.x - 1) / blockDim.x;
  const long long lo = per * t < len ? per * t : len;
  const long long hi = lo + per < len ? lo + per : len;
  int sum = 0;
  for (long long i = lo; i < hi; ++i) sum += cn[i];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {  // inclusive, in place
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;  // exclusive prefix of this thread's range
  for (long long i = lo; i < hi; ++i) {
    const int c = cn[i];
    cn[i] = run;
    run += c;
  }
  __syncthreads();
  for (int k = t; k <= d; k += blockDim.x) bs[k] = cn[(size_t)k * n_chunks];
  if (t == 0) bs[d + 1] = m;
  __syncthreads();
  if (t == 0) {
    int drop = 0;
    for (int k = 0; k < d; ++k) {
      const int c = bs[k + 1] - bs[k];
      if (c > b) drop += c - b;
    }
    dropped[blockIdx.x] = drop;
  }
}

__global__ void bp_scatter(const int* __restrict__ shard, int m, int d,
                           int b, int n_chunks, const int* __restrict__ offs,
                           const int* __restrict__ bstart,
                           int* __restrict__ tgt, int* __restrict__ order) {
  __shared__ int cnt[WARPS][MAX_BUCKETS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * WARPS + warp;
  if (chunk >= n_chunks) return;  // the whole warp
  const size_t s = blockIdx.y;
  const int* sh = shard + s * m;
  const int* of = offs + s * (d + 1) * n_chunks;
  const int* bs = bstart + s * (d + 2);
  int* tg = tgt + s * m;
  int* od = order + s * m;
  for (int k = lane; k <= d; k += 32)
    cnt[warp][k] = of[(size_t)k * n_chunks + chunk];
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int step = 0; step < CHUNK / 32; ++step) {
    const long long row = (long long)chunk * CHUNK + step * 32 + lane;
    const int key = key_of(sh, row, m, d);
    const unsigned peers = __match_any_sync(FULL, key);
    int pos = 0;
    if (key >= 0) pos = cnt[warp][key] + __popc(peers & below);
    __syncwarp();  // every lane has read its key's count
    if (key >= 0 && lane == __ffs(peers) - 1)
      cnt[warp][key] += __popc(peers);
    __syncwarp();
    if (key >= 0) {
      od[pos] = (int)row;
      const int rank = pos - bs[key];
      tg[pos] = (key < d && rank < b) ? key * b + rank : d * b;
    }
  }
}

}  // namespace

// shard [n_sh, m] int32 on the card; counts >= n_sh * (d+1) * n_chunks
// int32 and bstart >= n_sh * (d+2) int32 of scratch (n_chunks = ceil(m /
// CHUNK)); tgt and order [n_sh, m] int32; dropped [n_sh] int32.  The
// wrapper checks 1 <= m <= 2^30, 1 <= n_sh <= 65535, 1 <= d < MAX_BUCKETS,
// b >= 1 and d * b < 2^31.  All launches go to `stream`; returns the first
// launch error (0 = none).
extern "C" int bucket_pack_run(const int* shard, int n_sh, int m, int d,
                               int b, int* counts, int* bstart, int* tgt,
                               int* order, int* dropped,
                               cudaStream_t stream) {
  const int n_chunks = (m + CHUNK - 1) / CHUNK;
  const dim3 grid((n_chunks + WARPS - 1) / WARPS, n_sh);
  cudaError_t err;
  bp_hist<<<grid, WARPS * 32, 0, stream>>>(shard, m, d, n_chunks, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bp_scan<<<n_sh, SCAN_THREADS, 0, stream>>>(counts, m, d, b, n_chunks,
                                             bstart, dropped);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bp_scatter<<<grid, WARPS * 32, 0, stream>>>(shard, m, d, b, n_chunks,
                                              counts, bstart, tgt, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
