// K4 on Hopper (sm_90a): the rumor epidemic with state in device memory,
// every round of a call in ONE launch.  Replaces
// partisan_tpu/ops/rumor_kernel_hbm.py::rumor_run_hbm (the Pallas TPU
// kernel, pallas_call at :448; _kernel_sync / _kernel_db / _block_round),
// which also ran a whole call as one pallas_call over a (rounds, blocks)
// grid.
//
// What it computes: state is [R, 128] words (a row holds 4096 nodes).  The
// partner of a node is a row translation q composed with an intra-row bit
// rotation r, both host-drawn per (round, fanout) by the ported threefry
// exactly as the reference draws them.  Partner rows are (row - q) mod R,
// computed directly: the TPU kernel's B-row halo existed so its DMA windows
// never wrapped and is not needed here.  The dup window reads rows
// (row + q0) mod R rotated by 4096 - r0.  The restart reseed uses the
// PREVIOUS round's count of hot & alive words and never fires on a call's
// first round; the last round's count is not applied inside the call.
// Churn (and the stop_k > 1 coin) bits come from a counter-based generator
// keyed by (round seed, round, word), fed through the same bit-serial
// Bernoulli expansion; the TPU's on-core PRNG bits cannot be replayed, so
// parity with the reference at churn > 0 is distributional, and exact at
// churn == 0.
//
// Design: one persistent cooperative grid (cudaLaunchCooperativeKernel, so
// every block is resident, which the hand-written barrier needs) loops over
// the rounds.  A block is 1024 threads: a group of 8 whole rows at a time,
// a word a thread; the blocks stride over the groups (at 2^24: 132 blocks,
// one an SM, four groups a block).  Few large blocks keep the barrier's
// arrivals few.  A thread takes the same words every round.  State is
// loaded and stored through L2 (__ldcg/__stcg): another block wrote a
// partner row in the previous round of this same launch, so an L1 line
// could be stale.  A word's loads (its own two, the dup row's two and two
// for each fanout) are independent of each other, and the fanout loop is
// unrolled so that they can go out together.  `alive` is read-only for the
// call (__ldg).
//
// One grid barrier a round, split into arrive and wait, on counts[i]
// (rumor_common.cuh; the wrapper zeroes counts):
//  - arrive: after its stores, thread 0 of each block adds 1, plus 2^16 if
//    any word of the block is hot & alive, with a release reduction.
//  - between arrive and wait: round i + 1's row of the table into shared
//    memory (the acquire below leaves no table line in L1), and its churn
//    and coin words of every word the thread takes, into shared memory:
//    the round's only heavy arithmetic (up to 15 mix32 hashes a word at
//    p = 0.01; a warp leaves a word's walk once none of its 32 words can
//    change, which is exact), which reads (word, salt) and no state.
//  - wait: thread 0 spins on an acquire load of counts[i] until all blocks
//    are in; __syncthreads releases the block.  Round i + 1 restarts the
//    rumor iff the high half is 0: the owner of patient zero's word ORs its
//    bit into that word of its output.
//
// Ping-pong safety with one barrier: round i + 1 writes the buffer that
// round i read.  Every block finishes its round-i reads before it arrives,
// and no block stores round i + 1 before its wait returns, so no store
// overtakes a read.  Only the mask work, which reads no state, sits between
// arrive and wait.
//
// What bounds it: operations.  At 2^24 a round moves 4 x 2 MB (2.5 us at
// 3.35 TB/s; the ping-pong lives in the 50 MB L2), while the churn walk
// needs about 6.35 of its 15 levels a word on average (chip_smoke.py
// round_ops_per_word; a warp runs ~11.3).  The walk's issue time on the
// integer pipe, and the loads' L2 latency (one a group) and the barrier,
// which it barely overlaps, set the pace of a round (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "rumor_common.cuh"

namespace {

constexpr int kLanes = 128;                      // words a row
constexpr int kCell = kLanes * 32;               // nodes a row
constexpr int kThreads = 1024;                   // a block
constexpr int kRowsPerBlock = kThreads / kLanes;  // rows a block at a time

struct HbmParams {
  const int32_t* table;   // [n_rounds, 2 * fanout + 3]: q0 r0 q1 r1 ...,
                          // coin salt, churn salt, patient zero
  const uint32_t* alive;  // [R * 128]; unread when all_alive
  uint32_t* inf;          // [2, R * 128] ping-pong; slot 0 holds the input
  uint32_t* hot;
  unsigned* counts;       // [n_rounds], 0 on entry: round i's barrier word
  int n_rounds, rows, fanout, all_alive;
  int coin_depth;         // 0: stop_k == 1, a sure coin
  uint32_t coin_ones;
  int churn_depth;        // 0: no churn
  uint32_t churn_ones;
};

// Shared memory of a block: the round's row of the table (padded to 32
// words), then the masks of the words the block takes, [groups a
// block][coin, churn][kThreads].
__host__ __device__ inline int rec_words(int fanout) {
  return (2 * fanout + 3 + 31) / 32 * 32;
}

size_t smem_bytes(int fanout, int groups_a_block) {
  return (rec_words(fanout) +
          static_cast<size_t>(groups_a_block) * 2 * kThreads) *
         sizeof(uint32_t);
}

// A round's coin and churn words of word `lane` of each of the thread's
// rows, into its slots (`masks`, then every 2 * kThreads words).  Whole
// warps take a row together, so the walk's warp exit sees all 32 lanes.
__device__ __forceinline__ void walk(const HbmParams& p, const int32_t* rec,
                                     uint32_t* masks, int row0,
                                     int row_stride, int lane) {
  const int salts = 2 * p.fanout;
  const uint32_t coin_salt = static_cast<uint32_t>(rec[salts]);
  const uint32_t churn_salt = static_cast<uint32_t>(rec[salts + 1]);
  for (int row = row0; row < p.rows;
       row += row_stride, masks += 2 * kThreads) {
    const uint32_t w = static_cast<uint32_t>(row * kLanes + lane);
    if (p.coin_depth > 0)
      masks[0] =
          rumor_biased_word<true>(w, coin_salt, p.coin_depth, p.coin_ones);
    if (p.churn_depth > 0)
      masks[kThreads] =
          rumor_biased_word<true>(w, churn_salt, p.churn_depth,
                                  p.churn_ones);
  }
}

// Word `lane` of `row` in one round: every load, then the bit operations
// and the stores.  Returns the word's new hot & alive bits.
__device__ __forceinline__ uint32_t step_word(
    const HbmParams& p, const int32_t* rec, const uint32_t* __restrict__ inf,
    const uint32_t* __restrict__ hot, uint32_t* __restrict__ inf_o,
    uint32_t* __restrict__ hot_o, int row, int lane, bool restart,
    const uint32_t* masks) {
  const int g = row * kLanes + lane;
  const uint32_t al = p.all_alive ? 0xFFFFFFFFu : __ldg(p.alive + g);
  const uint32_t f = __ldcg(inf + g), h = __ldcg(hot + g);
  int dr = row + rec[0];
  if (dr >= p.rows) dr -= p.rows;
  const uint32_t* irow = inf + static_cast<size_t>(dr) * kLanes;
  const int sd = kCell - rec[1];
  const uint32_t dup = rumor_rolled_word(
      [=](int k) { return __ldcg(irow + k); }, lane, sd >> 5, sd & 31, kLanes);
  uint32_t hit = 0u;
#pragma unroll 4
  for (int j = 0; j < p.fanout; ++j) {
    const int q = rec[2 * j], r = rec[2 * j + 1];
    int pr = row - q;
    if (pr < 0) pr += p.rows;
    const uint32_t* hrow = hot + static_cast<size_t>(pr) * kLanes;
    const uint32_t* arow = p.alive + static_cast<size_t>(pr) * kLanes;
    if (p.all_alive)
      hit |= rumor_rolled_word([=](int k) { return __ldcg(hrow + k); }, lane,
                               r >> 5, r & 31, kLanes);
    else
      hit |= rumor_rolled_word(
          [=](int k) { return __ldcg(hrow + k) & __ldg(arow + k); }, lane,
          r >> 5, r & 31, kLanes);
  }
  const uint32_t coin = p.coin_depth > 0 ? masks[0] : 0xFFFFFFFFu;
  const uint32_t reborn = p.churn_depth > 0 ? masks[kThreads] : 0u;
  uint32_t new_inf = f | (hit & al);
  uint32_t new_hot = (h | (new_inf & ~f)) & ~(dup & h & al & coin) & ~reborn;
  new_inf &= ~reborn;
  if (restart) {   // the previous round ended with no hot sender
    const int pz = rec[2 * p.fanout + 2];
    if ((pz >> 5) == g) {
      const uint32_t bit = 1u << (pz & 31);
      new_inf |= bit;
      new_hot |= bit;
    }
  }
  __stcg(inf_o + g, new_inf);
  __stcg(hot_o + g, new_hot);
  return new_hot & al;
}

__global__ void __launch_bounds__(kThreads, 1)
    rumor_hbm_kernel(HbmParams p) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  __shared__ unsigned s_count;  // round i's barrier word, as thread 0 saw it
  const int lane = threadIdx.x % kLanes;
  const int row0 = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int row_stride = gridDim.x * kRowsPerBlock;
  const int per_round = 2 * p.fanout + 3;
  const size_t nw = static_cast<size_t>(p.rows) * kLanes;
  // the round's row of the table: read from shared memory only, since the
  // grid barrier's acquire leaves no table line in L1
  int32_t* const rec = reinterpret_cast<int32_t*>(s_mem);
  uint32_t* const masks = s_mem + rec_words(p.fanout) + threadIdx.x;

  if (threadIdx.x < per_round) rec[threadIdx.x] = __ldg(p.table + threadIdx.x);
  walk(p, p.table, masks, row0, row_stride, lane);
  __syncthreads();
  bool restart = false;
  for (int i = 0;; ++i) {
    const uint32_t* inf = p.inf + (i & 1) * nw;
    const uint32_t* hot = p.hot + (i & 1) * nw;
    uint32_t* inf_o = p.inf + ((i + 1) & 1) * nw;
    uint32_t* hot_o = p.hot + ((i + 1) & 1) * nw;

    uint32_t seen = 0u;
    const uint32_t* m = masks;
    for (int row = row0; row < p.rows; row += row_stride, m += 2 * kThreads)
      seen |= step_word(p, rec, inf, hot, inf_o, hot_o, row, lane, restart,
                        m);
    const int any = __syncthreads_or(seen != 0u);
    if (threadIdx.x == 0)
      rumor_arrive(p.counts + i, 1u + (any ? kRumorHotBlock : 0u));
    if (i + 1 == p.n_rounds) break;
    // between arrive and wait: round i + 1's row of the table and masks,
    // which read no state
    const int32_t* next = p.table + static_cast<size_t>(i + 1) * per_round;
    if (threadIdx.x < per_round) rec[threadIdx.x] = __ldg(next + threadIdx.x);
    walk(p, next, masks, row0, row_stride, lane);
    if (threadIdx.x == 0) s_count = rumor_wait_all(p.counts + i, gridDim.x);
    __syncthreads();
    restart = (s_count >> 16) == 0u;
  }
}

// The barrier alone, on K4's grid: n_rounds of arrive and wait.  A
// measurement probe (the share of a K4 round that is the barrier).
__global__ void __launch_bounds__(kThreads) hbm_barrier_kernel(
    unsigned* counts, int n_rounds) {
  rumor_barrier_rounds(counts, n_rounds);
}

// Blocks of 8 rows, as many as the card holds at once (one an SM), and no
// more than the 8-row groups.
cudaError_t hbm_grid(int rows, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(rumor_hbm_kernel), kThreads,
        0);
  const int groups = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  *blocks = groups < per_sm * sms ? groups : per_sm * sms;
  return e;
}

}  // namespace

// Runs all n_rounds rounds in one launch on `stream` and returns its
// cudaError_t (0 on success).  All pointers are device pointers; inf and
// hot are [2, rows * 128] ping-pong buffers with the input in slot 0, and
// round i writes slot (i + 1) % 2; `counts` holds n_rounds zeroed int32.
// Past ~2^26.8 nodes the masks of a block's words no longer fit in shared
// memory (227 KB), and the launch fails.
extern "C" int rumor_hbm_run(const int32_t* table, int n_rounds, int fanout,
                             int rows, int all_alive, int coin_depth,
                             unsigned coin_ones, int churn_depth,
                             unsigned churn_ones, const int32_t* alive,
                             int32_t* inf, int32_t* hot, int32_t* counts,
                             void* stream) {
  HbmParams p;
  p.table = table;
  p.alive = reinterpret_cast<const uint32_t*>(alive);
  p.inf = reinterpret_cast<uint32_t*>(inf);
  p.hot = reinterpret_cast<uint32_t*>(hot);
  p.counts = reinterpret_cast<unsigned*>(counts);
  p.n_rounds = n_rounds;
  p.rows = rows;
  p.fanout = fanout;
  p.all_alive = all_alive;
  p.coin_depth = coin_depth;
  p.coin_ones = coin_ones;
  p.churn_depth = churn_depth;
  p.churn_ones = churn_ones;

  const void* kernel = reinterpret_cast<const void*>(rumor_hbm_kernel);
  int blocks = 0;
  cudaError_t e = hbm_grid(rows, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = smem_bytes(fanout, (groups + blocks - 1) / blocks);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The barrier probe on the grid rumor_hbm_run takes for n nodes; `counts`
// holds n_rounds zeroed int32.
extern "C" int rumor_hbm_barrier_run(int n_rounds, int n, int32_t* counts,
                                     void* stream) {
  int blocks = 0;
  cudaError_t e = hbm_grid(n / kCell, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* c = reinterpret_cast<unsigned*>(counts);
  void* args[] = {&c, &n_rounds};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hbm_barrier_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
