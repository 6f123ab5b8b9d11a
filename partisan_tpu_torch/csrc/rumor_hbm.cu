// K4 on Hopper (sm_90a): the rumor epidemic with state in device memory,
// one launch per round.  Replaces
// partisan_tpu/ops/rumor_kernel_hbm.py::rumor_run_hbm (the Pallas TPU
// kernel, pallas_call at :448; _kernel_sync / _kernel_db / _block_round).
//
// What it computes: state is [R, 128] words (a row holds 4096 nodes).  The
// partner of a node is a row translation q composed with an intra-row bit
// rotation r, both host-drawn per (round, fanout) by the ported threefry
// exactly as the reference draws them.  Partner rows are (row - q) mod R,
// computed directly: the TPU kernel's B-row halo existed so its DMA windows
// never wrapped and is not needed here.  The dup window reads rows
// (row + q0) mod R rotated by 4096 - r0.  The restart reseed uses the
// PREVIOUS round's count of hot & alive words and never fires on a call's
// first round.  Churn (and the stop_k > 1 coin) bits come from a
// counter-based generator keyed by (round seed, round, word), fed through
// the same bit-serial Bernoulli expansion; the TPU's on-core PRNG bits
// cannot be replayed, so parity with the reference at churn > 0 is
// distributional, and exact at churn == 0.
//
// Design: one block of 128 threads per row, one word per thread; the
// rotated reads of a partner row hit the same few cache lines as the
// block's neighbours.  State ping-pongs between two global buffers; each
// block adds its count of hot & alive words to counts[round] with one
// atomicAdd, and round i + 1 (the next launch, stream-ordered) reads it.
//
// What bounds it: bytes.  With all_alive a round must read infected and
// hot and write both back, 4 x 2 MB at 2^24 nodes (~2.5 us at 3.35 TB/s);
// the windows re-read those rows through L1/L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "rumor_common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kCell = kLanes * 32;

struct HbmParams {
  const int32_t* rec;     // this round: q0 r0 q1 r1 ... coin salt,
                          // churn salt, patient zero
  const uint32_t* alive;  // [R * 128]; unread when all_alive
  const uint32_t* inf;    // previous round, [R * 128]
  const uint32_t* hot;
  uint32_t* inf_o;        // this round's output
  uint32_t* hot_o;
  int* counts;            // [n_rounds] hot & alive words per round, 0 on entry
  int round, rows, fanout, all_alive;
  int coin_depth;         // 0: stop_k == 1, a sure coin
  uint32_t coin_ones;
  int churn_depth;        // 0: no churn
  uint32_t churn_ones;
};

__global__ void __launch_bounds__(kLanes) rumor_hbm_round(HbmParams p) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int g = row * kLanes + lane;
  const uint32_t al = p.all_alive ? 0xFFFFFFFFu : p.alive[g];

  uint32_t hit = 0u;
  for (int j = 0; j < p.fanout; ++j) {
    const int q = p.rec[2 * j], r = p.rec[2 * j + 1];
    int pr = row - q;
    if (pr < 0) pr += p.rows;
    const uint32_t* hrow = p.hot + static_cast<size_t>(pr) * kLanes;
    const uint32_t* arow = p.alive + static_cast<size_t>(pr) * kLanes;
    if (p.all_alive)
      hit |= rumor_rolled_word([=](int k) { return hrow[k]; }, lane, r >> 5,
                               r & 31, kLanes);
    else
      hit |= rumor_rolled_word([=](int k) { return hrow[k] & arow[k]; },
                               lane, r >> 5, r & 31, kLanes);
  }

  const uint32_t h = p.hot[g], f = p.inf[g];
  const uint32_t send = h & al;
  uint32_t new_inf = f | (hit & al);
  int dr = row + p.rec[0];
  if (dr >= p.rows) dr -= p.rows;
  const uint32_t* irow = p.inf + static_cast<size_t>(dr) * kLanes;
  const int sd = kCell - p.rec[1];
  const uint32_t dup = rumor_rolled_word([=](int k) { return irow[k]; }, lane,
                                         sd >> 5, sd & 31, kLanes) & send;
  uint32_t new_hot = h | (new_inf & ~f);
  const int salts = 2 * p.fanout;
  if (p.coin_depth == 0) {
    new_hot &= ~dup;
  } else {
    new_hot &= ~(dup & rumor_biased_word(static_cast<uint32_t>(g),
                                         static_cast<uint32_t>(p.rec[salts]),
                                         p.coin_depth, p.coin_ones));
  }
  if (p.churn_depth > 0) {
    const uint32_t reborn = rumor_biased_word(
        static_cast<uint32_t>(g), static_cast<uint32_t>(p.rec[salts + 1]),
        p.churn_depth, p.churn_ones);
    new_inf &= ~reborn;
    new_hot &= ~reborn;
  }
  // restart: the previous round ended with no hot sender
  if (p.round > 0 && p.counts[p.round - 1] == 0) {
    const int pz = p.rec[salts + 2];
    if ((pz >> 5) == g) {
      const uint32_t bit = 1u << (pz & 31);
      new_inf |= bit;
      new_hot |= bit;
    }
  }
  p.inf_o[g] = new_inf;
  p.hot_o[g] = new_hot;
  const int c = __syncthreads_count((new_hot & al) != 0u);
  if (lane == 0 && c) atomicAdd(p.counts + p.round, c);
}

}  // namespace

// Launches n_rounds rounds on `stream` and returns the first non-zero
// cudaError_t (0 on success).  inf and hot are [2, rows * 128] ping-pong
// buffers with the input in slot 0; round i writes slot (i + 1) % 2.
extern "C" int rumor_hbm_run(const int32_t* table, int n_rounds, int fanout,
                             int rows, int all_alive, int coin_depth,
                             unsigned coin_ones, int churn_depth,
                             unsigned churn_ones, const int32_t* alive,
                             int32_t* inf, int32_t* hot, int32_t* counts,
                             void* stream) {
  const size_t nw = static_cast<size_t>(rows) * kLanes;
  uint32_t* infb = reinterpret_cast<uint32_t*>(inf);
  uint32_t* hotb = reinterpret_cast<uint32_t*>(hot);
  HbmParams p;
  p.alive = reinterpret_cast<const uint32_t*>(alive);
  p.counts = counts;
  p.rows = rows;
  p.fanout = fanout;
  p.all_alive = all_alive;
  p.coin_depth = coin_depth;
  p.coin_ones = coin_ones;
  p.churn_depth = churn_depth;
  p.churn_ones = churn_ones;
  for (int i = 0; i < n_rounds; ++i) {
    p.rec = table + static_cast<size_t>(i) * (2 * fanout + 3);
    p.round = i;
    p.inf = infb + (i & 1) * nw;
    p.hot = hotb + (i & 1) * nw;
    p.inf_o = infb + ((i + 1) & 1) * nw;
    p.hot_o = hotb + ((i + 1) & 1) * nw;
    rumor_hbm_round<<<rows, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
