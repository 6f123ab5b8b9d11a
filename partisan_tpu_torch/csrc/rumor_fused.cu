// K3 on Hopper (sm_90a): n_rounds of packed push rumor mongering in ONE
// launch.  Replaces partisan_tpu/ops/rumor_kernel.py::rumor_run_fused (the
// Pallas TPU kernel, pallas_call at :180).
//
// What it computes: the "packed" round of make_rumor_step_packed
// (partisan_tpu/models/demers.py:361-412), bit for bit, for every row of
// a host-drawn table (shifts, coin salt, churn salt, patient zero per
// round — drawn by the ported threefry, since the TPU's on-core PRNG bits
// cannot be replayed elsewhere).  Bit j of word w is node 32*w + j.
//
// Design: one persistent cooperative grid (co-resident blocks only, sized
// by the occupancy API) loops over the rounds.  State ping-pongs between
// two global buffers; at 2^20 nodes the three 128 KB bitsets live in the
// 50 MB L2, so loads and stores go through L2 (__ldcg/__stcg) and never
// see a stale L1 line from an earlier round.  The same-round restart needs
// a grid-wide "any hot left": blocks OR into a device flag, grid.sync(),
// one thread reseeds patient zero if the flag is 0 and clears it,
// grid.sync().
//
// What bounds it: not bytes (5 x 128 KB a round at 2^20 is ~0.2 us at
// 3.35 TB/s) but the two grid-wide barriers per round, whose latency is
// paid 2 * n_rounds times; the churn mask (15 mix32 hashes a word at
// p = 0.01) is the largest share of the arithmetic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rumor_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct FusedParams {
  const int32_t* table;   // [n_rounds, fanout + 3]: shifts, coin salt,
                          // churn salt, patient zero
  const uint32_t* alive;  // [nw]
  uint32_t* inf;          // [2, nw] ping-pong; slot 0 holds the input
  uint32_t* hot;          // [2, nw]
  int* flag;              // [1], 0 on entry: a hot & alive word was seen
  int n_rounds, fanout, nw, n;
  int coin_depth;         // 0: stop_k == 1, a sure coin
  uint32_t coin_ones;
  int churn_depth;        // 0: no churn
  uint32_t churn_ones;
};

__global__ void __launch_bounds__(kThreads) rumor_fused_kernel(FusedParams p) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rec = p.fanout + 3;
  const uint32_t* alive = p.alive;

  for (int i = 0; i < p.n_rounds; ++i) {
    const int32_t* row = p.table + static_cast<size_t>(i) * rec;
    const uint32_t* inf = p.inf + static_cast<size_t>(i & 1) * p.nw;
    const uint32_t* hot = p.hot + static_cast<size_t>(i & 1) * p.nw;
    uint32_t* inf_o = p.inf + static_cast<size_t>((i + 1) & 1) * p.nw;
    uint32_t* hot_o = p.hot + static_cast<size_t>((i + 1) & 1) * p.nw;
    auto load_send = [=](int k) { return __ldcg(hot + k) & __ldg(alive + k); };
    auto load_inf = [=](int k) { return __ldcg(inf + k); };
    const int sd = p.n - row[0];  // dup: roll infected by n - s0

    int seen = 0;
    for (int w = tid; w < p.nw; w += stride) {
      const uint32_t a = __ldg(alive + w);
      const uint32_t h = __ldcg(hot + w);
      const uint32_t f = __ldcg(inf + w);
      const uint32_t send = h & a;
      uint32_t hit = 0u;
      for (int j = 0; j < p.fanout; ++j) {
        const int s = row[j];
        hit |= rumor_rolled_word(load_send, w, s >> 5, s & 31, p.nw);
      }
      uint32_t new_inf = f | (hit & a);
      const uint32_t dup =
          rumor_rolled_word(load_inf, w, sd >> 5, sd & 31, p.nw) & send;
      uint32_t new_hot = h | (new_inf & ~f);
      if (p.coin_depth == 0) {
        new_hot &= ~dup;
      } else {
        const uint32_t coin = rumor_biased_word(
            static_cast<uint32_t>(w), static_cast<uint32_t>(row[p.fanout]),
            p.coin_depth, p.coin_ones);
        new_hot &= ~(dup & coin);
      }
      if (p.churn_depth > 0) {
        const uint32_t reborn = rumor_biased_word(
            static_cast<uint32_t>(w), static_cast<uint32_t>(row[p.fanout + 1]),
            p.churn_depth, p.churn_ones);
        new_inf &= ~reborn;
        new_hot &= ~reborn;
      }
      seen |= (new_hot & a) != 0u;
      __stcg(inf_o + w, new_inf);
      __stcg(hot_o + w, new_hot);
    }
    if (__syncthreads_or(seen) && threadIdx.x == 0) atomicOr(p.flag, 1);
    grid.sync();
    if (tid == 0 && atomicExch(p.flag, 0) == 0) {
      // the rumor died this round: a new one starts at patient zero
      const int pz = row[p.fanout + 2];
      const uint32_t bit = 1u << (pz & 31);
      __stcg(inf_o + (pz >> 5), __ldcg(inf_o + (pz >> 5)) | bit);
      __stcg(hot_o + (pz >> 5), __ldcg(hot_o + (pz >> 5)) | bit);
    }
    grid.sync();
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers; `stream` is a cudaStream_t.
extern "C" int rumor_fused_run(const int32_t* table, int n_rounds, int fanout,
                               int n, int coin_depth, unsigned coin_ones,
                               int churn_depth, unsigned churn_ones,
                               const int32_t* alive, int32_t* inf,
                               int32_t* hot, int32_t* flag, void* stream) {
  FusedParams p;
  p.table = table;
  p.alive = reinterpret_cast<const uint32_t*>(alive);
  p.inf = reinterpret_cast<uint32_t*>(inf);
  p.hot = reinterpret_cast<uint32_t*>(hot);
  p.flag = flag;
  p.n_rounds = n_rounds;
  p.fanout = fanout;
  p.nw = n / 32;
  p.n = n;
  p.coin_depth = coin_depth;
  p.coin_ones = coin_ones;
  p.churn_depth = churn_depth;
  p.churn_ones = churn_ones;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rumor_fused_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int need = (p.nw + kThreads - 1) / kThreads;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rumor_fused_kernel),
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
