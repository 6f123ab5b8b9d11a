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
// Design: one persistent cooperative grid (cudaLaunchCooperativeKernel,
// so every block is resident, which the hand-written barrier needs) loops
// over the rounds, a word a thread (at 2^20: 128 blocks of 256 threads).
// State ping-pongs between two global buffers; at 2^20 nodes the bitsets
// live in the 50 MB L2, so loads and stores go through L2 (__ldcg/__stcg)
// and never see a stale L1 line from an earlier round.
//
// One grid barrier a round, split into arrive and wait, on counts[i] (one
// word a round, zeroed by the wrapper):
//  - arrive: after its stores, thread 0 of each block adds 1, plus 2^16
//    if any word of the block is hot & alive, to counts[i] with a release
//    reduction.  The low half counts the blocks in, the high half the
//    blocks with a sender left.
//  - between arrive and wait: the next round's churn and coin words of
//    the thread's own word.  They read (word, salt) and no state, and
//    they are the round's only heavy arithmetic (the churn mask is 15
//    mix32 hashes a word at p = 0.01).  The next row of the table was
//    loaded at the top of the round.
//  - wait: thread 0 spins on an acquire load of counts[i] until all
//    gridDim.x blocks are in; __syncthreads releases the block.
// The same-round restart is folded into that barrier.  The rumor died in
// round i iff counts[i] >> 16 == 0; then every load that round i + 1 makes
// of word pz_i >> 5 (its own word and every rolled read) ORs in patient
// zero's bit.  That is the reference's order (partisan_tpu/ops/
// rumor_kernel.py:129-135): `dead` is taken before the bit is added, and
// the next round sees the bit in both infected and hot.  After the last
// round, block 0 waits once more and applies that round's reseed to the
// output.
//
// Ping-pong safety with one barrier: round i + 1 writes the buffer that
// round i read.  Every block finishes its round-i reads before it
// arrives, and no block stores round i + 1 before its wait returns, so no
// store overtakes a read.  Only the mask work, which reads no state, may
// sit between arrive and wait.
//
// What bounds it: the bound at 2^20 is operations (the churn mask's chain
// at the levels a word needs, 4.16 ms a 20,000-round launch, 0.21 us a
// round), not bytes (5 x 128 KB a round).  What sets the pace is the chain
// of latencies a round: the barrier's round trip and one L2 load latency
// for the rolled reads, all 2 * (fanout + 1) of them and their alive words
// issued together (fanout 1-4; the runtime loop for a larger fanout issues
// them roll by roll).  The kernel this replaces paid two cooperative-groups
// grid.sync() a round, with a serial atomicExch and reseed by one thread
// between them.  The barrier lives in rumor_common.cuh, shared with K4.

#include <cuda_runtime.h>

#include <cstdint>

#include "rumor_common.cuh"

namespace {

constexpr int kThreads = 256;  // a block; a thread a word

struct FusedParams {
  const int32_t* table;   // [n_rounds, fanout + 3]: shifts, coin salt,
                          // churn salt, patient zero
  const uint32_t* alive;  // [nw]
  uint32_t* inf;          // [2, nw] ping-pong; slot 0 holds the input
  uint32_t* hot;          // [2, nw]
  unsigned* counts;       // [n_rounds], 0 on entry: round i's barrier word
  int n_rounds, fanout, nw, n;
  int coin_depth;         // 0: stop_k == 1, a sure coin
  uint32_t coin_ones;
  int churn_depth;        // 0: no churn
  uint32_t churn_ones;
};

// One round's row of the table.  F > 0: the fanout, shifts in registers;
// F == 0: any fanout, shifts after the first read from the table.
template <int F>
struct Row {
  int s[F > 0 ? F : 1];
  const int32_t* at;
  uint32_t coin_salt, churn_salt;
  int pz;
};

template <int F>
__device__ __forceinline__ Row<F> load_row(const FusedParams& p, int i) {
  const int fanout = F > 0 ? F : p.fanout;
  Row<F> r;
  r.at = p.table + static_cast<size_t>(i) * (fanout + 3);
#pragma unroll
  for (int j = 0; j < (F > 0 ? F : 1); ++j) r.s[j] = __ldg(r.at + j);
  r.coin_salt = static_cast<uint32_t>(__ldg(r.at + fanout));
  r.churn_salt = static_cast<uint32_t>(__ldg(r.at + fanout + 1));
  r.pz = __ldg(r.at + fanout + 2);
  return r;
}

// The coin (all ones when stop_k == 1) and churn words of word w.
template <int F>
__device__ __forceinline__ void masks(const FusedParams& p, int w,
                                      const Row<F>& row, uint32_t& coin,
                                      uint32_t& reborn) {
  const uint32_t uw = static_cast<uint32_t>(w);
  coin = p.coin_depth > 0
             ? rumor_biased_word(uw, row.coin_salt, p.coin_depth, p.coin_ones)
             : 0xFFFFFFFFu;
  reborn = p.churn_depth > 0 ? rumor_biased_word(uw, row.churn_salt,
                                                 p.churn_depth, p.churn_ones)
                             : 0u;
}

// Last round's restart, applied at load: word `word` gains `bit`.
struct Reseed {
  int word;  // -1: the rumor did not die
  uint32_t bit;
};

__device__ __forceinline__ uint32_t ld_state(const uint32_t* buf, int k,
                                             Reseed rs) {
  return __ldcg(buf + k) | (k == rs.word ? rs.bit : 0u);
}

// The two source words of word w of roll_bits(x, s) on a ring of nw
// words: w - q and the one before it, q = s >> 5.
struct RollAt {
  int src, prev;
};

__device__ __forceinline__ RollAt roll_at(int w, int s, int nw) {
  int src = w - (s >> 5);
  if (src < 0) src += nw;
  return {src, src == 0 ? nw - 1 : src - 1};
}

// (x0 << r) | (x1 >> (32 - r)), and x0 when r == 0.
__device__ __forceinline__ uint32_t rolled(uint32_t x0, uint32_t x1, int s) {
  return __funnelshift_l(x1, x0, static_cast<unsigned>(s & 31));
}

// One word of one round: every load first, then the bit operations and
// the stores.  Returns the word's new hot & alive bits.
template <int F>
__device__ __forceinline__ uint32_t step_word(
    const FusedParams& p, const Row<F>& row, const uint32_t* inf,
    const uint32_t* hot, uint32_t* inf_o, uint32_t* hot_o, Reseed rs, int w,
    uint32_t a, uint32_t coin, uint32_t reborn) {
  const int nw = p.nw;
  const uint32_t f = ld_state(inf, w, rs);
  const uint32_t h = ld_state(hot, w, rs);
  const int sd = p.n - row.s[0];  // dup: roll infected by n - s0
  const RollAt d = roll_at(w, sd, nw);
  const uint32_t d0 = ld_state(inf, d.src, rs);
  const uint32_t d1 = ld_state(inf, d.prev, rs);
  uint32_t hit = 0u;
  if constexpr (F > 0) {
    uint32_t x0[F], x1[F];  // hot & alive source words of each roll
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const RollAt q = roll_at(w, row.s[j], nw);
      x0[j] = ld_state(hot, q.src, rs) & __ldg(p.alive + q.src);
      x1[j] = ld_state(hot, q.prev, rs) & __ldg(p.alive + q.prev);
    }
#pragma unroll
    for (int j = 0; j < F; ++j) hit |= rolled(x0[j], x1[j], row.s[j]);
  } else {
    for (int j = 0; j < p.fanout; ++j) {
      const int s = j == 0 ? row.s[0] : __ldg(row.at + j);
      const RollAt q = roll_at(w, s, nw);
      hit |= rolled(ld_state(hot, q.src, rs) & __ldg(p.alive + q.src),
                    ld_state(hot, q.prev, rs) & __ldg(p.alive + q.prev), s);
    }
  }
  const uint32_t new_inf = f | (hit & a);
  const uint32_t dup = rolled(d0, d1, sd) & (h & a);
  const uint32_t new_hot = (h | (new_inf & ~f)) & ~(dup & coin) & ~reborn;
  __stcg(inf_o + w, new_inf & ~reborn);
  __stcg(hot_o + w, new_hot);
  return new_hot & a;
}

// F: the fanout (0: any, read at run time; fanout 1-4 have their own
// instances, whose rolls' loads all go out together, a round's L2 latency
// less than the runtime loop's at fanout 2).  Thread t keeps word t's
// alive word and masks in registers; words past the grid's threads
// (only when n > 32 x the resident threads, about 2^22 on an H100)
// compute their masks in the round.
template <int F>
__global__ void __launch_bounds__(kThreads) rumor_fused_kernel(FusedParams p) {
  const int stride = gridDim.x * blockDim.x;
  const int w0 = blockIdx.x * blockDim.x + threadIdx.x;
  __shared__ unsigned s_count;  // round i's barrier word, as thread 0 saw it

  const uint32_t a = w0 < p.nw ? __ldg(p.alive + w0) : 0u;
  Row<F> row = load_row<F>(p, 0);
  uint32_t coin, reborn;
  masks(p, w0, row, coin, reborn);
  Reseed rs{-1, 0u};
  for (int i = 0;; ++i) {
    const bool more = i + 1 < p.n_rounds;
    // the next row travels with this round's loads
    const Row<F> next = load_row<F>(p, more ? i + 1 : i);
    const size_t in = static_cast<size_t>(i & 1) * p.nw;
    const size_t out = static_cast<size_t>((i + 1) & 1) * p.nw;
    const uint32_t* inf = p.inf + in;
    const uint32_t* hot = p.hot + in;
    uint32_t* inf_o = p.inf + out;
    uint32_t* hot_o = p.hot + out;

    uint32_t seen = 0u;
    if (w0 < p.nw)
      seen = step_word(p, row, inf, hot, inf_o, hot_o, rs, w0, a, coin,
                       reborn);
    for (int w = w0 + stride; w < p.nw; w += stride) {
      uint32_t c, r;
      masks(p, w, row, c, r);
      seen |= step_word(p, row, inf, hot, inf_o, hot_o, rs, w,
                        __ldg(p.alive + w), c, r);
    }
    const int any = __syncthreads_or(seen != 0u);
    if (threadIdx.x == 0)
      rumor_arrive(p.counts + i, 1u + (any ? kRumorHotBlock : 0u));
    if (!more) break;
    // between arrive and wait: round i + 1's masks, which read no state
    masks(p, w0, next, coin, reborn);
    rumor_pin(coin);
    rumor_pin(reborn);
    if (threadIdx.x == 0)
      s_count = rumor_wait_all(p.counts + i, gridDim.x);
    __syncthreads();
    rs = (s_count >> 16) == 0u ? Reseed{row.pz >> 5, 1u << (row.pz & 31)}
                               : Reseed{-1, 0u};
    row = next;
  }
  // the last round's restart goes straight into the output
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      (rumor_wait_all(p.counts + p.n_rounds - 1, gridDim.x) >> 16) == 0u) {
    const size_t out = static_cast<size_t>(p.n_rounds & 1) * p.nw;
    const int k = row.pz >> 5;
    const uint32_t bit = 1u << (row.pz & 31);
    __stcg(p.inf + out + k, __ldcg(p.inf + out + k) | bit);
    __stcg(p.hot + out + k, __ldcg(p.hot + out + k) | bit);
  }
}

// The barrier alone, on the same grid: n_rounds of arrive and wait.  A
// measurement probe (the share of a K3 round that is the barrier).
__global__ void __launch_bounds__(kThreads) barrier_probe_kernel(
    unsigned* counts, int n_rounds) {
  rumor_barrier_rounds(counts, n_rounds);
}

void* kernel_for(int fanout) {
  switch (fanout) {
    case 1: return reinterpret_cast<void*>(rumor_fused_kernel<1>);
    case 2: return reinterpret_cast<void*>(rumor_fused_kernel<2>);
    case 3: return reinterpret_cast<void*>(rumor_fused_kernel<3>);
    case 4: return reinterpret_cast<void*>(rumor_fused_kernel<4>);
    default: return reinterpret_cast<void*>(rumor_fused_kernel<0>);
  }
}

// A thread a word, in blocks of kThreads, capped at the blocks the card
// holds at once (128 blocks at 2^20).
cudaError_t grid_blocks(void* kernel, int nw, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  const int need = (nw + kThreads - 1) / kThreads;
  *blocks = need < per_sm * sms ? need : per_sm * sms;
  return e;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers; `counts` holds n_rounds zeroed int32; `stream` is a
// cudaStream_t.
extern "C" int rumor_fused_run(const int32_t* table, int n_rounds, int fanout,
                               int n, int coin_depth, unsigned coin_ones,
                               int churn_depth, unsigned churn_ones,
                               const int32_t* alive, int32_t* inf,
                               int32_t* hot, int32_t* counts, void* stream) {
  FusedParams p;
  p.table = table;
  p.alive = reinterpret_cast<const uint32_t*>(alive);
  p.inf = reinterpret_cast<uint32_t*>(inf);
  p.hot = reinterpret_cast<uint32_t*>(hot);
  p.counts = reinterpret_cast<unsigned*>(counts);
  p.n_rounds = n_rounds;
  p.fanout = fanout;
  p.nw = n / 32;
  p.n = n;
  p.coin_depth = coin_depth;
  p.coin_ones = coin_ones;
  p.churn_depth = churn_depth;
  p.churn_ones = churn_ones;

  void* kernel = kernel_for(fanout);
  int blocks = 0;
  cudaError_t e = grid_blocks(kernel, p.nw, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The barrier probe on the grid rumor_fused_run takes for (n, fanout);
// `counts` holds n_rounds zeroed int32.
extern "C" int rumor_barrier_run(int n_rounds, int n, int fanout,
                                 int32_t* counts, void* stream) {
  int blocks = 0;
  cudaError_t e = grid_blocks(kernel_for(fanout), n / 32, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* c = reinterpret_cast<unsigned*>(counts);
  void* args[] = {&c, &n_rounds};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_probe_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
