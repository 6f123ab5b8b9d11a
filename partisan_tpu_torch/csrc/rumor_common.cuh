// Shared device helpers of the two rumor kernels (rumor_fused.cu, K3, and
// rumor_hbm.cu, K4): the package's mix32 finalizer and the packed
// Bernoulli word, the same arithmetic as partisan_tpu_torch/ops/bitset.py
// (mix32, bernoulli_expand, biased_words), and the split-phase grid
// barrier both kernels take once a round.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t rumor_mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Word `word` of the salted packed Bernoulli(p) mask: the bit-serial
// "u < p" walk over p's binary expansion to depth `depth`, where bit d-1
// of `ones` is p's bit at depth d, fed by
// mix32(word * 2654435761 ^ salt ^ d * 0x9E3779B9).
// kWarpExit: the warp leaves the walk once no bit of its 32 words still
// ties p's prefix (eq == 0 everywhere), which is exact: the levels left
// cannot change `out`.  Every lane of the warp must take the call.
template <bool kWarpExit = false>
__device__ __forceinline__ uint32_t rumor_biased_word(uint32_t word,
                                                      uint32_t salt,
                                                      int depth,
                                                      uint32_t ones) {
  const uint32_t iota = word * 2654435761u;
  uint32_t eq = 0xFFFFFFFFu, out = 0u;
  for (int d = 1; d <= depth; ++d) {
    const uint32_t u =
        rumor_mix32(iota ^ salt ^ (static_cast<uint32_t>(d) * 0x9E3779B9u));
    if ((ones >> (d - 1)) & 1u) {
      out |= eq & ~u;
      eq &= u;
    } else {
      eq &= ~u;
    }
    if constexpr (kWarpExit) {
      if (!__any_sync(0xFFFFFFFFu, eq != 0u)) break;
    }
  }
  return out;
}

// The grid barrier, one word a round (counts[i], zeroed by the caller).
// The low half counts the blocks in, the high half the blocks that still
// hold a hot & alive word.
constexpr unsigned kRumorHotBlock = 1u << 16;

// Thread 0 of a block, after a __syncthreads that follows the block's
// stores: adds v with a release, so those stores are seen by any thread
// whose acquire load reads the sum.
__device__ __forceinline__ void rumor_arrive(unsigned* word, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(word), "r"(v) : "memory");
}

// Spin until all `blocks` blocks have arrived; returns the word.
__device__ __forceinline__ unsigned rumor_wait_all(const unsigned* word,
                                                   unsigned blocks) {
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(word) : "memory");
  } while ((v & (kRumorHotBlock - 1u)) < blocks);
  return v;
}

// Keeps a value's computation before this point (before the wait).
__device__ __forceinline__ void rumor_pin(uint32_t& x) {
  asm volatile("" : "+r"(x));
}

// The barrier alone: n_rounds of arrive and wait by the whole grid.  The
// body of each kernel's probe (the share of its round that is the
// barrier), launched on that kernel's grid.
__device__ __forceinline__ void rumor_barrier_rounds(unsigned* counts,
                                                     int n_rounds) {
  for (int i = 0; i < n_rounds; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      rumor_arrive(counts + i, 1u);
      rumor_wait_all(counts + i, gridDim.x);
    }
    __syncthreads();
  }
}

// Bit-roll read: word `w` of roll_bits(x, s) for a ring of `nw` words,
// with s = 32 * q + r already split (0 <= q < nw, 0 <= r < 32).
// `load(i)` returns word i of x.
template <typename Load>
__device__ __forceinline__ uint32_t rumor_rolled_word(Load load, int w,
                                                      int q, int r, int nw) {
  int src = w - q;
  if (src < 0) src += nw;
  const uint32_t xw = load(src);
  if (r == 0) return xw;
  const int prev = src == 0 ? nw - 1 : src - 1;
  return (xw << r) | (load(prev) >> (32 - r));
}
