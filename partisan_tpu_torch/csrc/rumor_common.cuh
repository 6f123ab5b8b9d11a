// Shared device helpers of the two rumor kernels (rumor_fused.cu, K3, and
// rumor_hbm.cu, K4): the package's mix32 finalizer and the packed
// Bernoulli word, the same arithmetic as partisan_tpu_torch/ops/bitset.py
// (mix32, bernoulli_expand, biased_words).
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
  }
  return out;
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
