// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1,
// 2, 3", SC 2011; the Random123 constants) for the attention-dropout keep
// mask.  Included by every flash kernel through flash_mma.cuh (whose
// keep_bits / keep_bits_kv make the calls), so the forward and every
// backward form regenerate one mask.  The plain PyTorch twin is
// ops/flash_attention.py::philox4x32 / attn_keep_mask.
//
// Keep mask of one attention call: key = (seed low word, seed high word),
// counter = (key index j, query index i / 4, head, batch row), output word
// i % 4; an element is kept iff that word >= the threshold
// min(floor(rate * 2^32), 2^32 - 1).  One call gives all 4 words of a
// key column for 4 consecutive query rows starting at a multiple of 4.

#pragma once

#include <stdint.h>

namespace flash {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint2 philox_key(const unsigned long long* seed) {
  const unsigned long long s = *seed;
  return make_uint2((uint32_t)s, (uint32_t)(s >> 32));
}

}  // namespace flash
