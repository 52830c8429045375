// Philox4x32-10 and splitmix64 in device code: the in-kernel random
// words of kernel B1 (fused_chunk.cu, kernel-RNG mode).
//
// Plain version: bipymc_tpu_torch/core/rng.py (philox4x32_10,
// _splitmix64, kernel_seed, kernel_draw_bits), which this follows word
// for word. Philox4x32-10 is Salmon et al., SC'11 ("Parallel random
// numbers: as easy as 1, 2, 3"), as Random123's philox4x32_R: ten
// rounds, the key bumped by the Weyl constants before every round but
// the first. Written by hand rather than taken from curand_kernel.h, so
// the plain version needs none of cuRAND's subsequence layout.

#pragma once

#include <cuda_runtime.h>

namespace bipymc {

constexpr unsigned kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
// folded into a step's seed to key the in-kernel draws (core/rng.py
// KERNEL_RNG_FOLD)
constexpr unsigned long long kKernelRngFold = 0x6B524E47ull;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// The Philox key of step t's in-kernel draws under run key `key`
// (core/rng.py kernel_seed): low half first.
__device__ __forceinline__ uint2 kernel_seed(unsigned long long key,
                                             unsigned long long t) {
  const unsigned long long s =
      splitmix64(splitmix64(key ^ splitmix64(t)) ^ kKernelRngFold);
  return make_uint2(static_cast<unsigned>(s),
                    static_cast<unsigned>(s >> 32));
}

}  // namespace bipymc
