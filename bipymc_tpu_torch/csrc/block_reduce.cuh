// Warp sums and the NaN-keeping min(0, v) shared by the port's per-chain
// kernels: B2 (dream_propose.cuh) reduces over d with warp_sum and one
// shared-memory pass, every thread combining the warp partials in the
// same order so that the whole block agrees on each total bit for bit;
// B1, B4 and B10 take min0 and the full mask from here.

#pragma once

#include <cuda_runtime.h>

namespace bipymc {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// min(0, v) that propagates NaN, as torch.clamp_max and jnp.minimum do
// (fminf(0, NaN) is 0)
template <typename T>
__device__ __forceinline__ T min0(T v) { return v >= T(0) ? T(0) : v; }

}  // namespace bipymc
