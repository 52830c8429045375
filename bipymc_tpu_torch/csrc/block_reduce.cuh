// Block-wide float sums shared by the port's per-chain kernels (B1, B2,
// B4): one block works on one chain and reduces over d with warp
// shuffles plus one shared-memory pass. Every thread combines the warp
// partials in the same order, so the whole block agrees on each total
// bit for bit, which keeps accept decisions uniform over the block.

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

// Sum v[0..m) over the block; every thread gets the same totals.
// scratch holds kMaxWarps * NV floats.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], int m,
                                          float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    if (a < m) {
      const float s = warp_sum(v[a]);
      if (lane == 0) scratch[warp * NV + a] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    if (a < m) {
      float s = scratch[a];
      for (int w = 1; w < n_warps; ++w) s += scratch[w * NV + a];
      v[a] = s;
    }
  }
  __syncthreads();          // scratch is free again
}

// min(0, v) that propagates NaN, as torch.clamp_max and jnp.minimum do
// (fminf(0, NaN) is 0)
template <typename T>
__device__ __forceinline__ T min0(T v) { return v >= T(0) ? T(0) : v; }

}  // namespace bipymc
