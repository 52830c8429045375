// The full warp mask and the NaN-keeping min(0, v) shared by the port's
// per-chain kernels (B1, B2, B4, B9 and B10).

#pragma once

#include <cuda_runtime.h>

namespace bipymc {

constexpr unsigned kFull = 0xffffffffu;

// min(0, v) that propagates NaN, as torch.clamp_max and jnp.minimum do
// (fminf(0, NaN) is 0)
template <typename T>
__device__ __forceinline__ T min0(T v) { return v >= T(0) ? T(0) : v; }

}  // namespace bipymc
