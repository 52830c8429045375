// The built-in targets in device code, shared by kernels B1
// (fused_chunk.cu), B4 (fused_rw_chunk.cu) and B9 (fused_stretch.cu).
//
// A CUDA kernel cannot inline an arbitrary user function as Pallas
// inlines a jaxpr, so the kernels take the built-in targets' kernel forms
// (models/targets.py::KernelForm):
//   0 correlated Gaussian: -0.5 * ((q + log_det) + d log 2pi) with
//     q = sum_i (sum_j r_j inv[j, i]) r_i, r = y - mean;
//   1 isotropic Gaussian mixture: per-mode squared distances, then
//     torch.logsumexp's max-shifted sum of (log_w + norm) - 0.5 sq / s^2.
// The Python wrappers raise for any other target. Each kernel keeps its
// own layouts and sums: B9 (fused_stretch.cu::eval_group) an aligned
// group of lanes a point, the Gaussian's inverse transposed; B4
// (fused_rw_chunk.cu) and B1 (fused_chunk.cu) a warp a chain. B4 and B9
// share mixture_lse; B1 forms the same sum over a fixed count of modes,
// where the modes past k add exact zeros.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "block_reduce.cuh"

namespace bipymc {

constexpr int kMaxModes = 16;

struct Target {
  int kind;                 // 0 correlated Gaussian, 1 Gaussian mixture
  const float* c;           // inv [d, d] | means [k, d], where kept
  const float* mu;          // mean [d] (kind 0), where kept
  const float* log_w;       // [k] (kind 1)
  int k;                    // modes (kind 1)
  float f0, f1;             // log_det, d log 2pi | norm, sigma^2
};

// The mixture's log density from its per-mode squared distances:
// torch.logsumexp's max-shifted sum of (log_w + norm) - 0.5 sq / s^2.
__device__ inline float mixture_lse(const Target& tg,
                                    float (&sq)[kMaxModes]) {
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m) {
    if (m < tg.k) {
      sq[m] = (tg.log_w[m] + tg.f0) - (0.5f * sq[m]) / tg.f1;
      mx = fmaxf(mx, sq[m]);
    }
  }
  const float shift = isinf(mx) ? 0.f : mx;   // torch.logsumexp's rule
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m)
    if (m < tg.k) s += expf(sq[m] - shift);
  return logf(s) + shift;
}

}  // namespace bipymc
