// The built-in targets in device code, shared by kernels B1
// (fused_chunk.cu), B4 (fused_rw_chunk.cu) and B9 (fused_stretch.cu).
//
// A CUDA kernel cannot inline an arbitrary user function as Pallas
// inlines a jaxpr, so the kernels take the built-in targets' kernel forms
// (models/targets.py::KernelForm):
//   0 correlated Gaussian: -0.5 * ((q + log_det) + d log 2pi) with
//     q = sum_i (sum_j r_j inv[j, i]) r_i, r = y - mean, inv in shared
//     memory (40 KB at d = 100);
//   1 isotropic Gaussian mixture: per-mode squared distances, then
//     torch.logsumexp's max-shifted sum of (log_w + norm) - 0.5 sq / s^2.
// The Python wrappers raise for any other target. eval_target spends a
// whole block on one point (B1); B9 (fused_stretch.cu::eval_group) spends
// an aligned group of lanes on one point with the same sums, from
// load_target's layout but for the Gaussian's inverse, which it keeps
// transposed; B4 (fused_rw_chunk.cu) keeps its own layouts and sums and
// shares mixture_lse.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "block_reduce.cuh"

namespace bipymc {

constexpr int kMaxModes = 16;

struct Target {
  int kind;                 // 0 correlated Gaussian, 1 Gaussian mixture
  const float* c;           // shared: inv [d, d] | means [k, d]
  const float* mu;          // shared: mean [d] (kind 0)
  const float* log_w;       // global: [k] (kind 1)
  int k;                    // modes (kind 1)
  float f0, f1;             // log_det, d log 2pi | norm, sigma^2
};

// floats of the target's constants that live in shared memory
__host__ __device__ inline int target_consts(int kind, int d, int n_modes) {
  return kind == 0 ? d * d + d : n_modes * d;
}

// Copy the constants into shared s_c (target_consts floats) and describe
// them. kind 0: c0 = mean [d], c1 = inv [d, d], f0 = log_det,
// f1 = d log 2pi; kind 1: c0 = means [n_modes, d], c1 = log_w [n_modes],
// f0 = norm, f1 = sigma^2. The caller syncs the block before use.
__device__ inline Target load_target(int kind, const float* c0,
                                     const float* c1, int n_modes, float f0,
                                     float f1, int d, float* s_c) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  Target tg;
  tg.kind = kind;
  tg.c = s_c;
  tg.k = n_modes;
  tg.f0 = f0;
  tg.f1 = f1;
  if (kind == 0) {
    for (int a = tid; a < d * d; a += nt) s_c[a] = c1[a];      // inv
    for (int a = tid; a < d; a += nt) s_c[d * d + a] = c0[a];  // mean
    tg.mu = s_c + d * d;
    tg.log_w = nullptr;
  } else {
    for (int a = tid; a < n_modes * d; a += nt) s_c[a] = c0[a];  // means
    tg.mu = nullptr;
    tg.log_w = c1;
  }
  return tg;
}

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

// log density of y (shared, [d]); r is [d] shared scratch, scratch holds
// kMaxWarps * kMaxModes floats. Every thread returns the same value.
__device__ inline float eval_target(const Target& tg, const float* y,
                                    float* r, int d, float* scratch) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tg.kind == 0) {
    for (int j = tid; j < d; j += nt) r[j] = y[j] - tg.mu[j];
    __syncthreads();
    float q[1] = {0.f};
    for (int i = tid; i < d; i += nt) {
      float s = 0.f;
      for (int j = 0; j < d; ++j) s += r[j] * tg.c[j * d + i];
      q[0] += s * r[i];
    }
    block_sum<1>(q, 1, scratch);
    return -0.5f * ((q[0] + tg.f0) + tg.f1);
  }
  float sq[kMaxModes];
#pragma unroll
  for (int m = 0; m < kMaxModes; ++m) sq[m] = 0.f;
  for (int j = tid; j < d; j += nt) {
    const float yj = y[j];
#pragma unroll
    for (int m = 0; m < kMaxModes; ++m) {
      if (m < tg.k) {
        const float diff = yj - tg.c[m * d + j];
        sq[m] += diff * diff;
      }
    }
  }
  block_sum<kMaxModes>(sq, tg.k, scratch);
  return mixture_lse(tg, sq);
}

}  // namespace bipymc
