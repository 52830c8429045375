// Kernel B4: K random-walk (MH / DR) steps for every chain in one launch.
//
// Replaces bipymc_tpu/ops/fused_rw_chunk.py::fused_rw_chunk_pallas (the
// pallas_call at :216, body _make_kernel at :59). Plain version:
// bipymc_tpu_torch/ops/fused_rw_chunk.py::fused_rw_chunk_plain, whose
// math this follows step for step: y1 = theta + dy1[k], the target,
// log_a1 = min(0, l1 - lp) set to -inf where l1 is not finite, and with
// `delayed` the Green-Mira second stage on y2 = theta + dy2[k] with
// log1mexp (core/numerics.py: the same series and branch point -0.2, no
// expm1), its log_a2 sanitised the same way; then the select and the
// history row. Comparisons keep IEEE NaN semantics (a NaN acceptance
// compares false), so this file must not be built with --use_fast_math.
//
// The target is evaluated in device code through its kernel form
// (target.cuh, shared with kernel B1); the wrapper raises for any other
// target.
//
// What bounds it on the H100: at the wide shape (K = 50, n = 256,
// d = 100, DR, correlated Gaussian) it moves 3 K n d 4 B = 15.4 MB
// (4.6 us at 3.35 TB/s) and does ~2 (2 d^2 + 3 d) K n = 0.52 GFLOP
// (7.7 us at 67 TFLOP/s): operations bound it. At config 1 (K = 50,
// n = 1, d = 2) both bounds are nanoseconds; the 50-step serial chain of
// dependent target evaluations and the one launch bound it.
//
// The design: the TPU's sequential grid axis over k becomes a loop inside
// the block. One block per chain, 32 to 128 threads striding over d;
// theta, the proposals and the target's constants stay in shared memory
// and logp in a register across all K steps. Each reduction over d is a
// warp shuffle plus one shared-memory pass that every thread combines in
// the same order, so the block agrees on every acceptance bit for bit.
// The second stage is skipped when stage 1 accepted (it cannot change the
// result). The Pallas kernel's lane padding to 128, its (1, k) constant
// lifting and steps_per_cell are TPU mechanics and are not carried over.

#include <cuda_runtime.h>

#include <cmath>

#include "target.cuh"

namespace {

using bipymc::kMaxModes;
using bipymc::kMaxThreads;
using bipymc::kMaxWarps;
using bipymc::min0;

// p(x) = (e^x - 1)/x - 1 series coefficients, 1/(k+1)!, as core/numerics.py
__constant__ float kExpm1Coefs[10] = {
    static_cast<float>(1.0 / 2.0),       static_cast<float>(1.0 / 6.0),
    static_cast<float>(1.0 / 24.0),      static_cast<float>(1.0 / 120.0),
    static_cast<float>(1.0 / 720.0),     static_cast<float>(1.0 / 5040.0),
    static_cast<float>(1.0 / 40320.0),   static_cast<float>(1.0 / 362880.0),
    static_cast<float>(1.0 / 3628800.0), static_cast<float>(1.0 / 39916800.0)};

__device__ __forceinline__ float log1mexp(float log_a) {
  const float x = log_a >= -1e-30f ? -1e-30f : log_a;   // NaN stays NaN
  if (x > -0.2f) {
    float p = 0.f;
#pragma unroll
    for (int c = 9; c >= 0; --c) p = x * (kExpm1Coefs[c] + p);
    return logf(-x) + log1pf(p);
  }
  return log1pf(-expf(x));
}

__global__ void __launch_bounds__(kMaxThreads) fused_rw_chunk_kernel(
    const float* __restrict__ x0, const float* __restrict__ logp0,
    const float* __restrict__ dy1, const float* __restrict__ dy2,
    const float* __restrict__ scal, int K, int n, int d, bool delayed,
    int kind, const float* __restrict__ c0, const float* __restrict__ c1,
    int n_modes, float f0, float f1, float* __restrict__ x_hist,
    float* __restrict__ logp_hist, unsigned char* __restrict__ accepted,
    int* __restrict__ stage) {
  extern __shared__ float smem[];
  __shared__ float scratch[kMaxWarps * kMaxModes];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long i = blockIdx.x;

  // shared layout: constants, then theta, y1, y2, r (each [d])
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  float* s_c = smem;
  float* s_x = smem + n_const;
  float* s_y1 = s_x + d;
  float* s_y2 = s_y1 + d;
  float* s_r = s_y2 + d;
  const bipymc::Target tg =
      bipymc::load_target(kind, c0, c1, n_modes, f0, f1, d, s_c);
  for (int j = tid; j < d; j += nt) s_x[j] = x0[i * d + j];
  float lp = logp0[i];
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const long long row = static_cast<long long>(k) * n + i;
    const float* dy1r = dy1 + row * d;
    const float* sc = scal + row * 4;
    for (int j = tid; j < d; j += nt) s_y1[j] = s_x[j] + dy1r[j];
    __syncthreads();
    const float l1 = bipymc::eval_target(tg, s_y1, s_r, d, scratch);
    const float log_a1 = isfinite(l1) ? min0(l1 - lp) : -INFINITY;
    const bool acc1 = sc[2] < log_a1;
    bool acc2 = false;
    float l2 = 0.f;
    if (delayed && !acc1) {
      const float* dy2r = dy2 + row * d;
      for (int j = tid; j < d; j += nt) s_y2[j] = s_x[j] + dy2r[j];
      __syncthreads();
      l2 = bipymc::eval_target(tg, s_y2, s_r, d, scratch);
      const float log_a1_rev = min0(l1 - l2);
      const float lq_diff = -0.5f * (sc[1] - sc[0]);
      const float log_num = l2 + log1mexp(log_a1_rev);
      const float log_den = lp + log1mexp(log_a1);
      const float log_a2 =
          isfinite(l2) ? min0(log_num + lq_diff - log_den) : -INFINITY;
      acc2 = sc[3] < log_a2;
    }
    float* xo = x_hist + row * d;
    for (int j = tid; j < d; j += nt) {
      const float v = acc1 ? s_y1[j] : (acc2 ? s_y2[j] : s_x[j]);
      s_x[j] = v;
      xo[j] = v;
    }
    lp = acc1 ? l1 : (acc2 ? l2 : lp);
    if (tid == 0) {
      logp_hist[row] = lp;
      accepted[row] = (acc1 || acc2) ? 1 : 0;
      stage[row] = acc1 ? 1 : (acc2 ? 2 : 0);
    }
    // each thread reads back only its own s_x[j] in the next step's
    // proposal; the target's reads of s_y1 / s_y2 all precede its
    // block_sum barrier, so no further barrier is needed here
  }
}

}  // namespace

// x0 [n, d], logp0 [n], dy1 / dy2 [K, n, d] (dy2 may be null when not
// delayed), scal [K, n, 4] (|z1|^2, |z1 - z2/sqrt(kappa)|^2, log u1,
// log u2): float32, contiguous. kind 0: c0 = mean [d], c1 = inv [d, d],
// f0 = log_det, f1 = d log 2pi; kind 1: c0 = means [n_modes, d],
// c1 = log_w [n_modes], f0 = norm, f1 = sigma^2. Outputs: x_hist
// [K, n, d], logp_hist [K, n], accepted [K, n] bytes, stage [K, n] int32.
// threads: a multiple of 32, at most 128. Returns the launch's
// cudaError_t (0 on success).
extern "C" int fused_rw_chunk_launch(
    const void* x0, const void* logp0, const void* dy1, const void* dy2,
    const void* scal, int K, int n, int d, int delayed, int kind,
    const void* c0, const void* c1, int n_modes, float f0, float f1,
    int threads, void* x_hist, void* logp_hist, void* accepted, void* stage,
    void* stream) {
  if (n == 0 || K == 0) return 0;
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_const) + 4 * d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_rw_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_rw_chunk_kernel<<<n, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(logp0),
      static_cast<const float*>(dy1), static_cast<const float*>(dy2),
      static_cast<const float*>(scal), K, n, d, delayed != 0, kind,
      static_cast<const float*>(c0), static_cast<const float*>(c1), n_modes,
      f0, f1, static_cast<float*>(x_hist), static_cast<float*>(logp_hist),
      static_cast<unsigned char*>(accepted), static_cast<int*>(stage));
  return static_cast<int>(cudaGetLastError());
}
