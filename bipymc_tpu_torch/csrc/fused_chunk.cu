// Kernel B1: G DREAM-zs generations for every chain in one launch.
//
// Replaces bipymc_tpu/ops/fused_chunk.py::fused_chunk_pallas (the
// pallas_call at :325, body _make_kernel at :162), stream mode: the
// crossover uniforms, the multiplicative uniforms, the normals, the
// archive rows and the per-chain scalars are made outside the kernel
// (samplers/dream_fused.py) and handed in. Plain version:
// bipymc_tpu_torch/ops/fused_chunk.py::fused_chunk_plain, whose math this
// follows generation by generation: the proposal
// (dream_propose.cuh::propose_chain, the code kernel B2 runs), the
// target through its kernel form (target.cuh::eval_target, the code
// kernel B4 runs), log_alpha = min(0, (lp* - lp) + log_jac) set to -inf
// where lp* is not finite, accept where log u < log_alpha, and the
// history row. Comparisons keep IEEE NaN semantics (a NaN acceptance
// compares false), so this file must not be built with --use_fast_math.
//
// What bounds it on the H100: bytes. At config 3 (G = 10, n = 256,
// k = 6, d = 100) the operands are rows 6.1 MB, the three [G, n, d]
// draws 3.1 MB, x_hist 1.0 MB and the rest 0.2 MB: about 10.4 MB, 3.1 us
// at 3.35 TB/s, while the ~4,000 flops a chain-generation take 0.15 us at
// 67 TFLOP/s. In practice the G dependent generations bound it: each is
// a chain of block-wide reductions (proposal, target, accept), and
// the 256 blocks fit the 132 SMs at once.
//
// The design: the TPU kernel's sequential grid axis over g becomes a loop
// inside the block. One block per chain of 128 threads striding over d,
// B2's block, so the shared proposal compiles as in B2; x, the proposal
// and the target's constants stay in shared memory and logp in a
// register across all G generations. Every reduction is
// combined in the same order by every thread, so the block agrees on
// each accept bit. The Pallas kernel's lane padding to 128, the 2.0 pad
// of u and its constant hoisting (hoist_target_consts and lp_block_cache,
// ops/fused_chunk.py:110-159) are TPU mechanics and are not carried over.

#include <cuda_runtime.h>

#include <cmath>

#include "dream_propose.cuh"
#include "target.cuh"

namespace {

using bipymc::kMaxModes;
using bipymc::kMaxThreads;
using bipymc::kMaxWarps;

// lanes of the packed per-chain scalars [G, n, 6]
constexpr int kScal = 6;
constexpr int kDelta = 0, kCr = 1, kGammaS = 2, kSnooker = 3, kJump = 4,
              kLogU = 5;

__global__ void __launch_bounds__(kMaxThreads) fused_chunk_kernel(
    const float* __restrict__ x0, const float* __restrict__ logp0,
    const float* __restrict__ rows, int k,
    const float* __restrict__ u_mask, long long ld_um,
    const float* __restrict__ u_e, long long ld_ue,
    const float* __restrict__ eps, long long ld_eps,
    const float* __restrict__ scal, int G, int n, int d, int n_pairs,
    float jac_coef, float b, float b_star, int kind,
    const float* __restrict__ c0, const float* __restrict__ c1, int n_modes,
    float f0, float f1, float* __restrict__ x_hist,
    float* __restrict__ logp_hist, unsigned char* __restrict__ accepted) {
  extern __shared__ float smem[];
  __shared__ float scratch[kMaxWarps * kMaxModes];
  __shared__ bipymc::ProposeScratch pscratch;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long i = blockIdx.x;

  // shared layout: constants, then x, the proposal y, r (each [d])
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  float* s_x = smem + n_const;
  float* s_y = s_x + d;
  float* s_r = s_y + d;
  const bipymc::Target tg =
      bipymc::load_target(kind, c0, c1, n_modes, f0, f1, d, smem);
  for (int j = tid; j < d; j += nt) s_x[j] = x0[i * d + j];
  float lp = logp0[i];
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const long long row = static_cast<long long>(g) * n + i;
    const float* sc = scal + row * kScal;
    const float log_jac = bipymc::propose_chain<kMaxThreads>(
        s_x, rows + row * k * static_cast<long long>(d), u_mask + row * ld_um,
        u_e + row * ld_ue, eps + row * ld_eps, sc[kDelta], sc[kCr],
        sc[kGammaS], sc[kSnooker] > 0.5f, sc[kJump] > 0.5f, d, n_pairs,
        jac_coef, b, b_star, s_y, pscratch);
    __syncthreads();                 // the whole proposal is in s_y
    const float lps = bipymc::eval_target(tg, s_y, s_r, d, scratch);
    const float log_alpha =
        isfinite(lps) ? bipymc::min0((lps - lp) + log_jac) : -INFINITY;
    const bool acc = sc[kLogU] < log_alpha;
    float* xo = x_hist + row * d;
    for (int j = tid; j < d; j += nt) {
      const float v = acc ? s_y[j] : s_x[j];
      s_x[j] = v;
      xo[j] = v;
    }
    if (acc) lp = lps;
    if (tid == 0) {
      logp_hist[row] = lp;
      accepted[row] = acc ? 1 : 0;
    }
    __syncthreads();                 // s_x is whole for the next proposal
  }
}

}  // namespace

// x0 [n, d], logp0 [n], rows [G, n, k, d], scal [G, n, 6] (delta, cr,
// gamma_s, is_snooker, gamma_jump, log u): float32, contiguous. u_mask,
// u_e, eps: [G, n, d] float32 whose rows (g, i) lie at (g * n + i) * ld
// floats, with unit stride along d. jac_coef = (d_true - 1) / 2. kind 0:
// c0 = mean [d], c1 = inv [d, d], f0 = log_det, f1 = d log 2pi; kind 1:
// c0 = means [n_modes, d], c1 = log_w [n_modes], f0 = norm,
// f1 = sigma^2. Outputs, contiguous: x_hist [G, n, d], logp_hist [G, n],
// accepted [G, n] bytes. Returns the launch's cudaError_t (0 on
// success).
extern "C" int fused_chunk_launch(
    const void* x0, const void* logp0, const void* rows, int k,
    const void* u_mask, long long ld_um, const void* u_e, long long ld_ue,
    const void* eps, long long ld_eps, const void* scal, int G, int n, int d,
    int n_pairs, float jac_coef, float b, float b_star, int kind,
    const void* c0, const void* c1, int n_modes, float f0, float f1,
    void* x_hist, void* logp_hist, void* accepted, void* stream) {
  if (n == 0 || G == 0) return 0;
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_const) + 3 * d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_chunk_kernel<<<n, kMaxThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(logp0),
      static_cast<const float*>(rows), k, static_cast<const float*>(u_mask),
      ld_um, static_cast<const float*>(u_e), ld_ue,
      static_cast<const float*>(eps), ld_eps,
      static_cast<const float*>(scal), G, n, d, n_pairs, jac_coef, b, b_star,
      kind, static_cast<const float*>(c0), static_cast<const float*>(c1),
      n_modes, f0, f1, static_cast<float*>(x_hist),
      static_cast<float*>(logp_hist), static_cast<unsigned char*>(accepted));
  return static_cast<int>(cudaGetLastError());
}
