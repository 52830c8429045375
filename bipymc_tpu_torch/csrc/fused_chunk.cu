// Kernel B1: G DREAM-zs generations for every chain in one launch.
//
// Replaces bipymc_tpu/ops/fused_chunk.py::fused_chunk_pallas (the
// pallas_call at :325, body _make_kernel at :162) in both of its modes.
// Stream mode: the crossover uniforms, the multiplicative uniforms and
// the normals come in as operands, made outside the kernel
// (samplers/dream_fused.py). Kernel-RNG mode (rng="kernel",
// _draw_kernel_randomness at :73): the kernel draws them itself, one
// Philox4x32-10 call (philox.cuh) per chain, lane and generation, keyed
// by the run key and the generation, and converts them as
// core/rng.py's bits_to_uniform and uniform_to_normal do. In both modes
// the archive rows and the per-chain scalars come in. Plain versions:
// bipymc_tpu_torch/ops/fused_chunk.py::fused_chunk_plain and
// fused_chunk_kernel_rng_plain, whose math this follows generation by
// generation: the proposal
// (dream_propose.cuh::propose_chain, the code kernel B2 runs), the
// target through its kernel form (target.cuh::eval_target, the code
// kernel B4 runs), log_alpha = min(0, (lp* - lp) + log_jac) set to -inf
// where lp* is not finite, accept where log u < log_alpha, and the
// history row. Comparisons keep IEEE NaN semantics (a NaN acceptance
// compares false), so this file must not be built with --use_fast_math.
//
// What bounds it on the H100: bytes. At config 3 (G = 10, n = 256,
// k = 6, d = 100) the operands are rows 6.1 MB, the three [G, n, d]
// draws 3.1 MB (stream mode only), x_hist 1.0 MB and the rest 0.2 MB:
// about 10.4 MB, 3.1 us at 3.35 TB/s, while the ~4,000 flops a
// chain-generation take 0.15 us at 67 TFLOP/s (Philox adds ~100 integer
// operations a lane). In practice the G dependent generations bound it:
// each is a chain of block-wide reductions (proposal, target, accept),
// and the 256 blocks fit the 132 SMs at once.
//
// The design: the TPU kernel's sequential grid axis over g becomes a loop
// inside the block. One block per chain of 128 threads striding over d,
// B2's block, so the shared proposal compiles as in B2; x, the proposal
// and the target's constants stay in shared memory and logp in a
// register across all G generations. Every reduction is
// combined in the same order by every thread, so the block agrees on
// each accept bit. In kernel-RNG mode each generation first writes its
// lanes' three converted draws to shared memory, where the proposal
// reads them as it reads the streamed rows. Philox is keyed per chain
// (counter (lane, chain, 0, 0), key from (run key, generation)), not
// per block of chains as the TPU kernel seeds its hardware generator, so
// a chain's draws do not depend on the launch's shape. The Pallas
// kernel's lane padding to 128, the 2.0 pad of u and its constant
// hoisting (hoist_target_consts and lp_block_cache,
// ops/fused_chunk.py:110-159) are TPU mechanics and are not carried over.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "dream_propose.cuh"
#include "philox.cuh"
#include "target.cuh"

namespace {

using bipymc::kMaxModes;
using bipymc::kMaxThreads;
using bipymc::kMaxWarps;

// lanes of the packed per-chain scalars [G, n, 6]
constexpr int kScal = 6;
constexpr int kDelta = 0, kCr = 1, kGammaS = 2, kSnooker = 3, kJump = 4,
              kLogU = 5;

// core/rng.py bits_to_uniform: the top 23 bits as the mantissa of a
// float in [1, 2), less 1
__device__ __forceinline__ float bits_to_uniform(unsigned w) {
  return __uint_as_float((w >> 9) | 0x3F800000u) - 1.f;
}

// core/rng.py uniform_to_normal: v = 2u - 1 clamped one float32 epsilon
// above -1, then Phi^-1((v + 1) / 2) in double, rounded once
__device__ __forceinline__ float uniform_to_normal(float u) {
  const float v = fmaxf(2.f * u - 1.f, -1.f + FLT_EPSILON);
  return static_cast<float>(normcdfinv(0.5 * static_cast<double>(v) + 0.5));
}

// The three draws of kernel-RNG mode: from Philox, or, where the test
// words tb_* are given ([G, n, d] each), from them.
struct KernelRng {
  unsigned long long key;
  long long t0;
  const unsigned* tb_m;
  const unsigned* tb_e;
  const unsigned* tb_n;
};

template <bool kKernelRng>
__global__ void __launch_bounds__(kMaxThreads) fused_chunk_kernel(
    const float* __restrict__ x0, const float* __restrict__ logp0,
    const float* __restrict__ rows, int k,
    const float* __restrict__ u_mask, long long ld_um,
    const float* __restrict__ u_e, long long ld_ue,
    const float* __restrict__ eps, long long ld_eps, KernelRng krng,
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

  // shared layout: constants, then x, the proposal y, r (each [d]), and
  // in kernel-RNG mode the generation's u_mask, u_e and eps (each [d])
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  float* s_x = smem + n_const;
  float* s_y = s_x + d;
  float* s_r = s_y + d;
  float* s_um = s_r + d;
  float* s_ue = s_um + d;
  float* s_ep = s_ue + d;
  const bipymc::Target tg =
      bipymc::load_target(kind, c0, c1, n_modes, f0, f1, d, smem);
  for (int j = tid; j < d; j += nt) s_x[j] = x0[i * d + j];
  float lp = logp0[i];
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const long long row = static_cast<long long>(g) * n + i;
    const float* sc = scal + row * kScal;
    const float *um, *ue, *ep;
    if constexpr (kKernelRng) {
      const uint2 key = bipymc::kernel_seed(
          krng.key, static_cast<unsigned long long>(krng.t0 + g));
      for (int j = tid; j < d; j += nt) {
        unsigned wm, we, wn;
        if (krng.tb_m != nullptr) {
          const long long at = row * d + j;
          wm = krng.tb_m[at];
          we = krng.tb_e[at];
          wn = krng.tb_n[at];
        } else {
          const uint4 w = bipymc::philox4x32_10(
              make_uint4(static_cast<unsigned>(j), static_cast<unsigned>(i),
                         0u, 0u),
              key);
          wm = w.x;
          we = w.y;
          wn = w.z;
        }
        s_um[j] = bits_to_uniform(wm);
        s_ue[j] = bits_to_uniform(we);
        s_ep[j] = uniform_to_normal(bits_to_uniform(wn));
      }
      __syncthreads();               // the generation's draws are whole
      um = s_um;
      ue = s_ue;
      ep = s_ep;
    } else {
      um = u_mask + row * ld_um;
      ue = u_e + row * ld_ue;
      ep = eps + row * ld_eps;
    }
    const float log_jac = bipymc::propose_chain<kMaxThreads>(
        s_x, rows + row * k * static_cast<long long>(d), um, ue, ep,
        sc[kDelta], sc[kCr], sc[kGammaS], sc[kSnooker] > 0.5f,
        sc[kJump] > 0.5f, d, n_pairs, jac_coef, b, b_star, s_y, pscratch);
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

template <bool kKernelRng>
int launch(const void* x0, const void* logp0, const void* rows, int k,
           const void* u_mask, long long ld_um, const void* u_e,
           long long ld_ue, const void* eps, long long ld_eps,
           const KernelRng& krng, const void* scal, int G, int n, int d,
           int n_pairs, float jac_coef, float b, float b_star, int kind,
           const void* c0, const void* c1, int n_modes, float f0, float f1,
           void* x_hist, void* logp_hist, void* accepted,
           cudaStream_t stream) {
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_const) +
                                       (kKernelRng ? 6 : 3) * d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_chunk_kernel<kKernelRng>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_chunk_kernel<kKernelRng><<<n, kMaxThreads, smem, stream>>>(
      static_cast<const float*>(x0), static_cast<const float*>(logp0),
      static_cast<const float*>(rows), k, static_cast<const float*>(u_mask),
      ld_um, static_cast<const float*>(u_e), ld_ue,
      static_cast<const float*>(eps), ld_eps, krng,
      static_cast<const float*>(scal), G, n, d, n_pairs, jac_coef, b, b_star,
      kind, static_cast<const float*>(c0), static_cast<const float*>(c1),
      n_modes, f0, f1, static_cast<float*>(x_hist),
      static_cast<float*>(logp_hist), static_cast<unsigned char*>(accepted));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0 [n, d], logp0 [n], rows [G, n, k, d], scal [G, n, 6] (delta, cr,
// gamma_s, is_snooker, gamma_jump, log u): float32, contiguous. Stream
// mode (kernel_rng 0): u_mask, u_e, eps: [G, n, d] float32 whose rows
// (g, i) lie at (g * n + i) * ld floats, with unit stride along d.
// Kernel-RNG mode (kernel_rng 1): u_mask, u_e and eps are not read; the
// kernel draws generation g's from Philox keyed by (key, t0 + g), or,
// where tb_m is not null, reads the words tb_m, tb_e, tb_n ([G, n, d]
// uint32 each, contiguous) instead. jac_coef = (d_true - 1) / 2. kind 0:
// c0 = mean [d], c1 = inv [d, d], f0 = log_det, f1 = d log 2pi; kind 1:
// c0 = means [n_modes, d], c1 = log_w [n_modes], f0 = norm,
// f1 = sigma^2. Outputs, contiguous: x_hist [G, n, d], logp_hist [G, n],
// accepted [G, n] bytes. Returns the launch's cudaError_t (0 on
// success).
extern "C" int fused_chunk_launch(
    const void* x0, const void* logp0, const void* rows, int k,
    const void* u_mask, long long ld_um, const void* u_e, long long ld_ue,
    const void* eps, long long ld_eps, int kernel_rng,
    unsigned long long key, long long t0, const void* tb_m, const void* tb_e,
    const void* tb_n, const void* scal, int G, int n, int d, int n_pairs,
    float jac_coef, float b, float b_star, int kind, const void* c0,
    const void* c1, int n_modes, float f0, float f1, void* x_hist,
    void* logp_hist, void* accepted, void* stream) {
  if (n == 0 || G == 0) return 0;
  const KernelRng krng{key, t0, static_cast<const unsigned*>(tb_m),
                       static_cast<const unsigned*>(tb_e),
                       static_cast<const unsigned*>(tb_n)};
  if (kernel_rng)
    return launch<true>(x0, logp0, rows, k, u_mask, ld_um, u_e, ld_ue, eps,
                        ld_eps, krng, scal, G, n, d, n_pairs, jac_coef, b,
                        b_star, kind, c0, c1, n_modes, f0, f1, x_hist,
                        logp_hist, accepted,
                        static_cast<cudaStream_t>(stream));
  return launch<false>(x0, logp0, rows, k, u_mask, ld_um, u_e, ld_ue, eps,
                       ld_eps, krng, scal, G, n, d, n_pairs, jac_coef, b,
                       b_star, kind, c0, c1, n_modes, f0, f1, x_hist,
                       logp_hist, accepted,
                       static_cast<cudaStream_t>(stream));
}
