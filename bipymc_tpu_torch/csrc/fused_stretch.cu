// Kernel B9: G Goodman-Weare stretch generations of an ensemble of walkers
// in one launch.
//
// Replaces bipymc_tpu/ops/fused_stretch.py::fused_stretch_pallas (:125,
// the pallas_call at :165, body _make_kernel at :60). Plain version:
// bipymc_tpu_torch/ops/fused_stretch.py::fused_stretch_plain, whose math
// this follows half-update by half-update (emcee's red-black scheme): for
// each walker i of the active half and its partner j in the other half,
// x* = x_j + z (x_i - x_j) as one fused multiply-add (torch.addcmul's
// rounding, so x* is the plain version's bit for bit), the target through
// its kernel form (target.cuh), log_alpha = min(0, ((d - 1) log z + lp*) -
// lp) in separate roundings, as torch's three operations round it, -inf
// where lp* is not finite, accept where log u < log_alpha. Rows < n/2 update first, against
// the other half as it stood at the start of the generation; rows >= n/2
// then update against the first half's new positions. Comparisons keep
// IEEE NaN semantics (a NaN log_alpha compares false), so this file must
// not be built with --use_fast_math.
//
// What bounds it on the H100: bytes, on paper. At the stretch workload
// (G = 64, n = 256, d = 16, correlated Gaussian) it moves x_hist 1.05 MB,
// the per-walker (j, z, log u) 0.2 MB and logp and the accept bits 0.08
// MB: ~1.3 MB, 0.0004 ms at 3.35 TB/s; the ~600 flops a walker-generation
// take 0.00015 ms at 67 TFLOP/s. In practice the 2G dependent
// half-updates bound it: each waits for the one before.
//
// The design. The dependence runs through the whole population, so one
// block carries it and __syncthreads separates the half-updates (a grid of
// blocks would need a grid barrier, ~1-2 us each, 128 a launch). Within the
// block, an aligned group of L lanes (L = the power of two >= d, at most
// 32) takes one walker at a time and evaluates its target with
// target.cuh::eval_target_group, so the block works on up to 1024 / L
// walkers at once. The population is not held in shared memory: at the
// API's cap, 1024 walkers in d = 100 take 400 KB, past the 227 KB a block
// may use. Instead every generation writes each row of x_hist and
// logp_hist exactly once (an active row its new value, the other half's
// after its own update), and the next half-update reads them back from
// there through L1 and L2: __syncthreads makes a block's global writes
// visible to the whole block. So the output is the state, and nothing is
// copied. Each generation first stages its n (j, z, log u) in shared
// memory, so a walker's partner index is one shared load away. The
// partner gather is a direct index; the TPU kernel's one-hot MXU product
// and its lane padding to 128 are TPU mechanics and are not carried over.

#include <cuda_runtime.h>

#include <cmath>

#include "target.cuh"

namespace {

using bipymc::min0;

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) fused_stretch_kernel(
    const float* x0, const float* logp0, const int* __restrict__ jidx,
    const float* __restrict__ z, const float* __restrict__ log_u, int G,
    int n, int d, int L, int kind, const float* __restrict__ c0,
    const float* __restrict__ c1, int n_modes, float f0, float f1,
    float* x_hist, float* logp_hist, unsigned char* __restrict__ accepted) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int half = n / 2;
  const int n_groups = nt / L;
  const int group = tid / L;
  const int gl = tid & (L - 1);
  const unsigned mask = bipymc::group_mask(L);

  // shared layout: the target's constants, then z, log u, j ([n] each),
  // then each group's y and r ([d] each, the group's stride padded by one
  // so neighbouring groups' r[j] fall in different banks)
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  float* s_c = smem;
  float* s_z = s_c + n_const;
  float* s_lu = s_z + n;
  int* s_j = reinterpret_cast<int*>(s_lu + n);
  float* s_y = reinterpret_cast<float*>(s_j + n) + group * (2 * d + 1);
  float* s_r = s_y + d;
  const bipymc::Target tg =
      bipymc::load_target(kind, c0, c1, n_modes, f0, f1, d, s_c);
  const float dm1 = static_cast<float>(d - 1);

  for (int g = 0; g < G; ++g) {
    const long long base = static_cast<long long>(g) * n;
    for (int k = tid; k < n; k += nt) {
      s_j[k] = jidx[base + k];
      s_z[k] = z[base + k];
      s_lu[k] = log_u[base + k];
    }
    __syncthreads();     // also publishes load_target's constants at g = 0
    const float* xp = g == 0 ? x0 : x_hist + (base - n) * d;
    const float* lpp = g == 0 ? logp0 : logp_hist + (base - n);
    float* xo = x_hist + base * d;
    float* lpo = logp_hist + base;
    for (int phase = 0; phase < 2; ++phase) {
      const int lo = phase * half;
      // phase 0's partners (rows >= half) have not moved this generation;
      // phase 1's (rows < half) were just written to xo
      const float* xpart = phase == 0 ? xp : xo;
      for (int w = group; w < half; w += n_groups) {
        const int i = lo + w;
        const float* xi = xp + static_cast<long long>(i) * d;
        const float* xj = xpart + static_cast<long long>(s_j[i]) * d;
        const float zz = s_z[i];
        for (int k = gl; k < d; k += L)
          s_y[k] = __fmaf_rn(zz, __fsub_rn(xi[k], xj[k]), xj[k]);
        __syncwarp(mask);
        const float lps = bipymc::eval_target_group(tg, s_y, s_r, d, L, mask);
        const float lp = lpp[i];
        const float la =
            isfinite(lps)
                ? min0(__fsub_rn(__fadd_rn(__fmul_rn(dm1, logf(zz)), lps), lp))
                : -INFINITY;
        const bool acc = s_lu[i] < la;
        float* xoi = xo + static_cast<long long>(i) * d;
        for (int k = gl; k < d; k += L) xoi[k] = acc ? s_y[k] : xi[k];
        if (gl == 0) {
          lpo[i] = acc ? lps : lp;
          accepted[base + i] = acc ? 1 : 0;
        }
        __syncwarp(mask);      // the group's y and r are free again
      }
      __syncthreads();         // this half's rows are visible to the block
    }
  }
}

}  // namespace

// x0 [n, d], logp0 [n], z and log_u [G, n] float32, j [G, n] int32 (each
// row's partner row, in the other half), contiguous; n even. kind 0:
// c0 = mean [d], c1 = inv [d, d], f0 = log_det, f1 = d log 2pi; kind 1:
// c0 = means [n_modes, d], c1 = log_w [n_modes], f0 = norm, f1 = sigma^2.
// Outputs: x_hist [G, n, d], logp_hist [G, n], accepted [G, n] bytes.
// The block: L lanes a walker (the power of two >= d, at most 32) and
// enough threads for a half's walkers at once, a multiple of 32, at most
// kThreads. Returns the launch's cudaError_t (0 on success), or -1,
// launching nothing, where the target's constants and the groups' scratch
// need more shared memory than a block may take.
extern "C" int fused_stretch_launch(const void* x0, const void* logp0,
                                    const void* j, const void* z,
                                    const void* log_u, int G, int n, int d,
                                    int kind, const void* c0, const void* c1,
                                    int n_modes, float f0, float f1,
                                    void* x_hist, void* logp_hist,
                                    void* accepted, void* stream) {
  if (n == 0 || G == 0) return 0;
  int L = 1;
  while (L < d && L < 32) L *= 2;
  int threads = L * (n / 2);
  if (threads > kThreads) threads = kThreads;
  threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
  const int n_const = bipymc::target_consts(kind, d, n_modes);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_const) + 3 * n +
                       static_cast<size_t>(threads / L) * (2 * d + 1));
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(max_smem)) return -1;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_stretch_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_stretch_kernel<<<1, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(logp0),
      static_cast<const int*>(j), static_cast<const float*>(z),
      static_cast<const float*>(log_u), G, n, d, L, kind,
      static_cast<const float*>(c0), static_cast<const float*>(c1), n_modes,
      f0, f1, static_cast<float*>(x_hist), static_cast<float*>(logp_hist),
      static_cast<unsigned char*>(accepted));
  return static_cast<int>(cudaGetLastError());
}
