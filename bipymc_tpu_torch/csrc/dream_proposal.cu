// Kernel B2: the DREAM-zs proposal for every chain of one generation.
//
// Replaces bipymc_tpu/ops/dream_proposal.py::dream_propose_pallas (the
// pallas_call at :155). Plain version: bipymc_tpu_torch/ops/
// dream_proposal.py::propose_block. The per-chain math is
// dream_propose.cuh::propose_chain, which kernel B1 (fused_chunk.cu)
// runs too, so the two engines share one copy of it.
//
// What bounds it on the H100: the launch. At the main path's 256 chains x
// d = 100 with k = 6 archive rows it moves 1.1 MB (about 0.34 us of HBM
// time) and does ~40 flops per element. The design: one block per chain,
// 128 threads striding over d (so any d works, d = 1 and d = 129
// included), each input element read from HBM once per pass, and the
// reductions over d done by warp shuffles plus one small shared-memory
// pass. The TPU kernel's (8, 128) tiling, lane padding and the 2.0 pad of
// u are not carried over: the loop bound masks the ragged edge.

#include <cuda_runtime.h>

#include "dream_propose.cuh"

namespace {

constexpr int kThreads = bipymc::kMaxThreads;

__global__ void __launch_bounds__(kThreads) dream_propose_kernel(
    const float* __restrict__ x, long long ld_x,
    const float* __restrict__ rows, int k,
    const float* __restrict__ u_mask, long long ld_um,
    const float* __restrict__ u_e, long long ld_ue,
    const float* __restrict__ eps, long long ld_eps,
    const float* __restrict__ scal, int d, int n_pairs, float jac_coef,
    float b, float b_star, float* __restrict__ x_star,
    float* __restrict__ log_jac) {
  __shared__ bipymc::ProposeScratch scratch;
  const long long i = blockIdx.x;
  const float* sc = scal + i * 5;
  const float lj = bipymc::propose_chain<kThreads>(
      x + i * ld_x, rows + i * k * static_cast<long long>(d),
      u_mask + i * ld_um, u_e + i * ld_ue, eps + i * ld_eps, sc[0], sc[1],
      sc[2], sc[3] > 0.5f, sc[4] > 0.5f, d, n_pairs, jac_coef, b, b_star,
      x_star + i * static_cast<long long>(d), scratch);
  if (threadIdx.x == 0) log_jac[i] = lj;
}

}  // namespace

// x, u_mask, u_e, eps: [n, d] float32 with row strides ld_* (in floats),
// unit stride along d; rows: [n, k, d] contiguous; scal: [n, 5] contiguous
// (delta, cr, gamma_s, is_snooker, gamma_jump); x_star: [n, d] and
// log_jac: [n], contiguous. jac_coef = (d_true - 1) / 2.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dream_propose_launch(
    const void* x, long long ld_x, const void* rows, int k,
    const void* u_mask, long long ld_um, const void* u_e, long long ld_ue,
    const void* eps, long long ld_eps, const void* scal, int n, int d,
    int n_pairs, float jac_coef, float b, float b_star, void* x_star,
    void* log_jac, void* stream) {
  if (n == 0) return 0;
  dream_propose_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ld_x, static_cast<const float*>(rows), k,
      static_cast<const float*>(u_mask), ld_um,
      static_cast<const float*>(u_e), ld_ue, static_cast<const float*>(eps),
      ld_eps, static_cast<const float*>(scal), d, n_pairs, jac_coef, b,
      b_star, static_cast<float*>(x_star), static_cast<float*>(log_jac));
  return static_cast<int>(cudaGetLastError());
}
