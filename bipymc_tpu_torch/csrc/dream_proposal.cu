// Kernel B2: the DREAM-zs proposal for every chain of one generation.
//
// Replaces bipymc_tpu/ops/dream_proposal.py::dream_propose_pallas (the
// pallas_call at :155). Plain version: bipymc_tpu_torch/ops/
// dream_proposal.py::propose_block, whose math this follows: the masked
// sum over delta DE pairs, the crossover mask u < cr plus the FIRST lane
// holding the minimum u, gamma = 2.38 * rsqrt(2 * delta * d_eff) (1 on
// jump generations), x + mask * ((1 + e) * gamma * diff + b* * eps), and
// the snooker projection with its log Jacobian, with the 1e-30 clamps.
//
// What bounds it on the H100: the launch. At the main path's 256 chains x
// d = 100 with k = 6 archive rows it moves 1.1 MB (about 0.34 us of HBM
// time) and does ~40 flops per element. The design: one block per chain,
// 128 threads striding over d (so any d works, d = 1 and d = 129
// included), each input element read from HBM once per pass, and the
// four reductions over d (min u with its first lane, the mask count,
// |x - z|^2 and the snooker dot product) done in one warp-shuffle pass
// plus one small shared-memory pass. The TPU kernel's (8, 128) tiling,
// lane padding and the 2.0 pad of u are not carried over: the loop bound
// masks the ragged edge. The snooker flag is uniform over a block, so the
// third reduction, |x_snk - z|^2, runs only in snooker blocks.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (u, lane) lexicographic min: the smaller u, and on a tie the first lane
__device__ __forceinline__ void min_first(float& u, int& lane, float u2,
                                          int lane2) {
  if (u2 < u || (u2 == u && lane2 < lane)) {
    u = u2;
    lane = lane2;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) dream_propose_kernel(
    const float* __restrict__ x, long long ld_x,
    const float* __restrict__ rows, int k,
    const float* __restrict__ u_mask, long long ld_um,
    const float* __restrict__ u_e, long long ld_ue,
    const float* __restrict__ eps, long long ld_eps,
    const float* __restrict__ scal, int d, int n_pairs, float jac_coef,
    float b, float b_star, float* __restrict__ x_star,
    float* __restrict__ log_jac) {
  __shared__ float s_umin[kWarps];
  __shared__ int s_lane[kWarps];
  __shared__ float s_cnt[kWarps];
  __shared__ float s_den[kWarps];
  __shared__ float s_dot[kWarps];
  __shared__ float s_num[kWarps];

  const long long i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xi = x + i * ld_x;
  const float* ri = rows + i * k * static_cast<long long>(d);
  const float* um = u_mask + i * ld_um;
  const float* ue = u_e + i * ld_ue;
  const float* ep = eps + i * ld_eps;
  const float delta = scal[i * 5 + 0];
  const float cr = scal[i * 5 + 1];
  const float gamma_s = scal[i * 5 + 2];
  const bool snk = scal[i * 5 + 3] > 0.5f;
  const bool jump = scal[i * 5 + 4] > 0.5f;

  // ---- pass 1: min u (first lane), mask count, |x - z|^2, snooker dot --
  float umin = INFINITY;
  int umin_lane = INT_MAX;
  float cnt = 0.f, den = 0.f, dot = 0.f;
  for (int j = tid; j < d; j += kThreads) {
    const float u = um[j];
    min_first(umin, umin_lane, u, j);
    cnt += (u < cr) ? 1.f : 0.f;
    const float u_dir = xi[j] - ri[j];
    den += u_dir * u_dir;
    dot += (ri[d + j] - ri[2 * d + j]) * u_dir;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float u2 = __shfl_xor_sync(kFull, umin, off);
    const int l2 = __shfl_xor_sync(kFull, umin_lane, off);
    min_first(umin, umin_lane, u2, l2);
  }
  cnt = warp_sum(cnt);
  den = warp_sum(den);
  dot = warp_sum(dot);
  if (lane == 0) {
    s_umin[warp] = umin;
    s_lane[warp] = umin_lane;
    s_cnt[warp] = cnt;
    s_den[warp] = den;
    s_dot[warp] = dot;
  }
  __syncthreads();
  // every thread combines the warp partials in the same order, so the
  // block agrees on each value bit for bit
  umin = s_umin[0];
  umin_lane = s_lane[0];
  cnt = s_cnt[0];
  den = s_den[0];
  dot = s_dot[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    min_first(umin, umin_lane, s_umin[w], s_lane[w]);
    cnt += s_cnt[w];
    den += s_den[w];
    dot += s_dot[w];
  }

  // the first-min lane is in the mask whether or not u < cr there
  const float d_eff = cnt + ((umin < cr) ? 0.f : 1.f);
  const float gamma = jump ? 1.f : 2.38f * rsqrtf(2.f * delta * d_eff);
  const float denom = fmaxf(den, 1e-30f);
  const float snk_coef = gamma_s * (dot / denom);

  // ---- pass 2: the chosen move, written once ----------------------------
  float* xo = x_star + i * static_cast<long long>(d);
  float num = 0.f;
  for (int j = tid; j < d; j += kThreads) {
    const float xv = xi[j];
    if (snk) {
      const float z = ri[j];
      const float xs = xv + snk_coef * (xv - z);
      const float dz = xs - z;
      num += dz * dz;
      xo[j] = xs;
    } else {
      float diff = 0.f;
      for (int p = 0; p < n_pairs; ++p) {
        const float w = (static_cast<float>(p) < delta) ? 1.f : 0.f;
        diff += w * (ri[p * d + j] - ri[(n_pairs + p) * d + j]);
      }
      const float m = (um[j] < cr || j == umin_lane) ? 1.f : 0.f;
      const float e = b * (2.f * ue[j] - 1.f);
      xo[j] = xv + m * ((1.f + e) * gamma * diff + b_star * ep[j]);
    }
  }

  if (!snk) {
    if (tid == 0) log_jac[i] = 0.f;
    return;
  }
  num = warp_sum(num);
  if (lane == 0) s_num[warp] = num;
  __syncthreads();
  if (tid == 0) {
    float total = s_num[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += s_num[w];
    log_jac[i] = jac_coef * (logf(fmaxf(total, 1e-30f)) - logf(denom));
  }
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
