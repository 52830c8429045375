// The DREAM-zs proposal for one chain, computed by one block; shared by
// kernels B2 (dream_proposal.cu, one generation) and B1 (fused_chunk.cu,
// G generations per launch).
//
// Plain version: bipymc_tpu_torch/ops/dream_proposal.py::propose_block,
// whose math this follows: the masked sum over delta DE pairs, the
// crossover mask u < cr plus the FIRST lane holding the minimum u,
// gamma = 2.38 * rsqrt(2 * delta * d_eff) (1 on jump generations),
// x + mask * ((1 + e) * gamma * diff + b* * eps), and the snooker
// projection with its log Jacobian, with the 1e-30 clamps.
//
// Threads stride over d, each input element is read from global memory
// once per pass, and the four reductions over d (min u with its first
// lane, the mask count, |x - z|^2 and the snooker dot product) are one
// warp-shuffle pass plus one small shared-memory pass. The snooker flag
// is uniform over a block, so the third reduction, |x_snk - z|^2, runs
// only in snooker blocks.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "block_reduce.cuh"

namespace bipymc {

struct ProposeScratch {
  float umin[kMaxWarps];
  int lane[kMaxWarps];
  float cnt[kMaxWarps];
  float den[kMaxWarps];
  float dot[kMaxWarps];
  float num[kMaxWarps];
};

// (u, lane) lexicographic min: the smaller u, and on a tie the first lane
__device__ __forceinline__ void min_first(float& u, int& lane, float u2,
                                          int lane2) {
  if (u2 < u || (u2 == u && lane2 < lane)) {
    u = u2;
    lane = lane2;
  }
}

// One chain's proposal. xi, rows ri ([k, d], row p at ri + p * d), um,
// ue, ep: the chain's inputs, [d] each; xo: [d] output (global or
// shared, not aliasing xi). Returns the log Jacobian, the same in every
// thread (0 for a parallel move). The block has kNt threads, a multiple
// of 32 and at most kMaxThreads; a compile-time count keeps the strides
// and the warp loops as B2 had them.
template <int kNt>
__device__ inline float propose_chain(
    const float* xi, const float* ri, const float* um, const float* ue,
    const float* ep, float delta, float cr, float gamma_s, bool snk,
    bool jump, int d, int n_pairs, float jac_coef, float b, float b_star,
    float* xo, ProposeScratch& s) {
  static_assert(kNt % 32 == 0 && kNt <= kMaxThreads, "block size");
  constexpr int nt = kNt;
  constexpr int n_warps = kNt / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // ---- pass 1: min u (first lane), mask count, |x - z|^2, snooker dot --
  float umin = INFINITY;
  int umin_lane = INT_MAX;
  float cnt = 0.f, den = 0.f, dot = 0.f;
  for (int j = tid; j < d; j += nt) {
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
    s.umin[warp] = umin;
    s.lane[warp] = umin_lane;
    s.cnt[warp] = cnt;
    s.den[warp] = den;
    s.dot[warp] = dot;
  }
  __syncthreads();
  // every thread combines the warp partials in the same order, so the
  // block agrees on each value bit for bit
  umin = s.umin[0];
  umin_lane = s.lane[0];
  cnt = s.cnt[0];
  den = s.den[0];
  dot = s.dot[0];
#pragma unroll
  for (int w = 1; w < n_warps; ++w) {
    min_first(umin, umin_lane, s.umin[w], s.lane[w]);
    cnt += s.cnt[w];
    den += s.den[w];
    dot += s.dot[w];
  }

  // the first-min lane is in the mask whether or not u < cr there
  const float d_eff = cnt + ((umin < cr) ? 0.f : 1.f);
  const float gamma = jump ? 1.f : 2.38f * rsqrtf(2.f * delta * d_eff);
  const float denom = fmaxf(den, 1e-30f);
  const float snk_coef = gamma_s * (dot / denom);

  // ---- pass 2: the chosen move, written once ----------------------------
  float num = 0.f;
  for (int j = tid; j < d; j += nt) {
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
  if (!snk) return 0.f;

  num = warp_sum(num);
  if (lane == 0) s.num[warp] = num;
  __syncthreads();
  float total = s.num[0];
#pragma unroll
  for (int w = 1; w < n_warps; ++w) total += s.num[w];
  return jac_coef * (logf(fmaxf(total, 1e-30f)) - logf(denom));
}

}  // namespace bipymc
