// Kernel B2: the DREAM-zs proposal for every chain of one generation.
//
// Replaces bipymc_tpu/ops/dream_proposal.py::dream_propose_pallas (the
// pallas_call at :155). Plain version: bipymc_tpu_torch/ops/
// dream_proposal.py::propose_block, whose math this follows: the masked
// sum over delta DE pairs, the crossover mask u < cr plus the FIRST lane
// holding the minimum u (dream_propose.cuh::min_first), gamma = 2.38 *
// rsqrt(2 * delta * d_eff) (1 on jump generations), x + mask * ((1 + e) *
// gamma * diff + b* * eps), and the snooker projection with its log
// Jacobian, with the 1e-30 clamps. Kernel B1 (fused_chunk.cu) forms the
// same proposal inside its generations.
//
// What bounds it on the H100: the launch. At the main path's 256 chains x
// d = 100 with k = 6 archive rows it moves 1.1 MB (about 0.34 us of HBM
// time) and does ~40 flops an element; a launch costs ~1 us whatever it
// does. So the design keeps one chain's work to one round of loads and
// two of shuffles:
// - An aligned group of L lanes a chain, several chains a 128-thread
//   block, each lane owning the coordinate quads gl, gl + L, ... (L the
//   power of two >= the d / 4 quads, at most 32: config 3's d = 100 takes
//   a warp a chain, 4 a block; config 5's d = 2 a lane a chain, 128 a
//   block). A lane owns quads, not single coordinates, so that its loads
//   are 16 bytes wide where d % 4 == 0 and a row's address and stride
//   allow (each operand's own flag; the per-generation step's u_mask and
//   u_e rows lie at an odd stride and go a float at a time).
// - Every input element read from device memory once: a lane loads all
//   of its quads of x, the archive rows, u_mask, u_e and eps up front,
//   into registers (kKeep quads a lane: d <= 384), forming the DE
//   difference sum as the rows arrive (with the samplers' 3 pairs a
//   compile-time count, so every row is a register). Past 384 a lane
//   loops over its quads twice, reading them again (any d: 1, 129, 300
//   and 500 included).
// - The sums over d are a lane's partials, then a butterfly of shuffles
//   within the group: no shared memory and no block barrier. The
//   butterfly's adds commute, so every lane of the group holds the same
//   totals bit for bit. A chain's group reduces only what its own move
//   needs: min u with its first lane and the mask count (parallel), or
//   |x - z|^2 and the snooker dot product, then the numerator (snooker).
//   A warp of one chain (config 3) takes that branch whole; where a
//   warp's chains differ, each group's shuffles name its own lanes. The
//   TPU kernel's (8, 128) tiling, lane padding and the 2.0 pad of u are
//   not carried over: the loop bound masks the ragged edge.
// The sums run in another order than the plain version's, so the two
// agree to float32 re-association (x_star rtol 1e-5 / atol 1e-6,
// log_jac rtol 1e-5 / atol 1e-4).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "block_reduce.cuh"
#include "dream_propose.cuh"

namespace {

using bipymc::min_first;

constexpr int kThreads = 128;   // a block
constexpr int kKeep = 3;        // quads a lane keeps: d <= 32 x 4 x kKeep
constexpr int kRows = 6;        // archive rows loaded at once (n_pairs <= 3)
// the operands read (or written) 16 bytes at a time, a bit each
constexpr int kVecX = 1, kVecRows = 2, kVecUm = 4, kVecUe = 8, kVecEps = 16,
              kVecOut = 32;

struct Args {
  const float* __restrict__ x;
  long long ld_x;
  const float* __restrict__ rows;     // [n, k, d]
  int k;
  const float* __restrict__ um;
  long long ld_um;
  const float* __restrict__ ue;
  long long ld_ue;
  const float* __restrict__ ep;
  long long ld_ep;
  const float* __restrict__ scal;     // [n, 5]
  int n, d, n_pairs, L, vec;
  float jac_coef, b, b_star;
  float* __restrict__ x_star;
  float* __restrict__ log_jac;
};

// quad q (coordinates 4q .. 4q + 3) of a row: one 16-byte load where vec,
// else the coordinates below d one at a time (zeros past d)
__device__ __forceinline__ float4 load4(const float* p, int q, int d,
                                        bool vec) {
  if (vec) return reinterpret_cast<const float4*>(p)[q];
  const int j = 4 * q;
  return make_float4(p[j], j + 1 < d ? p[j + 1] : 0.f,
                     j + 2 < d ? p[j + 2] : 0.f, j + 3 < d ? p[j + 3] : 0.f);
}

__device__ __forceinline__ float& at(float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// a lane's inputs at one quad: x, z = archive row 0, the DE difference
// sum and the three draws
struct Quad {
  float4 x, z, diff, um, ue, ep;
};

// The butterfly within the group of L lanes (mask its lanes): every lane
// ends with the group's totals, the same bits in each.
__device__ __forceinline__ float group_sum(float v, int L, unsigned mask) {
  for (int off = L >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// One chain's proposal by its group of a.L lanes (gl this lane's index).
// kKeepAll: every quad of the lane fits kKeep, read once and kept; else
// read again for the outputs. kNP: the DE pairs, known at compile time
// (the samplers' default, 3), or 0: a.n_pairs.
template <bool kKeepAll, int kNP>
__device__ __forceinline__ void propose(const Args& a, long long i, int gl,
                                        unsigned mask) {
  const int d = a.d, L = a.L;
  const int nq = (d + 3) / 4;
  const int np = kNP ? kNP : a.n_pairs;
  const float* xi = a.x + i * a.ld_x;
  const float* ri = a.rows + i * a.k * static_cast<long long>(d);
  const float* umi = a.um + i * a.ld_um;
  const float* uei = a.ue + i * a.ld_ue;
  const float* epi = a.ep + i * a.ld_ep;
  const float* sc = a.scal + i * 5;
  const float delta = sc[0], cr = sc[1], gamma_s = sc[2];
  const bool snk = sc[3] > 0.5f, jump = sc[4] > 0.5f;
  const int n_read = 2 * np > 3 ? 2 * np : 3;

  // quad q's inputs; the partials of the first four sums where `part`
  auto load = [&](int q, bool part, float& umin, int& ul, float& cnt,
                  float& den, float& dot) {
    Quad Q;
    const bool vr = a.vec & kVecRows;
    Q.x = load4(xi, q, d, a.vec & kVecX);
    Q.um = load4(umi, q, d, a.vec & kVecUm);
    Q.ue = load4(uei, q, d, a.vec & kVecUe);
    Q.ep = load4(epi, q, d, a.vec & kVecEps);
    // the rows the chain reads (0, 1, 2 the snooker's z, z1, z2; the
    // pairs' 2 n_pairs), all loads issued at once for up to kRows of them;
    // row(p) picks one without indexing the array at run time
    float4 rw[kRows];
#pragma unroll
    for (int p = 0; p < kRows; ++p)
      rw[p] = p < n_read ? load4(ri + static_cast<long long>(p) * d, q, d, vr)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    auto row = [&](int p) {
      float4 v = p < kRows
                     ? rw[0]
                     : load4(ri + static_cast<long long>(p) * d, q, d, vr);
#pragma unroll
      for (int m = 1; m < kRows; ++m)
        if (p == m) v = rw[m];
      return v;
    };
    Q.z = rw[0];
    Q.diff = make_float4(0.f, 0.f, 0.f, 0.f);
    // with kNP the loop unrolls and row() picks each row at compile time
#pragma unroll
    for (int p = 0; p < np; ++p) {
      const float w = (static_cast<float>(p) < delta) ? 1.f : 0.f;
      const float4 r1 = row(p), r2 = row(np + p);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        at(Q.diff, e) += w * (get(r1, e) - get(r2, e));
    }
    if (part) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        if (j < d) {
          const float u = get(Q.um, e);
          min_first(umin, ul, u, j);
          cnt += (u < cr) ? 1.f : 0.f;
          const float u_dir = get(Q.x, e) - get(Q.z, e);
          den += u_dir * u_dir;
          dot += (get(rw[1], e) - get(rw[2], e)) * u_dir;
        }
      }
    }
    return Q;
  };

  // ---- the loads and the first four sums' partials ---------------------
  float umin = INFINITY, cnt = 0.f, den = 0.f, dot = 0.f;
  int ul = INT_MAX;
  Quad keep[kKeepAll ? kKeep : 1];
  const int T = kKeepAll ? kKeep : (nq + L - 1) / L;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int q = gl + L * t;
    if (q < nq) {
      const Quad Q = load(q, true, umin, ul, cnt, den, dot);
      if constexpr (kKeepAll) keep[t] = Q;
    }
  }
  auto quad = [&](int t, int q) {
    if constexpr (kKeepAll) {
      return keep[t];
    } else {                   // past kKeep quads a lane: read them again
      float u0 = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
      int l0 = 0;
      return load(q, false, u0, l0, s0, s1, s2);
    }
  };
  float* xo = a.x_star + i * static_cast<long long>(d);
  auto store = [&](int q, float4 out) {
    if (a.vec & kVecOut) {
      reinterpret_cast<float4*>(xo)[q] = out;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < d) xo[4 * q + e] = get(out, e);
    }
  };

  // ---- the chain's own move: its sums by the group's butterfly, which
  // a warp of one chain (L = 32) takes without diverging ------------------
  if (snk) {
    for (int off = L >> 1; off > 0; off >>= 1) {
      den += __shfl_xor_sync(mask, den, off);
      dot += __shfl_xor_sync(mask, dot, off);
    }
    const float denom = fmaxf(den, 1e-30f);
    const float snk_coef = gamma_s * (dot / denom);
    float num = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = gl + L * t;
      if (q >= nq) continue;
      const Quad Q = quad(t, q);
      float4 out;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xv = get(Q.x, e), z = get(Q.z, e);
        const float xs = xv + snk_coef * (xv - z);
        const float dz = xs - z;
        if (4 * q + e < d) num += dz * dz;
        at(out, e) = xs;
      }
      store(q, out);
    }
    num = group_sum(num, L, mask);
    if (gl == 0)
      a.log_jac[i] = a.jac_coef * (logf(fmaxf(num, 1e-30f)) - logf(denom));
  } else {
    for (int off = L >> 1; off > 0; off >>= 1) {
      const float u2 = __shfl_xor_sync(mask, umin, off);
      const int l2 = __shfl_xor_sync(mask, ul, off);
      min_first(umin, ul, u2, l2);
      cnt += __shfl_xor_sync(mask, cnt, off);
    }
    // the first-min lane is in the mask whether or not u < cr there
    const float d_eff = cnt + ((umin < cr) ? 0.f : 1.f);
    const float gamma = jump ? 1.f : 2.38f * rsqrtf(2.f * delta * d_eff);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = gl + L * t;
      if (q >= nq) continue;
      const Quad Q = quad(t, q);
      float4 out;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        const float m = (get(Q.um, e) < cr || j == ul) ? 1.f : 0.f;
        const float ee = a.b * (2.f * get(Q.ue, e) - 1.f);
        at(out, e) = get(Q.x, e) + m * ((1.f + ee) * gamma * get(Q.diff, e) +
                                        a.b_star * get(Q.ep, e));
      }
      store(q, out);
    }
    if (gl == 0) a.log_jac[i] = 0.f;
  }
}

template <bool kKeepAll, int kNP>
__global__ void __launch_bounds__(kThreads) dream_propose_kernel(Args a) {
  const int L = a.L;
  const int group = threadIdx.x / L;
  const int gl = threadIdx.x & (L - 1);
  const long long i =
      static_cast<long long>(blockIdx.x) * (kThreads / L) + group;
  if (i >= a.n) return;                   // the whole group leaves
  const unsigned lane = threadIdx.x & 31;
  const unsigned mask =
      L == 32 ? bipymc::kFull
              : ((1u << L) - 1u) << (lane & ~static_cast<unsigned>(L - 1));
  propose<kKeepAll, kNP>(a, i, gl, mask);
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
  const int nq = (d + 3) / 4;
  int L = 1;
  while (L < nq && L < 32) L *= 2;
  // 16-byte accesses where every quad of the operand's rows is aligned
  auto vec_ok = [d](const void* p, long long ld) {
    return d % 4 == 0 && ld % 4 == 0 &&
           reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const int vec = (vec_ok(x, ld_x) ? kVecX : 0) |
                  (vec_ok(rows, d) ? kVecRows : 0) |
                  (vec_ok(u_mask, ld_um) ? kVecUm : 0) |
                  (vec_ok(u_e, ld_ue) ? kVecUe : 0) |
                  (vec_ok(eps, ld_eps) ? kVecEps : 0) |
                  (vec_ok(x_star, d) ? kVecOut : 0);
  Args a{static_cast<const float*>(x), ld_x, static_cast<const float*>(rows),
         k, static_cast<const float*>(u_mask), ld_um,
         static_cast<const float*>(u_e), ld_ue,
         static_cast<const float*>(eps), ld_eps,
         static_cast<const float*>(scal), n, d, n_pairs, L, vec, jac_coef, b,
         b_star, static_cast<float*>(x_star), static_cast<float*>(log_jac)};
  const int per_block = kThreads / L;
  const int blocks = (n + per_block - 1) / per_block;
  const bool keep = nq <= L * kKeep;
  auto kernel = n_pairs == 3 ? (keep ? dream_propose_kernel<true, 3>
                                     : dream_propose_kernel<false, 3>)
                             : (keep ? dream_propose_kernel<true, 0>
                                     : dream_propose_kernel<false, 0>);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
