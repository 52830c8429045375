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
// its kernel form (models/targets.py::KernelForm, the forms of
// target.cuh), log_alpha = min(0, ((d - 1) log z + lp*) - lp) in separate
// roundings, as torch's three operations round it, -inf where lp* is not
// finite, accept where log u < log_alpha. Rows < n/2 update first, against
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
// half-updates bound it: each waits for the one before, so the design
// shortens one half-update's dependent chain. For the Gaussian at large d
// the d^2 multiply-adds a walker-generation bound it, on the one SM that
// carries the population: at n = 256, G = 64, d = 240 they are 0.94 G,
// ~3.7 ms at that SM's 128 a cycle and 1.98 GHz.
//
// The design. The dependence runs through the whole population, so one
// block carries it and __syncthreads separates the half-updates (a grid of
// blocks would need a grid barrier, ~1-2 us each, 128 a launch).
// - One round a half-update: an aligned group of L lanes takes one walker
//   (L the power of two >= d, at most 32, halved until L x n/2 <= 1024),
//   and the half's walkers all run at once. The group evaluates the
//   target with eval_group; x* is recomputed where it is needed (the
//   target, the write-back) rather than kept, so a walker's only scratch
//   is the Gaussian's residual r [d].
// - The Gaussian's inverse covariance sits in shared memory transposed,
//   each row padded to ldc floats (a multiple of 4, 4 mod 8: eight lanes'
//   16-byte reads of eight rows fall in eight bank quads; at least 16, for
//   the register instance), so a lane reads its column and r four floats
//   at a time; the sums keep their order and roundings (one fmaf a term, j
//   ascending).
// - The register instance (Plan::reg: the Gaussian at d <= 16 and n <=
//   256, the stretch workload's case). One block on one SM issues every
//   walker's work, so a half-update costs what its warps issue, and
//   clock stamps showed eval_group's shared-memory reads of inv and r
//   taking most of it. Here each lane keeps its 4 columns of inv in
//   registers for the whole launch (zero past d), reads r four floats at
//   a time and each once, and L = 4 lanes take a walker: half the warps of
//   L = 8, so half the issue for the per-walker work every lane repeats.
//   eval_reg's sums are eval_group's at L = 4, term by term.
// - Generation g + 1's (j, z, log u) are copied into the second of two
//   shared buffers with cp.async while generation g runs, so no load of
//   them sits on the dependent chain; 16 bytes a copy where n % 4 == 0.
// - The population, two routes. Shared route: where the population fits
//   shared memory, x [n, ld] and logp [n] live there for the whole launch,
//   and a half-update updates its active rows in place (safe: an active
//   walker reads only its own row and rows of the other half). x_hist,
//   logp_hist and accepted are written and never read back, 16 bytes a
//   lane where d % 4 == 0. The row stride ld is d rounded up to an odd
//   multiple of L, so the 32 / L walkers a warp serves start in different
//   bank groups. Global route: where it does not (at the API's cap, 1,024
//   walkers in d = 100 take 400 KB of the 227 KB a block may use), every
//   generation writes each row of x_hist and logp_hist exactly once and
//   the next half-update reads them back from there through L1 and L2
//   (the kernel's first design): __syncthreads makes a block's global
//   writes visible to the block. Where the groups' residuals do not all
//   fit, fewer groups run, each taking walkers in turn.
// - The constants, two places. In shared memory (as above) where they fit
//   beside the words' buffers and one group's residual: every shape the
//   kernel took before this choice. Else in device memory (the Gaussian
//   from d = 237 at 256 walkers, the 16-mode mixture from d ~ 3,250): the
//   mean and the mixture's means read from there through L1, and the
//   Gaussian's inverse streamed by the block's threads through a ring of
//   two shared slots with cp.async (Ring), a tile of 64 rows x 4L
//   columns at a time, stored transposed as the shared constants are.
//   The block already waits at each half-update's barrier and every group
//   evaluates the same inverse, so the block's groups share each tile:
//   one __syncthreads a tile, after which the next tile's copies fly while
//   the groups read this one (eval_ring). A lane owns the columns eval_group
//   gives it (i = gl, gl + L, ...) and sums each s_i over j ascending, one
//   fmaf a term, so its q is eval_group's; the Gaussian takes any d whose
//   groups' residuals r [ldc] fit (one group at d ~ 40,000), the mixture
//   any d.
// Every route runs the same per-walker code with the same L, so where two
// can run their outputs are equal bit for bit. fused_stretch_plan
// (fused_stretch_plan.cuh) is the one place that chooses the population's
// route and the constants' place and sizes the shared memory; the Python
// mirror (ops/fused_stretch.py::plan) is held to it on the CPU and on the
// card.
//
// On the H100 (chip_smoke.py phase 2f; PERF.md's kernel table): 0.131 ms a
// launch at the stretch workload, 1.0 us a half-update, against 0.47 for
// the first design (the global route at every size, two walkers a group in
// turn). Timed in turns, each step of this design was faster than the one
// before: one round with inv read from shared memory, then inv in
// registers at L = 8, then at L = 4 (L = 2 was slower), then the 16-byte
// write-back and copies.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fused_stretch_plan.cuh"
#include "target.cuh"

namespace {

using bipymc::min0;
using namespace b9plan;   // the routes, the plan and its constants

// how a group evaluates its walker's target
constexpr int kEvalGroup = 0;   // eval_group: constants in shared memory,
                                // or the mixture's means in device memory
constexpr int kEvalReg = 1;     // eval_reg (Plan::reg)
constexpr int kEvalRing = 2;    // eval_ring: the Gaussian, inv streamed
constexpr int kRegE = kRegD / kRegL;

// The lanes of the aligned group of L lanes (L a power of two, at most 32)
// that holds this thread.
__device__ __forceinline__ unsigned group_mask(int L) {
  if (L == 32) return bipymc::kFull;
  const unsigned lane = threadIdx.x & 31;
  return ((1u << L) - 1u) << (lane & ~static_cast<unsigned>(L - 1));
}

// Sum over the group; a butterfly of commutative adds, so every lane of
// the group gets the same total bit for bit.
__device__ __forceinline__ float group_sum(float v, int L, unsigned mask) {
  for (int off = L >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The target's constants. In shared memory (cdev false), copied into s_c:
// kind 0: c0 = mean [d], c1 = inv [d, d]; s_c holds inv transposed,
// [d, ldc] (row i = column i of inv), then the mean [ldc], zero past d.
// kind 1: c0 = means [n_modes, d] row after row, c1 = log_w [n_modes]
// (global). In device memory (cdev): the operands themselves, inv as it
// is (the ring reads it). The caller syncs the block before use.
__device__ bipymc::Target load_group_target(int kind, bool cdev,
                                            const float* c0,
                                            const float* c1, int n_modes,
                                            float f0, float f1, int d,
                                            int ldc, float* s_c) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  bipymc::Target tg;
  tg.kind = kind;
  tg.k = n_modes;
  tg.f0 = f0;
  tg.f1 = f1;
  if (cdev) {
    tg.c = kind == 0 ? c1 : c0;
    tg.mu = kind == 0 ? c0 : nullptr;
    tg.log_w = kind == 0 ? nullptr : c1;
    return tg;
  }
  tg.c = s_c;
  if (kind == 0) {
    for (int a = tid; a < d * ldc; a += nt) {
      const int i = a / ldc, j = a % ldc;
      s_c[a] = j < d ? c1[j * d + i] : 0.f;
    }
    for (int a = tid; a < ldc; a += nt) s_c[d * ldc + a] = a < d ? c0[a] : 0.f;
    tg.mu = s_c + d * ldc;
    tg.log_w = nullptr;
  } else {
    for (int a = tid; a < n_modes * d; a += nt) s_c[a] = c0[a];
    tg.mu = nullptr;
    tg.log_w = c1;
  }
  return tg;
}

// log density of y, y_at(j) its j-th coordinate, evaluated by one group
// of L lanes (gl this lane's index in it); r is the group's [ldc] shared
// scratch (kind 0). Every lane of the group returns the same value. The
// sums, term by term: kind 0 s_i =
// sum_j r_j inv[j, i] and q = sum_i s_i r_i, one fmaf a term in index
// order; kind 1 per-mode squared distances.
template <typename Y>
__device__ __forceinline__ float eval_group(const bipymc::Target& tg,
                                            Y y_at, float* r, int d,
                                            int ldc, int L, int gl,
                                            unsigned mask) {
  if (tg.kind == 0) {
    for (int j = gl; j < ldc; j += L)
      r[j] = j < d ? __fsub_rn(y_at(j), tg.mu[j]) : 0.f;
    __syncwarp(mask);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float q = 0.f;
    for (int i = gl; i < d; i += L) {
      const float4* c4 = reinterpret_cast<const float4*>(tg.c + i * ldc);
      float s = 0.f;
      // zeros past d leave s exact: fmaf(0, 0, s) == s
      for (int j = 0; j < ldc / 4; ++j) {
        const float4 rv = r4[j], cv = c4[j];
        s = fmaf(rv.x, cv.x, s);
        s = fmaf(rv.y, cv.y, s);
        s = fmaf(rv.z, cv.z, s);
        s = fmaf(rv.w, cv.w, s);
      }
      q = fmaf(s, r[i], q);
    }
    q = group_sum(q, L, mask);
    return -0.5f * ((q + tg.f0) + tg.f1);
  }
  float sq[bipymc::kMaxModes];
#pragma unroll
  for (int m = 0; m < bipymc::kMaxModes; ++m) sq[m] = 0.f;
  for (int j = gl; j < d; j += L) {
    const float yj = y_at(j);
#pragma unroll
    for (int m = 0; m < bipymc::kMaxModes; ++m) {
      if (m < tg.k) {
        const float diff = __fsub_rn(yj, tg.c[m * d + j]);
        sq[m] = fmaf(diff, diff, sq[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < bipymc::kMaxModes; ++m)
    if (m < tg.k) sq[m] = group_sum(sq[m], L, mask);
  return bipymc::mixture_lse(tg, sq);
}

// The Gaussian's log density as eval_group computes it with L = kRegL,
// bit for bit, with this lane's kRegE columns of inv in creg (zero past
// d): the same sums in the same order, the terms past d zeros.
template <typename Y>
__device__ __forceinline__ float eval_reg(const bipymc::Target& tg, Y y_at,
                                          float* r,
                                          const float (&creg)[kRegE][kRegD],
                                          int d, int gl, unsigned mask) {
  float r_own[kRegE];
#pragma unroll
  for (int t = 0; t < kRegE; ++t) {
    const int j = gl + t * kRegL;
    r_own[t] = j < d ? __fsub_rn(y_at(j), tg.mu[j]) : 0.f;
    r[j] = r_own[t];
  }
  __syncwarp(mask);
  float s[kRegE];
#pragma unroll
  for (int t = 0; t < kRegE; ++t) s[t] = 0.f;
  const float4* r4 = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int j = 0; j < kRegD; j += 4) {
    const float4 rv = r4[j / 4];
#pragma unroll
    for (int t = 0; t < kRegE; ++t) {
      s[t] = fmaf(rv.x, creg[t][j], s[t]);
      s[t] = fmaf(rv.y, creg[t][j + 1], s[t]);
      s[t] = fmaf(rv.z, creg[t][j + 2], s[t]);
      s[t] = fmaf(rv.w, creg[t][j + 3], s[t]);
    }
  }
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < kRegE; ++t) q = fmaf(s[t], r_own[t], q);
  q = group_sum(q, kRegL, mask);
  return -0.5f * ((q + tg.f0) + tg.f1);
}

// The Gaussian's inverse in device memory, streamed through kRingSlots
// shared slots at buf. A tile is kRingTJ rows (j) x ti = kRingE L columns
// (i) of inv, stored transposed, tile[ii * kRingLdt + jj] = inv[j0 + jj,
// i0 + ii], zero past d. An evaluation reads the tiles column chunk after
// column chunk, its row tiles in order, and the copies run on in that
// order from one evaluation into the next (every evaluation reads the
// same inverse). Every thread of the block takes every step, the same
// count of them, whether its group has a walker or not.
struct Ring {
  float* buf;
  const float* inv;        // [d, d], row-major
  int d, ti, shift;        // ti = 1 << shift
  int n_rj, n_tiles;       // row tiles a column chunk; tiles an evaluation
  int next;                // the tile the next copy fetches
  int use;                 // the slot the next tile read is in

  __device__ void init(float* b, const float* c, int dd, int L) {
    buf = b;
    inv = c;
    d = dd;
    ti = kRingE * L;
    shift = __ffs(ti) - 1;
    n_rj = (d + kRingTJ - 1) / kRingTJ;
    n_tiles = n_rj * ((d + ti - 1) / ti);
    next = 0;
    use = 0;
    issue(0);
  }

  // copy tile `next` into slot s: the block's threads take its elements
  // in turn, consecutive threads consecutive columns of a row of inv
  __device__ void issue(int s) {
    const int ci = next / n_rj, rj = next - ci * n_rj;
    const int i0 = ci * ti, j0 = rj * kRingTJ;
    float* dst = buf + static_cast<size_t>(s) * ti * kRingLdt;
    for (int e = threadIdx.x; e < ti * kRingTJ; e += blockDim.x) {
      const int jj = e >> shift, ii = e & (ti - 1);
      const int i = i0 + ii, j = j0 + jj;
      float* o = dst + ii * kRingLdt + jj;
      if (i < d && j < d)
        cp_async4(o, inv + static_cast<size_t>(j) * d + i);
      else
        *o = 0.f;
    }
    cp_async_commit();
    next = next + 1 == n_tiles ? 0 : next + 1;
  }

  // the next tile: wait for this thread's copies of it, then the block
  // (every copy landed, and every group done with the other slot), then
  // start the copies of the tile after it into the other slot
  __device__ const float* step() {
    cp_async_wait_all();
    __syncthreads();
    issue(use ^ 1);
    const float* t = buf + static_cast<size_t>(use) * ti * kRingLdt;
    use ^= 1;
    return t;
  }
};

// The Gaussian's log density as eval_group computes it, bit for bit, with
// inv read tile by tile from the ring: this lane's columns i = gl + L e
// of each chunk, each s_i summed over j ascending (its row tiles in
// order, four rows a read, one fmaf a term; the quad past d adds zeros,
// as eval_group's padding does), q over i ascending, then the group's
// butterfly. Every thread of the block calls it; a lane whose group has
// no walker (active false) only takes the ring's steps.
template <typename Y>
__device__ __forceinline__ float eval_ring(const bipymc::Target& tg,
                                           Ring& ring, Y y_at, float* r,
                                           int d, int ldc, int L, int gl,
                                           unsigned mask, bool active) {
  if (active)
    for (int j = gl; j < ldc; j += L)
      r[j] = j < d ? __fsub_rn(y_at(j), tg.mu[j]) : 0.f;
  float q = 0.f;
  const int n_ci = ring.n_tiles / ring.n_rj;
  for (int ci = 0; ci < n_ci; ++ci) {
    float s[kRingE];
#pragma unroll
    for (int e = 0; e < kRingE; ++e) s[e] = 0.f;
    for (int rj = 0; rj < ring.n_rj; ++rj) {
      const float* tile = ring.step();
      if (!active) continue;
      const int j0 = rj * kRingTJ;
      const int rows = d - j0 < kRingTJ ? d - j0 : kRingTJ;
      const float4* r4 = reinterpret_cast<const float4*>(r + j0);
      for (int u = 0; u < (rows + 3) / 4; ++u) {
        const float4 rv = r4[u];
#pragma unroll
        for (int e = 0; e < kRingE; ++e) {
          const float4 cv = *reinterpret_cast<const float4*>(
              tile + (gl + L * e) * kRingLdt + 4 * u);
          s[e] = fmaf(rv.x, cv.x, s[e]);
          s[e] = fmaf(rv.y, cv.y, s[e]);
          s[e] = fmaf(rv.z, cv.z, s[e]);
          s[e] = fmaf(rv.w, cv.w, s[e]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < kRingE; ++e) {
        const int i = ci * ring.ti + gl + L * e;
        if (i < d) q = fmaf(s[e], r[i], q);
      }
    }
  }
  if (active) q = group_sum(q, L, mask);
  return -0.5f * ((q + tg.f0) + tg.f1);
}

// kEval: how a group evaluates its walker (kEvalReg: at most kRegThreads)
template <int kRoute, int kEval>
__global__ void __launch_bounds__(kEval == kEvalReg ? kRegThreads : kThreads)
fused_stretch_kernel(
    const float* x0, const float* logp0, const int* __restrict__ jidx,
    const float* __restrict__ z, const float* __restrict__ log_u, int G,
    int n, int d, Plan p, int kind, const float* __restrict__ c0,
    const float* __restrict__ c1, int n_modes, float f0, float f1,
    float* x_hist, float* logp_hist, unsigned char* __restrict__ accepted) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int half = n / 2;
  const int L = p.L, ld = p.ld, ldc = p.ldc;
  const int group = tid / L;
  const int gl = tid & (L - 1);
  const unsigned mask = group_mask(L);
  const int n4 = (n + 3) / 4 * 4;

  float* s_r = smem + p.off_r + static_cast<size_t>(group) * ldc;
  // generation g's (j, z, log u): buffer g & 1, [3, n4]
  auto words = [&](int g) { return smem + p.off_buf + (g & 1) * 3 * n4; };
  float* s_x = smem + p.off_x;               // shared route: x [n, ld]
  float* s_lp = s_x + static_cast<size_t>(n) * ld;

  auto prefetch = [&](int g) {
    const long long base = static_cast<long long>(g) * n;
    float* buf = words(g);
    if (p.vec_words) {
      for (int k = 4 * tid; k < n; k += 4 * nt) {
        cp_async16(buf + k, jidx + base + k);
        cp_async16(buf + n4 + k, z + base + k);
        cp_async16(buf + 2 * n4 + k, log_u + base + k);
      }
    } else {
      for (int k = tid; k < n; k += nt) {
        cp_async4(buf + k, jidx + base + k);
        cp_async4(buf + n4 + k, z + base + k);
        cp_async4(buf + 2 * n4 + k, log_u + base + k);
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  Ring ring;
  if constexpr (kEval == kEvalRing) ring.init(smem, c1, d, L);
  const bipymc::Target tg = load_group_target(
      kind, p.consts == kConstDevice, c0, c1, n_modes, f0, f1, d, ldc, smem);
  if (kRoute == kShared) {
    for (int e = tid; e < n * d; e += nt) s_x[(e / d) * ld + e % d] = x0[e];
    for (int k = tid; k < n; k += nt) s_lp[k] = logp0[k];
  }
  cp_async_wait_all();
  __syncthreads();
  const float dm1 = static_cast<float>(d - 1);
  float creg[kRegE][kRegD];
  if constexpr (kEval == kEvalReg) {
#pragma unroll
    for (int t = 0; t < kRegE; ++t) {
      const int i = gl + t * kRegL;
#pragma unroll
      for (int j = 0; j < kRegD; ++j)
        creg[t][j] = i < d ? tg.c[i * ldc + j] : 0.f;
    }
  }

  for (int g = 0; g < G; ++g) {
    if (g + 1 < G) prefetch(g + 1);
    const int* sj = reinterpret_cast<const int*>(words(g));
    const float* sz = words(g) + n4;
    const float* slu = words(g) + 2 * n4;
    const long long base = static_cast<long long>(g) * n;
    // global route: the state as the previous generation left it
    const float* xp = g == 0 ? x0 : x_hist + (base - n) * d;
    const float* lpp = g == 0 ? logp0 : logp_hist + (base - n);
    float* xo = x_hist + base * d;
    float* lpo = logp_hist + base;
    for (int phase = 0; phase < 2; ++phase) {
      const int lo = phase * half;
      // global route: phase 0's partners (rows >= half) have not moved
      // this generation; phase 1's (rows < half) were just written to xo
      const float* xpart = phase == 0 ? xp : xo;
      // rounds of p.groups walkers. The ring needs every thread at every
      // step, so there every thread takes every round (a thread past
      // p.groups from the last group's first walker), a group with no
      // walker (active false) only taking the ring's steps; elsewhere a
      // group takes its walkers alone.
      const int w_first =
          kEval == kEvalRing && group >= p.groups ? p.groups - 1 : group;
      const int w_end = kEval == kEvalRing
                            ? (half + p.groups - 1) / p.groups * p.groups
                            : half;
      for (int w = w_first; (kEval == kEvalRing || group < p.groups) &&
                            w < w_end;
           w += p.groups) {
        const bool active =
            kEval != kEvalRing || (group < p.groups && w < half);
        const int i = lo + (active ? w : 0);
        const int jj = sj[i];
        const float zz = sz[i];
        const float* xi = kRoute == kShared
                              ? s_x + static_cast<size_t>(i) * ld
                              : xp + static_cast<long long>(i) * d;
        const float* xj = kRoute == kShared
                              ? s_x + static_cast<size_t>(jj) * ld
                              : xpart + static_cast<long long>(jj) * d;
        auto y_at = [&](int k) {
          return __fmaf_rn(zz, __fsub_rn(xi[k], xj[k]), xj[k]);
        };
        float lps;
        if constexpr (kEval == kEvalRing)
          lps = eval_ring(tg, ring, y_at, s_r, d, ldc, L, gl, mask, active);
        else if constexpr (kEval == kEvalReg)
          lps = eval_reg(tg, y_at, s_r, creg, d, gl, mask);
        else
          lps = eval_group(tg, y_at, s_r, d, ldc, L, gl, mask);
        if (kEval == kEvalRing && !active) continue;
        const float lp = kRoute == kShared ? s_lp[i] : lpp[i];
        const float la =
            isfinite(lps)
                ? min0(__fsub_rn(__fadd_rn(__fmul_rn(dm1, logf(zz)), lps), lp))
                : -INFINITY;
        const bool acc = slu[i] < la;
        float* xoi = xo + static_cast<long long>(i) * d;
        if (kRoute == kShared && p.vec_x) {
          // the same values as below, four to a lane
          for (int k = 4 * gl; k < d; k += 4 * L) {
            const float4 a = *reinterpret_cast<const float4*>(xi + k);
            const float4 b = *reinterpret_cast<const float4*>(xj + k);
            float4 v = a;
            if (acc) {
              v.x = __fmaf_rn(zz, __fsub_rn(a.x, b.x), b.x);
              v.y = __fmaf_rn(zz, __fsub_rn(a.y, b.y), b.y);
              v.z = __fmaf_rn(zz, __fsub_rn(a.z, b.z), b.z);
              v.w = __fmaf_rn(zz, __fsub_rn(a.w, b.w), b.w);
              *reinterpret_cast<float4*>(s_x + static_cast<size_t>(i) * ld +
                                         k) = v;
            }
            *reinterpret_cast<float4*>(xoi + k) = v;
          }
        } else {
          for (int k = gl; k < d; k += L) {
            const float v = acc ? y_at(k) : xi[k];
            if (kRoute == kShared && acc)
              s_x[static_cast<size_t>(i) * ld + k] = v;   // xi[k] is read
            xoi[k] = v;
          }
        }
        if (gl == 0) {
          const float lpn = acc ? lps : lp;
          if (kRoute == kShared) s_lp[i] = lpn;
          lpo[i] = lpn;
          accepted[base + i] = acc ? 1 : 0;
        }
        __syncwarp(mask);      // the group's r is free again
      }
      // generation g + 1's words (and the ring's copy in flight)
      if (phase == 1) cp_async_wait_all();
      __syncthreads();         // this half's rows are visible to the block
    }
  }
}

using KernelFn = decltype(&fused_stretch_kernel<kShared, kEvalGroup>);

template <int kRoute>
KernelFn pick(int eval) {
  return eval == kEvalReg    ? fused_stretch_kernel<kRoute, kEvalReg>
         : eval == kEvalRing ? fused_stretch_kernel<kRoute, kEvalRing>
                             : fused_stretch_kernel<kRoute, kEvalGroup>;
}

}  // namespace

// x0 [n, d], logp0 [n], z and log_u [G, n] float32, j [G, n] int32 (each
// row's partner row, in the other half), contiguous; n even, at most
// 2,048. kind 0: c0 = mean [d], c1 = inv [d, d], f0 = log_det, f1 = d log
// 2pi; kind 1: c0 = means [n_modes, d], c1 = log_w [n_modes], f0 = norm,
// f1 = sigma^2. Outputs: x_hist [G, n, d], logp_hist [G, n], accepted
// [G, n] bytes. route: -1 the shared route where the population fits,
// else the global one; 0 or 1 forces the shared or the global route.
// consts: -1 the constants in shared memory where they fit, else in
// device memory; 0 or 1 forces shared or device memory.
// plan_out (int[5]): the route taken (0 shared, 1 global), the constants'
// place (0 shared, 1 device), L, the block's threads and its shared
// bytes. Returns the launch's cudaError_t (0 on success), or -1,
// launching nothing, where the plan asked for does not fit the shared
// memory a block may take (fused_stretch_plan).
extern "C" int fused_stretch_launch(const void* x0, const void* logp0,
                                    const void* j, const void* z,
                                    const void* log_u, int G, int n, int d,
                                    int kind, const void* c0, const void* c1,
                                    int n_modes, float f0, float f1,
                                    void* x_hist, void* logp_hist,
                                    void* accepted, int route, int consts,
                                    int* plan_out, void* stream) {
  int device = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Plan p;
  if (!fused_stretch_plan(n, d, kind, n_modes, max_smem, route, consts, &p))
    return -1;
  plan_out[0] = p.route;
  plan_out[1] = p.consts;
  plan_out[2] = p.L;
  plan_out[3] = p.threads;
  plan_out[4] = static_cast<int>(p.smem);
  if (n == 0 || G == 0) return 0;
  auto aligned = [](const void* q) {
    return reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  };
  p.vec_x = p.vec_x && aligned(x_hist);
  p.vec_words = p.vec_words && aligned(j) && aligned(z) && aligned(log_u);
  const int eval = p.reg ? kEvalReg
                         : (p.consts == kConstDevice && kind == 0 ? kEvalRing
                                                                  : kEvalGroup);
  auto kernel = p.route == kShared ? pick<kShared>(eval) : pick<kGlobal>(eval);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<1, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(logp0),
      static_cast<const int*>(j), static_cast<const float*>(z),
      static_cast<const float*>(log_u), G, n, d, p, kind,
      static_cast<const float*>(c0), static_cast<const float*>(c1), n_modes,
      f0, f1, static_cast<float*>(x_hist), static_cast<float*>(logp_hist),
      static_cast<unsigned char*>(accepted));
  return static_cast<int>(cudaGetLastError());
}
