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
// history row. Each scalar operation of the acceptance is rounded on its
// own (__fadd_rn and kin), as torch rounds its ops, so no route contracts
// it differently. Comparisons keep IEEE NaN semantics (a NaN acceptance
// compares false), so this file must not be built with --use_fast_math.
//
// The target is one of the built-in kernel forms (models/targets.py::
// KernelForm): 0 the correlated Gaussian, -0.5 ((q + log_det) + d log 2pi)
// with q = sum_i s_i r_i, s_i = sum_j r_j inv[j, i], r = y - mean; 1 the
// isotropic Gaussian mixture (target.cuh::mixture_lse). The wrapper raises
// for any other target.
//
// What bounds it on the H100: at the wide shape (K = 50, n = 256, d = 100,
// DR, correlated Gaussian) it moves 3 K n d 4 B = 15.4 MB (4.6 us at 3.35
// TB/s) and does ~2 (2 d^2 + 3 d) K n = 0.52 GFLOP (7.7 us at 67 TFLOP/s):
// operations bound it. At config 1 (K = 50, n = 1, d = 2) both bounds are
// nanoseconds: the 50 dependent steps, each waiting for the last one's
// decision, and the launch bound it.
//
// The design. The TPU's sequential grid axis over k is a loop inside the
// block; x stays on chip and logp in a register across all K steps. Every
// step forms y1 = x + dy1[k] and, with `delayed`, y2 = x + dy2[k] and
// evaluates both targets in one pass, as the plain version does, so the
// second evaluation overlaps the first instead of waiting for the first
// decision; the second stage decides only where the first rejected. Three
// routes, which fused_rw_plan.cuh::rw_plan chooses in one place (the
// wrapper reads the plan through fused_rw_chunk_plan, and
// ops/fused_rw_chunk.py::plan mirrors it), run that one per-step code
// (run_steps):
// - Latency route (d <= 32, either target; config 1). One warp a chain,
//   n / 128 chains a block (1 to 8). Lane j holds coordinate j of x, y1,
//   y2, r1 and r2, and for the Gaussian column j of inv and mean_j (for
//   the mixture mean_m[j]) in registers; r reaches the other lanes by
//   shuffles, the two stages' interleaved, and every reduction is a
//   butterfly of shuffles. The chain's per-step inputs (dy1, dy2 and scal
//   rows) are copied into shared memory by cp.async before the step that
//   reads them: all K steps at the start where they fit 96 KB (config 1:
//   50 x 8 floats), else a ring kRing steps deep. No global load and no
//   __syncthreads sits inside the step loop, and the history rows are
//   stores nothing waits on.
// - Throughput route (the Gaussian, 32 < d <= 128; the wide shape). A
//   block of n / 128 chains (2 at n = 256: 128 blocks) and two threads a
//   column of inv, each holding half its rows in registers, read once a
//   block; they form s of every chain and stage of the block, two vectors
//   at a time, reading r 16 bytes at a time from shared memory (each inv
//   register feeds one FMA a vector). Warp c owns chain c: its lanes keep
//   x, y1, y2 and r in registers, write r for the others, reduce q and
//   decide. Two barriers a step (r written, s written); one buffer of each
//   serves every step, as each is written by one warp only after its own
//   last read. The step's inputs are staged as in the latency route.
// - Global route (any d the shared memory takes, either target: the
//   Gaussian above 128 up to d = 20,832, the mixture above 32 at any d,
//   and any shape forced). Only r [2 x chains x d] of what grows with d
//   lives in shared memory: x, y1, y2 and s live in a workspace the
//   wrapper allocates, and inv streams from device memory (L2 at d = 300:
//   352 KB) through a ring of kTiles tiles of kTJ rows, filled by
//   cp.async; each thread copies exactly the elements of its own column,
//   so it waits for its own copies and no barrier guards the ring, and
//   the ring runs on from one step into the next. The mixture's means are
//   read from device memory.
// One arithmetic in every route: s_i = ((a_0 + a_1) + (a_2 + a_3)) +
// ((a_4 + a_5) + (a_6 + a_7)), a_m one fmaf a term over j = m, m + 8, ...
// ascending (eight short chains, not one of length d; zero terms past d
// change nothing; the throughput route's two threads a column each take
// one bracket); lane l of the chain's warp sums q_l = fmaf(s_i, r_i, q_l)
// over i = l, l + 32, ... ascending, and the lanes' partials meet in a
// butterfly of __fadd_rn; the mixture's lane l sums fmaf(diff, diff) over
// j = l, l + 32, ... the same way. A lane with no terms holds +0, so the
// latency route's butterfly over the lowest power of two >= d lanes gives
// the full one's bits. The routes' outputs are therefore equal bit for bit
// where two can run. The Pallas kernel's lane padding to 128, its (1, k)
// constant lifting and steps_per_cell are TPU mechanics and are not
// carried over.
//
// On the H100 (chip_smoke.py phase 2b; PERF.md's kernel table): config 1
// takes ~0.043 ms a launch, ~0.83 us a step (the one-block kernel before
// these routes: 0.063 ms), the wide shape ~0.10 ms (0.164), the global
// route forced there ~0.35 ms. clock64 stamps showed where a step goes: at
// config 1 the second stage's two log1mexp (libdevice's log1pf, logf and
// expf on one dependent chain), then the two evaluations; at the wide
// shape the s loop, then the owner's reduction and the same second-stage
// chain, which every warp of the block waits for. Shuffles under a branch
// the compiler cannot prove uniform go through its slow collective path,
// so the shuffles run outside any data-dependent branch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fused_rw_plan.cuh"
#include "target.cuh"

namespace {

using bipymc::kFull;
using bipymc::kMaxModes;
using bipymc::min0;

using namespace b4plan;   // the routes, the plan and its constants

static_assert(b4plan::kModes == kMaxModes, "one mode cap");
// a chain's vectors in the block routes, each ld floats
// s half h of stage t at kS + 2 h + t (the global route uses h = 0 only)
constexpr int kX = 0, kY1 = 1, kY2 = 2, kS = 3;
constexpr int kBlockThreads = 256; // latency and throughput routes, at most

// p(x) = (e^x - 1)/x - 1 series coefficients, 1/(k+1)!, as core/numerics.py
__constant__ float kExpm1Coefs[10] = {
    static_cast<float>(1.0 / 2.0),       static_cast<float>(1.0 / 6.0),
    static_cast<float>(1.0 / 24.0),      static_cast<float>(1.0 / 120.0),
    static_cast<float>(1.0 / 720.0),     static_cast<float>(1.0 / 5040.0),
    static_cast<float>(1.0 / 40320.0),   static_cast<float>(1.0 / 362880.0),
    static_cast<float>(1.0 / 3628800.0), static_cast<float>(1.0 / 39916800.0)};

// Both branches are formed and one is selected, as torch.where does: no
// branch, so the two calls of a step overlap.
__device__ __forceinline__ float log1mexp(float log_a) {
  const float x = log_a >= -1e-30f ? -1e-30f : log_a;   // NaN stays NaN
  float p = 0.f;
#pragma unroll
  for (int c = 9; c >= 0; --c) p = __fmul_rn(x, __fadd_rn(kExpm1Coefs[c], p));
  const float series = __fadd_rn(logf(-x), log1pf(p));
  const float direct = log1pf(-expf(x));
  return x > -0.2f ? series : direct;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums u and v over the lowest `width` lanes (a power of two, at most 32),
// the lanes past them holding zeros: butterflies of __fadd_rn, their
// shuffles interleaved, so every lane gets the same totals, equal to the
// 32-lane butterfly's.
__device__ __forceinline__ void lane_sum2(float& u, float& v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float pu = __shfl_xor_sync(kFull, u, off);
    const float pv = __shfl_xor_sync(kFull, v, off);
    u = __fadd_rn(u, pu);
    v = __fadd_rn(v, pv);
  }
}

// half of s_i from four of its partial sums a_m (j = m mod 8)
__device__ __forceinline__ float join4(float a0, float a1, float a2,
                                      float a3) {
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

__device__ __forceinline__ float gauss_logp(float q, float f0, float f1) {
  return __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(q, f0), f1));
}

struct Args {
  const float* x0;
  const float* logp0;
  const float* dy1;                // [K, n, d]
  const float* dy2;                // [K, n, d] or null without `delayed`
  const float* scal;               // [K, n, 4]
  int K, n, d, delayed, n_modes;
  const float* c0;                 // mean [d] | means [n_modes, d]
  const float* c1;                 // inv [d, d] | log_w [n_modes]
  float f0, f1;                    // log_det, d log 2pi | norm, sigma^2
  float* x_hist;
  float* logp_hist;
  unsigned char* accepted;
  int* stage;
  float* work;                     // global route: [n, kVecs, ld]
};

struct StepScal {
  float sz1, sw, lu1, lu2;
};

// The chain's per-step inputs in shared memory: slot (k, chain) holds
// dy1 [d], dy2 [d], scal [4]. In a ring, lane j of the owner warp copies
// dy1 and dy2 at j, j + 32, ... (the coordinates it reads itself) and
// lanes 0-3 the scal row, read by the whole warp after __syncwarp; all K
// steps at once go 16 bytes a copy where the rows allow it (vec16).
struct Stager {
  float* base;
  const float* dy1;
  const float* dy2;
  const float* scal_rows;
  int K, n, d, delayed, mode, cpb, c, sd, lane;
  bool vec16;
  long long chain;

  __device__ __forceinline__ float* slot(int k) const {
    const int s = mode == kStageWhole ? k : k % kRing;
    return base + (static_cast<size_t>(s) * cpb + c) * sd;
  }
  __device__ __forceinline__ void issue(int k) const {
    if (k >= K) return;
    float* dst = slot(k);
    const long long row = static_cast<long long>(k) * n + chain;
    for (int j = lane; j < d; j += 32) {
      cp_async4(dst + j, dy1 + row * d + j);
      if (delayed) cp_async4(dst + d + j, dy2 + row * d + j);
    }
    if (lane < 4) cp_async4(dst + 2 * d + lane, scal_rows + row * 4 + lane);
  }
  __device__ __forceinline__ void prologue() const {
    if (mode == kStageWhole && vec16) {
      for (int k = 0; k < K; ++k) {
        float* dst = slot(k);
        const long long row = static_cast<long long>(k) * n + chain;
        for (int q = lane; q < d / 4; q += 32) {
          cp_async16(dst + 4 * q, dy1 + row * d + 4 * q);
          if (delayed) cp_async16(dst + d + 4 * q, dy2 + row * d + 4 * q);
        }
        if (lane == 0) cp_async16(dst + 2 * d, scal_rows + row * 4);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    } else if (mode == kStageWhole) {
      for (int k = 0; k < K; ++k) issue(k);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    } else {
      for (int k = 0; k < kRing - 1; ++k) {
        issue(k);
        cp_async_commit();
      }
    }
  }
  // before step k: its slot has arrived; the slot step k - 1 read is
  // refilled with step k + kRing - 1
  __device__ __forceinline__ void begin(int k) const {
    if (mode != kStageRing) return;
    cp_async_wait<kRing - 2>();
    __syncwarp();
    issue(k + kRing - 1);
    cp_async_commit();
  }
  __device__ __forceinline__ const float* dy(int k, int st) const {
    return slot(k) + st * d;
  }
  __device__ __forceinline__ StepScal scal(int k) const {
    const float* s = slot(k) + 2 * d;
    return {s[0], s[1], s[2], s[3]};
  }
};

__device__ __forceinline__ float stage1_log_a(float l1, float lp) {
  return isfinite(l1) ? min0(__fsub_rn(l1, lp)) : -INFINITY;
}

__device__ __forceinline__ bool stage2_accept(float lp, float l1, float l2,
                                           float log_a1, StepScal sc) {
  const float log_a1_rev = min0(__fsub_rn(l1, l2));
  const float lq_diff = __fmul_rn(-0.5f, __fsub_rn(sc.sw, sc.sz1));
  const float log_num = __fadd_rn(l2, log1mexp(log_a1_rev));
  const float log_den = __fadd_rn(lp, log1mexp(log_a1));
  const float log_a2 =
      isfinite(l2) ? min0(__fsub_rn(__fadd_rn(log_num, lq_diff), log_den))
                   : -INFINITY;
  return sc.lu2 < log_a2;
}

__device__ __forceinline__ void write_step(const Args& a, long long row,
                                           float lp, bool acc1, bool acc2) {
  a.logp_hist[row] = lp;
  a.accepted[row] = (acc1 || acc2) ? 1 : 0;
  a.stage[row] = acc1 ? 1 : (acc2 ? 2 : 0);
}

// The per-step code every route runs. R supplies the chain's data:
// begin(k); both(k, l1, l2) forms y1 = x + dy1[k] and, with `delayed`,
// y2 = x + dy2[k] and both targets in one pass, as the plain version does
// (the second evaluation overlaps the first instead of following the
// first decision); scal(k); select(k, acc1, acc2, lp) keeps the chosen
// point and writes the history row. The second stage decides only where
// the first rejected.
template <class R>
__device__ __forceinline__ void run_steps(R& rt) {
  const Args& a = rt.a;
  const bool owner = rt.owner;
  float lp = rt.lp0;
  for (int k = 0; k < a.K; ++k) {
    rt.begin(k);
    float l1, l2;
    rt.both(k, l1, l2);
    StepScal sc = {0.f, 0.f, 0.f, 0.f};
    if (owner) sc = rt.scal(k);
    const float log_a1 = stage1_log_a(l1, lp);
    const bool acc1 = owner && sc.lu1 < log_a1;
    bool acc2 = false;
    if (owner && a.delayed && !acc1)
      acc2 = stage2_accept(lp, l1, l2, log_a1, sc);
    lp = acc1 ? l1 : (acc2 ? l2 : lp);
    rt.select(k, acc1, acc2, lp);
  }
}

// ---- latency route: one warp a chain, a lane a coordinate (d <= 32)
template <int kKind>
struct LatencyChain {
  Args a;                          // copies of the kernel's parameters
  Stager st;
  bipymc::Target tg;
  int lane, width;                 // width: the lowest power of two >= d
  bool owner;
  long long chain;
  float lp0, x, y1, y2, mu;
  float creg[kKind == 0 ? kLatD : 1];        // column `lane` of inv
  float mreg[kKind == 1 ? kMaxModes : 1];    // the means at `lane`

  __device__ __forceinline__ void begin(int k) { st.begin(k); }
  // y1, y2 and both targets: the stages' chains interleaved, lane for
  // lane, shuffle for shuffle (y2 stays 0 without `delayed`)
  __device__ __forceinline__ void both(int k, float& l1, float& l2) {
    const bool in = lane < a.d;
    const float* dy = st.dy(k, 0);
    y1 = in ? __fadd_rn(x, dy[lane]) : 0.f;
    y2 = in && a.delayed ? __fadd_rn(x, dy[a.d + lane]) : 0.f;
    if constexpr (kKind == 0) {
      const float r1 = in ? __fsub_rn(y1, mu) : 0.f;
      const float r2 = in && a.delayed ? __fsub_rn(y2, mu) : 0.f;
      float s1[8], s2[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) s1[m] = s2[m] = 0.f;
#pragma unroll
      for (int j = 0; j < kLatD; ++j) {
        if (j >= a.d) break;
        const float b1 = __shfl_sync(kFull, r1, j);
        const float b2 = __shfl_sync(kFull, r2, j);
        s1[j & 7] = fmaf(b1, creg[j], s1[j & 7]);
        s2[j & 7] = fmaf(b2, creg[j], s2[j & 7]);
      }
      float q1 = fmaf(__fadd_rn(join4(s1[0], s1[1], s1[2], s1[3]),
                                join4(s1[4], s1[5], s1[6], s1[7])), r1, 0.f);
      float q2 = fmaf(__fadd_rn(join4(s2[0], s2[1], s2[2], s2[3]),
                                join4(s2[4], s2[5], s2[6], s2[7])), r2, 0.f);
      lane_sum2(q1, q2, width);
      l1 = gauss_logp(q1, a.f0, a.f1);
      l2 = gauss_logp(q2, a.f0, a.f1);
    } else {
      float sq1[kMaxModes], sq2[kMaxModes];
#pragma unroll
      for (int m = 0; m < kMaxModes; ++m) {
        sq1[m] = sq2[m] = 0.f;
        if (m < a.n_modes) {
          const float d1 = in ? __fsub_rn(y1, mreg[m]) : 0.f;
          const float d2 = in ? __fsub_rn(y2, mreg[m]) : 0.f;
          sq1[m] = fmaf(d1, d1, 0.f);
          sq2[m] = fmaf(d2, d2, 0.f);
          lane_sum2(sq1[m], sq2[m], width);
        }
      }
      l1 = bipymc::mixture_lse(tg, sq1);
      l2 = bipymc::mixture_lse(tg, sq2);
    }
  }
  __device__ __forceinline__ StepScal scal(int k) const { return st.scal(k); }
  __device__ __forceinline__ void select(int k, bool acc1, bool acc2,
                                         float lp) {
    x = acc1 ? y1 : (acc2 ? y2 : x);
    const long long row = static_cast<long long>(k) * a.n + chain;
    if (lane < a.d) a.x_hist[row * a.d + lane] = x;
    if (lane == 0) write_step(a, row, lp, acc1, acc2);
  }
};

// ---- throughput and global routes: a block of chains, warp c owns chain c
template <int kRoute, int kKind>
struct BlockChains {
  Args a;                          // copies, as LatencyChain's
  Plan p;
  Stager st;
  bipymc::Target tg;
  float* vec0;                     // chain 0's x, y1, y2, s1, s2: kVecs x ld
  float* r0;                       // chain 0's r1, r2 [ld], shared
  const float* mu;                 // mean [d] (kind 0)
  float* ring;                     // global route: [kTiles][kTJ][threads]
  int tid, lane, c, nc;
  bool owner;
  long long chain0;
  float lp0;
  // throughput route: column i = tid % cols of inv, its rows j = 4 h .. 4 h
  // + 3 (mod 8), h = tid / cols, in registers
  float creg[kRoute == kThroughput ? kThrD / 2 : 1];
  int col, half, cols;
  // throughput route: the owner's coordinates lane, lane + 32, ... of x,
  // y1, y2, r1, r2 and the mean in registers
  static constexpr int kOwn = kRoute == kThroughput ? kThrD / 32 : 1;
  float xr[kOwn], y1r[kOwn], y2r[kOwn], r1r[kOwn], r2r[kOwn], mur[kOwn];
  StepScal sc_g;                   // global route: scal, loaded at begin
  // global route: the next tile to issue (its slot, first row and column
  // group) and the slot of the next tile to read
  int next_slot, next_row, next_group, use_slot;

  __device__ __forceinline__ float* vec(int cc, int v) const {
    return vec0 + (static_cast<size_t>(cc) * kVecs + v) * p.ld;
  }
  __device__ __forceinline__ float* svec(int cc, int t, int h) const {
    return vec(cc, kS + 2 * h + t);
  }
  // r of vector v = 2 cc + stage
  __device__ __forceinline__ float* rvec(int v) const {
    return r0 + static_cast<size_t>(v) * p.ld;
  }
  __device__ __forceinline__ void begin(int k) {
    if (kRoute == kThroughput) {
      if (owner) st.begin(k);
    } else if (owner) {
      const float* s =
          a.scal + (static_cast<long long>(k) * a.n + chain0 + c) * 4;
      sc_g = {s[0], s[1], s[2], s[3]};
    }
  }
  __device__ __forceinline__ const float* dy_row(int k, int s) const {
    if (kRoute == kThroughput) return st.dy(k, s);
    const float* src = s == 0 ? a.dy1 : a.dy2;
    return src + (static_cast<long long>(k) * a.n + chain0 + c) * a.d;
  }
  // The owner warp forms y1, y2 and their r; barrier; every thread forms
  // the s of its columns for every chain and stage; barrier; the owner
  // reduces q. Each buffer is written by one warp only after its own last
  // read, and read by others only before the barrier that follows, so one
  // of each serves every step.
  __device__ __forceinline__ void both(int k, float& l1, float& l2) {
    const int d = a.d;
    const int stages = a.delayed ? 2 : 1;
    if (kRoute == kThroughput && owner) {
      const float* __restrict__ dy1 = dy_row(k, 0);
      const float* __restrict__ dy2 = a.delayed ? dy_row(k, 1) : dy1;
      float* __restrict__ r1 = rvec(2 * c);
      float* __restrict__ r2 = rvec(2 * c + 1);
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        const int j = lane + 32 * m;
        if (j < d) {
          y1r[m] = __fadd_rn(xr[m], dy1[j]);
          y2r[m] = __fadd_rn(xr[m], dy2[j]);
          r1r[m] = __fsub_rn(y1r[m], mur[m]);
          r2r[m] = __fsub_rn(y2r[m], mur[m]);
          r1[j] = r1r[m];
          r2[j] = r2r[m];
        }
      }
    } else if (owner) {
      const float* __restrict__ dy1 = dy_row(k, 0);
      const float* __restrict__ dy2 = a.delayed ? dy_row(k, 1) : dy1;
      const float* __restrict__ x = vec(c, kX);
      const float* __restrict__ m = mu;
      float* __restrict__ y1 = vec(c, kY1);
      float* __restrict__ y2 = vec(c, kY2);
      float* __restrict__ r1 = rvec(2 * c);
      float* __restrict__ r2 = rvec(2 * c + 1);
#pragma unroll 4
      for (int j = lane; j < d; j += 32) {
        const float xj = x[j];
        const float v1 = __fadd_rn(xj, dy1[j]);
        const float v2 = __fadd_rn(xj, dy2[j]);
        y1[j] = v1;
        y2[j] = v2;
        if (kKind == 0) {
          const float mj = m[j];
          r1[j] = __fsub_rn(v1, mj);
          r2[j] = __fsub_rn(v2, mj);
        }
      }
    }
    l1 = l2 = 0.f;
    if constexpr (kKind == 0) {
      __syncthreads();             // r written
      form_s(stages);
      __syncthreads();             // s written
      if (!owner) return;
      const float* __restrict__ s1 = svec(c, 0, 0);
      const float* __restrict__ s2 = svec(c, 1, 0);
      float q1 = 0.f, q2 = 0.f;
      if constexpr (kRoute == kThroughput) {
        const float* __restrict__ s1b = svec(c, 0, 1);
        const float* __restrict__ s2b = svec(c, 1, 1);
#pragma unroll
        for (int m = 0; m < kOwn; ++m) {
          const int i = lane + 32 * m;
          if (i < d) {
            q1 = fmaf(__fadd_rn(s1[i], s1b[i]), r1r[m], q1);
            if (a.delayed) q2 = fmaf(__fadd_rn(s2[i], s2b[i]), r2r[m], q2);
          }
        }
      } else {
        const float* __restrict__ r1 = rvec(2 * c);
        const float* __restrict__ r2 = rvec(2 * c + 1);
#pragma unroll 4
        for (int i = lane; i < d; i += 32) {
          q1 = fmaf(s1[i], r1[i], q1);
          if (a.delayed) q2 = fmaf(s2[i], r2[i], q2);
        }
      }
      lane_sum2(q1, q2, 32);
      l1 = gauss_logp(q1, a.f0, a.f1);
      l2 = gauss_logp(q2, a.f0, a.f1);
    } else {
      if (!owner) return;
      const float* __restrict__ y1 = vec(c, kY1);
      const float* __restrict__ y2 = vec(c, kY2);
      float sq1[kMaxModes], sq2[kMaxModes];
#pragma unroll
      for (int mm = 0; mm < kMaxModes; ++mm) sq1[mm] = sq2[mm] = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float u1 = y1[j], u2 = y2[j];
#pragma unroll
        for (int mm = 0; mm < kMaxModes; ++mm) {
          if (mm < a.n_modes) {
            const float cm = a.c0[static_cast<size_t>(mm) * d + j];
            const float e1 = __fsub_rn(u1, cm), e2 = __fsub_rn(u2, cm);
            sq1[mm] = fmaf(e1, e1, sq1[mm]);
            sq2[mm] = fmaf(e2, e2, sq2[mm]);
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < kMaxModes; ++mm)
        if (mm < a.n_modes) lane_sum2(sq1[mm], sq2[mm], 32);
      l1 = bipymc::mixture_lse(tg, sq1);
      l2 = bipymc::mixture_lse(tg, sq2);
    }
  }
  // s_i of every chain and stage of the block, i = the thread's columns:
  // (a_0 + a_1) + (a_2 + a_3), a_m over rows j = m (mod 4)
  __device__ __forceinline__ void form_s(int stages) {
    const int d = a.d;
    const int nv = nc * stages;    // vector v: chain v / stages
    if (kRoute == kThroughput) {
      if (col >= d || half > 1) return;
      // two vectors at a time; rows 8 q + 4 h .. 8 q + 4 h + 3, one
      // 16-byte read of r each, four such reads a batch (r is zero to ld)
#pragma unroll 1
      for (int v = 0; v < nv; v += 2) {
        const bool two = v + 1 < nv;
        const int va = stages == 2 ? v : 2 * v;
        const int vb = stages == 2 ? v + 1 : 2 * (v + 1);
        const float4* ra = reinterpret_cast<const float4*>(rvec(va)) + half;
        const float4* rb =
            reinterpret_cast<const float4*>(rvec(two ? vb : va)) + half;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f), B = A;
#pragma unroll
        for (int q4 = 0; q4 < kThrD / 32; ++q4) {
          if (32 * q4 >= d) break;
          float4 x4[4], y4[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            x4[t] = ra[2 * (4 * q4 + t)];
            y4[t] = rb[2 * (4 * q4 + t)];
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int e = 4 * (4 * q4 + t);       // creg index, row 8 q + 4 h
            A.x = fmaf(x4[t].x, creg[e], A.x);
            A.y = fmaf(x4[t].y, creg[e + 1], A.y);
            A.z = fmaf(x4[t].z, creg[e + 2], A.z);
            A.w = fmaf(x4[t].w, creg[e + 3], A.w);
            B.x = fmaf(y4[t].x, creg[e], B.x);
            B.y = fmaf(y4[t].y, creg[e + 1], B.y);
            B.z = fmaf(y4[t].z, creg[e + 2], B.z);
            B.w = fmaf(y4[t].w, creg[e + 3], B.w);
          }
        }
        svec(va / 2, va % 2, half)[col] = join4(A.x, A.y, A.z, A.w);
        if (two)
          svec(vb / 2, vb % 2, half)[col] = join4(B.x, B.y, B.z, B.w);
      }
      return;
    }
    const int nt = p.threads;
    for (int i0 = 0; i0 < d; i0 += nt) {
      const int i = i0 + tid;
      const bool act = i < d;
      float acc[2 * kGlobalCpb][8];
#pragma unroll
      for (int v = 0; v < 2 * kGlobalCpb; ++v)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[v][e] = 0.f;
#pragma unroll 1
      for (int j0 = 0; j0 < d; j0 += kTJ) {
        cp_async_wait<kTiles - 2>();
        if (act) {
          const float* src =
              ring + static_cast<size_t>(use_slot) * kTJ * nt + tid;
          float w[kTJ];
#pragma unroll
          for (int jj = 0; jj < kTJ; ++jj) w[jj] = src[jj * nt];
          const int m = d - j0 < kTJ ? d - j0 : kTJ;
#pragma unroll
          for (int v = 0; v < 2 * kGlobalCpb; ++v) {
            if (v < 2 * nc && (stages == 2 || v % 2 == 0)) {
              const float4* r4 =
                  reinterpret_cast<const float4*>(rvec(v) + j0);
              const float4 lo = r4[0], hi = r4[1];
              const float rv[kTJ] = {lo.x, lo.y, lo.z, lo.w,
                                     hi.x, hi.y, hi.z, hi.w};
#pragma unroll
              for (int jj = 0; jj < kTJ; ++jj)   // j0 % 8 == 0: a_jj
                if (jj < m) acc[v][jj] = fmaf(rv[jj], w[jj], acc[v][jj]);
            }
          }
        }
        use_slot = (use_slot + 1) % kTiles;
        issue_tile();              // into the slot the last tile used
      }
      if (act) {
#pragma unroll
        for (int v = 0; v < 2 * kGlobalCpb; ++v)
          if (v < 2 * nc && (stages == 2 || v % 2 == 0))
            svec(v / 2, v % 2, 0)[i] =
                __fadd_rn(join4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]),
                          join4(acc[v][4], acc[v][5], acc[v][6], acc[v][7]));
      }
    }
  }
  // Global route: the tiles of inv in the order form_s reads them, one
  // evaluation after another (column group, then rows kTJ at a time), so
  // the ring never drains: the next step's first tiles arrive while this
  // one ends. The thread copies the elements of its own column.
  __device__ __forceinline__ void issue_tile() {
    const int d = a.d;
    const int nt = p.threads;
    const int i = next_group * nt + tid;
    if (i < d) {
      float* dst = ring + static_cast<size_t>(next_slot) * kTJ * nt + tid;
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) {
        const int j = next_row + jj;
        if (j < d)
          cp_async4(dst + jj * nt, a.c1 + static_cast<size_t>(j) * d + i);
      }
    }
    cp_async_commit();
    next_slot = (next_slot + 1) % kTiles;
    next_row += kTJ;
    if (next_row >= d) {
      next_row = 0;
      next_group = (next_group + 1) * nt < d ? next_group + 1 : 0;
    }
  }
  __device__ __forceinline__ StepScal scal(int k) const {
    return kRoute == kThroughput ? st.scal(k) : sc_g;
  }
  __device__ __forceinline__ void select(int k, bool acc1, bool acc2,
                                         float lp) {
    if (!owner) return;
    const long long row = static_cast<long long>(k) * a.n + chain0 + c;
    float* __restrict__ xo = a.x_hist + row * a.d;
    if constexpr (kRoute == kThroughput) {
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        const int j = lane + 32 * m;
        if (j < a.d) {
          xr[m] = acc1 ? y1r[m] : (acc2 ? y2r[m] : xr[m]);
          xo[j] = xr[m];
        }
      }
      if (lane == 0) write_step(a, row, lp, acc1, acc2);
      return;
    }
    float* __restrict__ x = vec(c, kX);
    const float* __restrict__ y1 = vec(c, kY1);
    const float* __restrict__ y2 = vec(c, kY2);
#pragma unroll 4
    for (int j = lane; j < a.d; j += 32) {
      const float v = acc1 ? y1[j] : (acc2 ? y2[j] : x[j]);
      x[j] = v;
      xo[j] = v;
    }
    if (lane == 0) write_step(a, row, lp, acc1, acc2);
  }
};

template <int kRoute, int kKind>
__global__ void __launch_bounds__(kRoute == kGlobal ? kGlobalThreads
                                                    : kBlockThreads)
fused_rw_chunk_kernel(Args a, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long chain0 = static_cast<long long>(blockIdx.x) * p.cpb;
  const int nc = static_cast<int>(
      a.n - chain0 < p.cpb ? a.n - chain0 : p.cpb);
  const int d = a.d;
  float* s_lw = smem;              // the mixture's log weights
  if (kKind == 1 && tid < a.n_modes) s_lw[tid] = a.c1[tid];
  bipymc::Target tg;
  tg.kind = kKind;
  tg.c = nullptr;
  tg.mu = nullptr;
  tg.log_w = s_lw;
  tg.k = a.n_modes;
  tg.f0 = a.f0;
  tg.f1 = a.f1;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  };
  const Stager st{smem + p.off_stage, a.dy1, a.dy2, a.scal, a.K, a.n, d,
                  a.delayed, p.stage, p.cpb, warp, 2 * d + 4, lane,
                  d % 4 == 0 && aligned(a.dy1) && aligned(a.scal) &&
                      (!a.delayed || aligned(a.dy2)),
                  chain0 + warp};

  if constexpr (kRoute == kLatency) {
    __syncthreads();               // s_lw
    if (warp >= nc) return;
    LatencyChain<kKind> ch{a, st, tg};
    ch.lane = lane;
    ch.owner = true;
    ch.chain = chain0 + warp;
    int width = 1;
    while (width < d) width <<= 1;
    ch.width = width;
    const bool in = lane < d;
    ch.x = in ? a.x0[ch.chain * d + lane] : 0.f;
    ch.y1 = ch.y2 = 0.f;
    ch.lp0 = a.logp0[ch.chain];
    if constexpr (kKind == 0) {
      ch.mu = in ? a.c0[lane] : 0.f;
#pragma unroll
      for (int j = 0; j < kLatD; ++j)
        ch.creg[j] = (in && j < d) ? a.c1[static_cast<size_t>(j) * d + lane]
                                   : 0.f;
    } else {
      ch.mu = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxModes; ++m)
        ch.mreg[m] = (in && m < a.n_modes)
                         ? a.c0[static_cast<size_t>(m) * d + lane] : 0.f;
    }
    st.prologue();
    run_steps(ch);
    cp_async_wait<0>();            // no copy outlives the block
  } else {
    BlockChains<kRoute, kKind> ch{a, p, st, tg};
    ch.tid = tid;
    ch.lane = lane;
    ch.c = warp;
    ch.nc = nc;
    ch.owner = warp < nc;
    ch.chain0 = chain0;
    ch.sc_g = {0.f, 0.f, 0.f, 0.f};
    const int ld = p.ld;
    ch.r0 = smem + p.off_r;
    if (kRoute == kThroughput) {
      float* s_mu = smem + p.off_vec;
      for (int j = tid; j < ld; j += blockDim.x)
        s_mu[j] = j < d ? a.c0[j] : 0.f;
      ch.mu = s_mu;
      ch.vec0 = s_mu + ld;
      ch.cols = (d + 31) / 32 * 32;
      ch.col = tid % ch.cols;
      ch.half = tid / ch.cols;
#pragma unroll
      for (int e = 0; e < kThrD / 2; ++e) {
        const int j = 8 * (e / 4) + 4 * ch.half + e % 4;
        ch.creg[e] = (ch.col < d && ch.half < 2 && j < d)
                         ? a.c1[static_cast<size_t>(j) * d + ch.col] : 0.f;
      }
      ch.ring = nullptr;
    } else {
      ch.mu = a.c0;
      ch.vec0 = a.work + static_cast<size_t>(chain0) * kVecs * ld;
      ch.ring = smem + p.off_ring;
      ch.creg[0] = 0.f;
      ch.col = ch.half = ch.cols = 0;
      ch.next_slot = ch.next_row = ch.next_group = ch.use_slot = 0;
      if (kKind == 0)
        for (int t = 0; t < kTiles - 1; ++t) ch.issue_tile();
    }
    ch.lp0 = 0.f;
    if (ch.owner) {
      ch.lp0 = a.logp0[chain0 + warp];
#pragma unroll
      for (int m = 0; m < ch.kOwn; ++m) {
        const int j = lane + 32 * m;
        const bool in = kRoute == kThroughput && j < d;
        ch.xr[m] = in ? a.x0[(chain0 + warp) * d + j] : 0.f;
        ch.mur[m] = in ? a.c0[j] : 0.f;
        ch.y1r[m] = ch.y2r[m] = ch.r1r[m] = ch.r2r[m] = 0.f;
      }
      for (int j = lane; j < ld; j += 32) {
        if (kRoute == kGlobal)   // the throughput route keeps x in registers
          ch.vec(warp, kX)[j] = j < d ? a.x0[(chain0 + warp) * d + j] : 0.f;
        if (kKind == 0) {                    // zeros past d stay
          ch.rvec(2 * warp)[j] = 0.f;
          ch.rvec(2 * warp + 1)[j] = 0.f;
        }
      }
      if (kRoute == kThroughput) st.prologue();
    }
    __syncthreads();
    run_steps(ch);
    cp_async_wait<0>();            // no copy outlives the block
  }
}

bool device_smem(int* max_smem) {
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess &&
         cudaDeviceGetAttribute(max_smem,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device) == cudaSuccess;
}

}  // namespace

// The plan fused_rw_chunk_launch makes for these shapes, into plan_out
// (int[6]): route (0 latency, 1 throughput, 2 global), chains a block,
// threads a block, dynamic shared bytes, staging (0 none, 1 ring, 2 all K
// steps) and ld (the floats of a chain's vector in the workspace). route:
// -1 the route the shape takes, else 0-2 forced. Returns 0, or -1 where
// the route does not take the shape or its shared memory does not fit.
extern "C" int fused_rw_chunk_plan(int n, int d, int K, int kind,
                                   int n_modes, int route, int* plan_out) {
  int max_smem = 0;
  if (!device_smem(&max_smem)) return static_cast<int>(cudaGetLastError());
  Plan p;
  if (!rw_plan(n, d, K, kind, n_modes, route, max_smem, &p)) return -1;
  plan_out[0] = p.route;
  plan_out[1] = p.cpb;
  plan_out[2] = p.threads;
  plan_out[3] = static_cast<int>(p.smem);
  plan_out[4] = p.stage;
  plan_out[5] = p.ld;
  return 0;
}

// x0 [n, d], logp0 [n], dy1 / dy2 [K, n, d] (dy2 may be null when not
// delayed), scal [K, n, 4] (|z1|^2, |z1 - z2/sqrt(kappa)|^2, log u1,
// log u2): float32, contiguous. kind 0: c0 = mean [d], c1 = inv [d, d],
// f0 = log_det, f1 = d log 2pi; kind 1: c0 = means [n_modes, d], c1 =
// log_w [n_modes], f0 = norm, f1 = sigma^2. route: as fused_rw_chunk_plan;
// work: the global route's workspace, float32 [n, 7, ld] (null on the
// other routes). Outputs: x_hist [K, n, d], logp_hist [K, n], accepted
// [K, n] bytes, stage [K, n] int32. Returns the launch's cudaError_t (0 on
// success), or -1, launching nothing, where the plan fails.
extern "C" int fused_rw_chunk_launch(
    const void* x0, const void* logp0, const void* dy1, const void* dy2,
    const void* scal, int K, int n, int d, int delayed, int kind,
    const void* c0, const void* c1, int n_modes, float f0, float f1,
    int route, void* work, void* x_hist, void* logp_hist, void* accepted,
    void* stage, void* stream) {
  int max_smem = 0;
  if (!device_smem(&max_smem)) return static_cast<int>(cudaGetLastError());
  Plan p;
  if (!rw_plan(n, d, K, kind, n_modes, route, max_smem, &p)) return -1;
  if (n == 0 || K == 0) return 0;
  if (p.route == kGlobal && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x0),
               static_cast<const float*>(logp0),
               static_cast<const float*>(dy1),
               static_cast<const float*>(dy2),
               static_cast<const float*>(scal),
               K, n, d, delayed != 0, n_modes,
               static_cast<const float*>(c0),
               static_cast<const float*>(c1), f0, f1,
               static_cast<float*>(x_hist), static_cast<float*>(logp_hist),
               static_cast<unsigned char*>(accepted), static_cast<int*>(stage),
               static_cast<float*>(work)};
  auto kernel =
      kind == 0 ? (p.route == kLatency ? fused_rw_chunk_kernel<kLatency, 0>
                   : p.route == kThroughput
                       ? fused_rw_chunk_kernel<kThroughput, 0>
                       : fused_rw_chunk_kernel<kGlobal, 0>)
                : (p.route == kLatency ? fused_rw_chunk_kernel<kLatency, 1>
                                       : fused_rw_chunk_kernel<kGlobal, 1>);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n + p.cpb - 1) / p.cpb;
  kernel<<<blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      a, p);
  return static_cast<int>(cudaGetLastError());
}
