// Kernel B1: G DREAM-zs generations for every chain in one launch.
//
// Replaces bipymc_tpu/ops/fused_chunk.py::fused_chunk_pallas (the
// pallas_call at :325, body _make_kernel at :162) in both of its modes.
// Stream mode: the crossover uniforms, the multiplicative uniforms and
// the normals come in as operands, made outside the kernel
// (samplers/dream_fused.py). Kernel-RNG mode (rng="kernel",
// _draw_kernel_randomness at :73): the kernel draws them itself, one
// Philox4x32-10 call (philox.cuh) per chain, lane and generation, counter
// (lane, chain, 0, 0) under kernel_seed(run key, t0 + g), and converts
// them as core/rng.py's bits_to_uniform and uniform_to_normal do. In both
// modes the archive rows and the per-chain scalars come in. Plain
// versions: bipymc_tpu_torch/ops/fused_chunk.py::fused_chunk_plain and
// fused_chunk_kernel_rng_plain, whose math this follows generation by
// generation: the proposal (ops/dream_proposal.py::propose_block: the
// masked sum over delta DE pairs, the crossover mask with the FIRST lane
// of the minimum u forced in, gamma = 2.38 rsqrt(2 delta d_eff), 1 on
// jump generations, and the snooker projection with its log Jacobian,
// with the 1e-30 clamps), the target through its kernel form
// (target.cuh), log_alpha = min(0, (lp* - lp) + log_jac) set to -inf
// where lp* is not finite, accept where log u < log_alpha, and the
// history row. Comparisons keep IEEE NaN semantics (a NaN acceptance
// compares false), so this file must not be built with --use_fast_math.
//
// What bounds it on the H100. At config 3 (G = 10, n = 256, k = 6,
// d = 100, the 4-mode mixture) the bytes the function needs are 8.0 MB in
// stream mode (2.4 us at 3.35 TB/s) and 5.2 MB in kernel-RNG mode, whose
// Philox and float64 inverse normal CDF add ~0.9 us of operations. In
// practice each chain's ten dependent generations bound it, each waiting
// for the last one's decision, after the inputs have arrived: clock64
// stamps put config 3's launch at ~18k cycles of staging and preparing
// (kernel-RNG mode: ~26k, the Philox words and their float64 conversions
// on top) and ~1.6k cycles a generation (the y loop, the butterfly of
// the modes' sums, logsumexp with its four divisions, the accept and the
// history row). The Gaussian on the global route (d = 240, 300) takes
// ~1,100 cycles for each 8-row tile of the inverse a chain's warp
// streams through its ring, 69-88 x the bound of its d^2 operations.
//
// The design. The work that does not depend on the chain's position is
// done before the generations, and a generation is only what must follow
// the last decision. Each (chain, generation)'s inputs are copied into
// shared memory by cp.async, every copy of the G generations at once, the
// block's threads stepping through them with no division a step: the
// archive rows 16 bytes a copy where d and their address allow it; each
// stream-mode draw row by the aligned 16-byte windows of device memory
// it covers, placed at its address's offset in a quad so that each
// window lands aligned (the runner's draw rows lie at a stride of 3d +
// 11 floats), the windows it covers only in part a float at a time. In
// kernel-RNG mode the block's threads make the Philox words and their
// conversions meanwhile. Then every warp prepares (chain, generation)
// items, the state-free part of the proposal: the first-min lane, the
// mask count, d_eff, gamma and, for a parallel move, the whole increment
// inc = m ((1 + e) gamma diff + b* eps), so that the generation itself
// is y = x + inc, the target and the accept (a snooker move forms
// |x - z|^2 and the snooker dot product, then x_snk and its norm, in the
// generation, as it needs x). Then one warp a chain runs the chain's
// generations: a lane owns the coordinate quads lane, lane + 32, ...,
// every lane runs the same loop (lanes past the last quad with nothing
// to add), every sum over d is a lane's partial in ascending coordinate
// order, then a butterfly of shuffles, so every lane holds the same total
// and the same accept bit; no block barrier and no load of device memory
// sits in the generation loop, and the history rows are stores nothing
// waits on. The mixture's modes are a compile-time count (4, or 16 with
// the modes past n_modes adding exact zeros: zero means, log weight
// -inf), so no mode is a branch. Two routes, which fused_chunk_plan.cuh::
// chunk_plan chooses in one place (the wrapper reads the plan through
// fused_chunk_plan, and ops/fused_chunk.py::plan mirrors it), run that one
// per-generation code (prepare and step below):
// - Shared route (config 3): the target's constants (the mixture's means,
//   or the Gaussian's inverse and mean) read into shared memory once a
//   block and shared by its n / 128 chains (1 to 8; 2 at n = 256: 128
//   blocks of 256 threads); each chain's x and proposal y in shared
//   memory; all G generations' inputs staged at the start (config 3:
//   84,864 bytes a block). It takes a shape where the constants, one
//   chain's vectors and its G slots fit the shared memory.
// - Global route (any d: the Gaussian past d = 192 at G = 10, the mixture
//   where its means and slots do not fit, and any shape forced): the
//   constants read from device memory, the Gaussian's inverse through a
//   per-warp ring of kTiles tiles of kTJ rows x 128 columns filled by
//   cp.async (each lane copies the quads it reads, so it waits for its
//   own copies and no barrier guards the ring, which runs on from one
//   generation into the next); the inputs read from device memory as they
//   are prepared, and the vectors in a workspace the wrapper allocates.
// One arithmetic in both routes: the Gaussian's s_i = ((a_0 + a_1) +
// (a_2 + a_3)) + ((a_4 + a_5) + (a_6 + a_7)), a_m one fmaf a term over
// j = m, m + 8, ... ascending, q a lane's fmaf(s_i, r_i, q) over its
// columns ascending; the mixture's per-mode fmaf(diff, diff); every other
// operation rounded on its own (__fadd_rn and kin, the plain version's
// order), so no route contracts it differently, and the routes' outputs
// are equal bit for bit. The Pallas kernel's lane padding to 128, the
// 2.0 pad of u and its constant hoisting (hoist_target_consts and
// lp_block_cache, ops/fused_chunk.py:110-159) are TPU mechanics and are
// not carried over. Philox is keyed per chain, not per block of chains as
// the TPU kernel seeds its hardware generator, so a chain's draws do not
// depend on the launch's shape.
//
// On the H100 (chip_smoke.py phase 2e; PERF.md's kernel table): config 3
// takes ~0.019 ms a launch in stream mode and ~0.023 ms in kernel-RNG
// mode (the kernel before these routes: ~0.045 and ~0.053 in turns), the
// global route forced there ~0.021; the Gaussian at n = 256 takes ~0.35
// ms at d = 240 and ~0.63 ms at d = 300. Tried and dropped: the chain
// warps running while the other warps prepare later generations behind
// a ready flag a generation (slower: the preparing warps slowed the
// chain warps' generations by ~30 %), and one warp copying a row (three
// times slower than every thread copying 16 bytes in turn).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "block_reduce.cuh"
#include "dream_propose.cuh"
#include "fused_chunk_plan.cuh"
#include "philox.cuh"
#include "target.cuh"

namespace {

using bipymc::kFull;
using bipymc::kMaxModes;
using bipymc::min0;

using namespace b1plan;   // the routes, the plan and its constants

static_assert(b1plan::kModes == kMaxModes, "one mode cap");
static_assert(kGroup == 4 * 32, "a tile row: one quad a lane");
constexpr int kWarps = kThreads / 32;
// lanes of the packed per-chain scalars [G, n, 6]
constexpr int kScal = 6;
constexpr int kDelta = 0, kCr = 1, kGammaS = 2, kSnooker = 3, kJump = 4,
              kLogU = 5;
constexpr int kX = 0, kY = 1, kR = 2;    // a chain's vectors

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

__device__ __forceinline__ bool aligned16(const void* q) {
  return reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
}

// a warp's total: a butterfly of __fadd_rn, the same bits in every lane
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Quad q (coordinates 4q .. 4q + 3) of a vector: one 16-byte access where
// the vector is padded to ld and 16-byte aligned (kVec: the shared route's
// staged and shared vectors), else the coordinates below d one by one
// (zeros past d on a load).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int q, int d) {
  if constexpr (kVec) {
    return reinterpret_cast<const float4*>(p)[q];
  } else {
    const int j = 4 * q;
    return make_float4(p[j], j + 1 < d ? p[j + 1] : 0.f,
                       j + 2 < d ? p[j + 2] : 0.f,
                       j + 3 < d ? p[j + 3] : 0.f);
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int q, int d, float4 v) {
  if constexpr (kVec) {
    reinterpret_cast<float4*>(p)[q] = v;
  } else {
    const int j = 4 * q;
    p[j] = v.x;
    if (j + 1 < d) p[j + 1] = v.y;
    if (j + 2 < d) p[j + 2] = v.z;
    if (j + 3 < d) p[j + 3] = v.w;
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// quad q of p where on, else zeros: lanes past the vector's last quad
// run the same code with nothing to add
template <bool kVec>
__device__ __forceinline__ float4 ld4(const float* p, int q, int d, bool on) {
  return on ? load4<kVec>(p, q, d) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ld4 of a vector that may start off a quad boundary (a staged draw row):
// one 16-byte access where kVec and the row is aligned
template <bool kVec>
__device__ __forceinline__ float4 ld4_any(const float* p, int q, int d,
                                         bool on) {
  return kVec && aligned16(p) ? ld4<true>(p, q, d, on)
                              : ld4<false>(p, q, d, on);
}

struct Args {
  const float* x0;
  const float* logp0;
  const float* rows;               // [G, n, k, d]
  int k;
  const float* um;                 // stream mode: [G, n, d] rows at ld_*
  long long ld_um;
  const float* ue;
  long long ld_ue;
  const float* ep;
  long long ld_ep;
  unsigned long long key;          // kernel-RNG mode
  long long t0;
  const unsigned* tb_m;            // kernel-RNG mode: words for Philox's
  const unsigned* tb_e;
  const unsigned* tb_n;
  const float* scal;               // [G, n, 6]
  int G, n, d, n_pairs;
  float jac_coef, b, b_star;
  int n_modes;
  const float* c0;                 // mean [d] | means [n_modes, d]
  const float* c1;                 // inv [d, d] | log_w [n_modes]
  float f0, f1;                    // log_det, d log 2pi | norm, sigma^2
  float* x_hist;
  float* logp_hist;
  unsigned char* accepted;
  float* work;                     // global route: [n, plan.work]
};

// One (chain, generation)'s inputs as prepare and step read them.
struct Slot {
  const float* rows;               // row p at rows + p * rs
  long long rs;
  const float* um;                 // the draws, [d] each
  const float* ue;
  const float* ep;
  float* dw;                       // kernel-RNG mode: the draws written
  long long ds;                    // at dw, dw + ds, dw + 2 ds
  const float* sc;                 // scal [6]
  float* prep;                     // the step's state-free vector: inc
                                   // (parallel), r1 - r2 (snooker)
};

// floats a staged draw row is placed past its slot row: its address's
// quad offset, so that the row's aligned 16-byte windows land on aligned
// shared addresses (0 for a row written in place by Philox)
__device__ __forceinline__ int quad_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<std::uintptr_t>(p) >> 2) & 3);
}

// kMC: the mixture's modes as the kernel sums them, a compile-time count
// (4 or kMaxModes) so that no mode is a branch; modes past n_modes have
// zero means and log weight -inf, so they add exact zeros to the sums
template <int kRoute, int kKind, bool kKernelRng, int kMC>
struct Chunk {
  static constexpr bool kVec = kRoute == kShared;
  Args a;                          // copies of the kernel's parameters
  Plan p;
  float* smem;
  int lane, nc, nq, groups;
  long long chain0;
  bipymc::Target tg;               // log_w in shared memory, k, f0, f1
  const float* cm;                 // means [k] | inv [d] rows at ldc
  const float* mu;                 // mean (kind 0)
  long long ldc;
  // global route, the Gaussian: this warp's ring of inv tiles, the next
  // tile to issue (its slot, first row and column group) and the slot of
  // the next tile to read
  float* ring;
  int next_slot, next_row, next_t, use_slot;
  bool vec_inv;

  __device__ __forceinline__ float* slot_base(int c, int g) const {
    return smem + p.off_stage +
           (static_cast<size_t>(g) * p.cpb + c) * p.slot;
  }

  __device__ __forceinline__ Slot slot(int c, int g) const {
    const int ld = p.ld;
    if constexpr (kRoute == kShared) {
      // rows [R][ld], prep [ld], the draws [3][ld + 4], scal
      float* base = slot_base(c, g);
      float* prep = base + static_cast<size_t>(p.rows) * ld;
      float* draws = prep + ld;
      const int ds = ld + 4;
      Slot s{base, ld, draws, draws + ds, draws + 2 * ds, draws, ds,
             draws + kDraws * ds, prep};
      if constexpr (!kKernelRng) {
        const long long row =
            static_cast<long long>(g) * a.n + chain0 + c;
        s.um += quad_shift(a.um + row * a.ld_um);
        s.ue += quad_shift(a.ue + row * a.ld_ue);
        s.ep += quad_shift(a.ep + row * a.ld_ep);
      }
      return s;
    } else {
      const long long chain = chain0 + c;
      const long long row = static_cast<long long>(g) * a.n + chain;
      float* draws = a.work + chain * static_cast<long long>(p.work) +
                     static_cast<long long>(kWorkVecs + kDraws * g) * ld;
      Slot s{a.rows + row * a.k * a.d, a.d, draws, draws + ld,
             draws + 2 * ld, draws, ld, a.scal + row * kScal, draws};
      if constexpr (!kKernelRng) {
        s.um = a.um + row * a.ld_um;
        s.ue = a.ue + row * a.ld_ue;
        s.ep = a.ep + row * a.ld_ep;
      }
      return s;
    }
  }

  // chain c's vector v (kX, kY, kR), [ld]
  __device__ __forceinline__ float* vec(int c, int v) const {
    if constexpr (kRoute == kShared)
      return smem + p.off_vec +
             (static_cast<size_t>(c) * (kKind == 0 ? 3 : 2) + v) * p.ld;
    else
      return a.work + (chain0 + c) * static_cast<long long>(p.work) +
             static_cast<long long>(v) * p.ld;
  }

  // Calls f(g, c, w, o) for o < per, w < nw, every item (g, c) of the G
  // generations and the block's chains, spread over the block's threads:
  // index e = ((g nc + c) nw + w) per + o, stepped with no division a
  // step.
  template <class F>
  __device__ __forceinline__ void for_copies(int nw, int per, F f) const {
    const int total = a.G * nc * nw * per;
    int e = threadIdx.x;
    int o = e % per, w = (e / per) % nw, it = e / per / nw;
    int c = it % nc, g = it / nc;
    const int su = kThreads / per, so = kThreads % per;
    for (; e < total; e += kThreads) {
      f(g, c, w, o);
      o += so;
      w += su;
      if (o >= per) {
        o -= per;
        ++w;
      }
      for (; w >= nw; w -= nw) {
        if (++c == nc) {
          c = 0;
          ++g;
        }
      }
    }
  }

  // Shared route: the G generations' inputs of the block's chains into
  // their slots (the caller commits and waits). The archive rows go 16
  // bytes a copy where d and their address allow it, else 4; in stream
  // mode each draw row goes by the aligned 16-byte windows of device
  // memory that it covers, placed quad_shift floats past its slot row so
  // that each window lands aligned, a window it covers only in part a
  // float at a time; then the scal rows.
  __device__ void stage() const {
    const int d = a.d, R = p.rows, ld = p.ld;
    const auto row_of = [&](int g, int c) {
      return static_cast<long long>(g) * a.n + chain0 + c;
    };
    const bool vec = d % 4 == 0 && aligned16(a.rows);
    for_copies(R, vec ? d / 4 : d, [&](int g, int c, int w, int o) {
      const float* src = a.rows + (row_of(g, c) * a.k + w) * d;
      float* dst = slot_base(c, g) + static_cast<size_t>(w) * ld;
      if (vec)
        cp_async16(dst + 4 * o, src + 4 * o);
      else
        cp_async4(dst + o, src + o);
    });
    if constexpr (!kKernelRng) {
      for_copies(kDraws, d / 4 + 2, [&](int g, int c, int w, int o) {
        const long long row = row_of(g, c);
        const float* src = w == 0 ? a.um + row * a.ld_um
                                  : (w == 1 ? a.ue + row * a.ld_ue
                                            : a.ep + row * a.ld_ep);
        const int sh = quad_shift(src);
        float* dst = slot_base(c, g) + static_cast<size_t>(R + 1) * ld +
                     static_cast<size_t>(w) * (ld + 4) + 4 * o;
        const int j0 = 4 * o - sh;             // the window's first float
        if (j0 >= 0 && j0 + 4 <= d) {
          cp_async16(dst, src + j0);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (j0 + t >= 0 && j0 + t < d) cp_async4(dst + t, src + j0 + t);
        }
      });
    }
    for_copies(1, kScal, [&](int g, int c, int, int o) {
      cp_async4(slot_base(c, g) + static_cast<size_t>(R + 1) * ld +
                    static_cast<size_t>(kDraws) * (ld + 4) + o,
                a.scal + row_of(g, c) * kScal + o);
    });
  }

  // Shared route: the target's constants into shared memory, rows at ld.
  __device__ void stage_consts(float* s_c) const {
    const int d = a.d, ld = p.ld;
    const int rows = kKind == 0 ? d + 1 : a.n_modes;
    const bool vec = d % 4 == 0 && aligned16(a.c0) &&
                     (kKind == 1 || aligned16(a.c1));
    const int per = vec ? d / 4 : d;
    for (int e = threadIdx.x; e < rows * per; e += kThreads) {
      const int r = e / per, o = e - r * per;
      const float* src = kKind == 1 || r < d
                             ? (kKind == 0 ? a.c1 : a.c0) +
                                   static_cast<size_t>(r) * d
                             : a.c0;
      float* dst = s_c + static_cast<size_t>(r) * ld;
      if (vec)
        cp_async16(dst + 4 * o, src + 4 * o);
      else
        cp_async4(dst + o, src + o);
    }
  }

  // Kernel-RNG mode: the G generations' draws for the block's chains,
  // element by element over the block's threads, written where prepare
  // reads them (a snooker item's are made too and not read)
  __device__ void draw() const {
    const int d = a.d;
    const int per_gen = nc * d;
    int key_g = -1;
    uint2 key = make_uint2(0u, 0u);
    for (int e = threadIdx.x; e < a.G * per_gen; e += blockDim.x) {
      const int g = e / per_gen, rest = e - g * per_gen;
      const int c = rest / d, j = rest - c * d;
      const long long chain = chain0 + c;
      const long long row = static_cast<long long>(g) * a.n + chain;
      unsigned wm, we, wn;
      if (a.tb_m != nullptr) {
        const long long at = row * d + j;
        wm = a.tb_m[at];
        we = a.tb_e[at];
        wn = a.tb_n[at];
      } else {
        if (g != key_g) {
          key = bipymc::kernel_seed(
              a.key, static_cast<unsigned long long>(a.t0 + g));
          key_g = g;
        }
        const uint4 w = bipymc::philox4x32_10(
            make_uint4(static_cast<unsigned>(j),
                       static_cast<unsigned>(chain), 0u, 0u),
            key);
        wm = w.x;
        we = w.y;
        wn = w.z;
      }
      const Slot sl = slot(c, g);
      sl.dw[j] = bits_to_uniform(wm);
      sl.dw[sl.ds + j] = bits_to_uniform(we);
      sl.dw[2 * sl.ds + j] = uniform_to_normal(bits_to_uniform(wn));
    }
  }

  // The state-free part of chain c's generation g, by one warp, after
  // draw in kernel-RNG mode: for a parallel move the first-min lane, the
  // mask count, d_eff, gamma, and the increment inc = m ((1 + e) gamma
  // diff + b* eps) into prep; for a snooker move r1 - r2 into prep. Each
  // lane reads and writes only its own quads.
  __device__ void prepare(int c, int g) const {
    const Slot s = slot(c, g);
    const int d = a.d;
    if (s.sc[kSnooker] > 0.5f) {
      for (int t = 0; t < groups; ++t) {
        const int q = lane + 32 * t;
        const bool on = q < nq;
        const float4 r1 = ld4<kVec>(s.rows + s.rs, q, d, on);
        const float4 r2 = ld4<kVec>(s.rows + 2 * s.rs, q, d, on);
        if (on)
          store4<kVec>(s.prep, q, d,
                       make_float4(__fsub_rn(r1.x, r2.x),
                                   __fsub_rn(r1.y, r2.y),
                                   __fsub_rn(r1.z, r2.z),
                                   __fsub_rn(r1.w, r2.w)));
      }
      return;
    }
    const float delta = s.sc[kDelta], cr = s.sc[kCr];
    const bool jump = s.sc[kJump] > 0.5f;
    // the first lane of the minimum u, and the count of u < cr
    float umin = INFINITY, cnt = 0.f;
    int ul = INT_MAX;
    for (int t = 0; t < groups; ++t) {
      const int q = lane + 32 * t;
      const float4 u4 = ld4_any<kVec>(s.um, q, d, q < nq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        if (j < d) {
          const float u = comp(u4, e);
          bipymc::min_first(umin, ul, u, j);
          cnt += u < cr ? 1.f : 0.f;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float u2 = __shfl_xor_sync(kFull, umin, off);
      const int l2 = __shfl_xor_sync(kFull, ul, off);
      cnt += __shfl_xor_sync(kFull, cnt, off);    // whole numbers: exact
      bipymc::min_first(umin, ul, u2, l2);
    }
    // the first-min lane is in the mask whether or not u < cr there
    const float d_eff = cnt + ((umin < cr) ? 0.f : 1.f);
    const float gamma = jump ? 1.f : 2.38f * rsqrtf(2.f * delta * d_eff);
    for (int t = 0; t < groups; ++t) {
      const int q = lane + 32 * t;
      const bool on = q < nq;
      float diff[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pp = 0; pp < a.n_pairs; ++pp) {
        const float w = (static_cast<float>(pp) < delta) ? 1.f : 0.f;
        const float4 ra = ld4<kVec>(s.rows + pp * s.rs, q, d, on);
        const float4 rb =
            ld4<kVec>(s.rows + (a.n_pairs + pp) * s.rs, q, d, on);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          diff[e] = __fadd_rn(
              diff[e], __fmul_rn(w, __fsub_rn(comp(ra, e), comp(rb, e))));
      }
      const float4 u4 = ld4_any<kVec>(s.um, q, d, on);
      const float4 e4 = ld4_any<kVec>(s.ue, q, d, on);
      const float4 n4 = ld4_any<kVec>(s.ep, q, d, on);
      float inc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        const float m = (comp(u4, e) < cr || j == ul) ? 1.f : 0.f;
        const float ee =
            __fmul_rn(a.b, __fsub_rn(__fmul_rn(2.f, comp(e4, e)), 1.f));
        const float mv = __fadd_rn(
            __fmul_rn(__fmul_rn(__fadd_rn(1.f, ee), gamma), diff[e]),
            __fmul_rn(a.b_star, comp(n4, e)));
        inc[e] = __fmul_rn(m, mv);
      }
      if (on)
        store4<kVec>(s.prep, q, d,
                     make_float4(inc[0], inc[1], inc[2], inc[3]));
    }
  }

  // Global route, the Gaussian: copy the next tile of inv in the order
  // gauss_q reads them (column group, then kTJ rows at a time, evaluation
  // after evaluation), this lane's quad of each row.
  __device__ __forceinline__ void issue_tile() {
    const int d = a.d;
    const int qd = lane + 32 * next_t;
    float* dst = ring + static_cast<size_t>(next_slot) * kTJ * kGroup +
                 4 * lane;
    if (qd < nq) {
#pragma unroll
      for (int jj = 0; jj < kTJ; ++jj) {
        const int j = next_row + jj;
        if (j >= d) break;
        const float* src = a.c1 + static_cast<size_t>(j) * d + 4 * qd;
        if (vec_inv) {
          cp_async16(dst + jj * kGroup, src);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * qd + e < d) cp_async4(dst + jj * kGroup + e, src + e);
        }
      }
    }
    cp_async_commit();
    next_slot = (next_slot + 1) % kTiles;
    next_row += kTJ;
    if (next_row >= d) {
      next_row = 0;
      next_t = next_t + 1 < groups ? next_t + 1 : 0;
    }
  }

  // q = sum_i s_i r_i with s_i = sum_j r_j inv[j, i], r at R: this lane's
  // columns (its quads) in ascending order, then the butterfly
  __device__ float gauss_q(const float* R) {
    const int d = a.d;
    float q = 0.f;
    for (int t = 0; t < groups; ++t) {
      const int qd = lane + 32 * t;
      const bool on = qd < nq;
      float acc[4][kTJ];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int jj = 0; jj < kTJ; ++jj) acc[e][jj] = 0.f;
      for (int j0 = 0; j0 < d; j0 += kTJ) {
        float4 w[kTJ];
        if constexpr (kRoute == kGlobal) {
          cp_async_wait<kTiles - 2>();
          const float* tile =
              ring + static_cast<size_t>(use_slot) * kTJ * kGroup + 4 * lane;
#pragma unroll
          for (int jj = 0; jj < kTJ; ++jj)
            w[jj] = (on && j0 + jj < d)
                        ? *reinterpret_cast<const float4*>(tile + jj * kGroup)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          use_slot = (use_slot + 1) % kTiles;
          issue_tile();            // into the slot the last tile used
        } else {
#pragma unroll
          for (int jj = 0; jj < kTJ; ++jj)
            w[jj] = (on && j0 + jj < d)
                        ? *reinterpret_cast<const float4*>(
                              cm + (j0 + jj) * ldc + 4 * qd)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < kTJ; ++jj) {
          if (j0 + jj < d) {
            const float rj = R[j0 + jj];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[e][jj] = fmaf(rj, comp(w[jj], e), acc[e][jj]);
          }
        }
      }
      if (on) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * qd + e;
          if (i < d) {
            const float s = __fadd_rn(
                __fadd_rn(__fadd_rn(acc[e][0], acc[e][1]),
                          __fadd_rn(acc[e][2], acc[e][3])),
                __fadd_rn(__fadd_rn(acc[e][4], acc[e][5]),
                          __fadd_rn(acc[e][6], acc[e][7])));
            q = fmaf(s, R[i], q);
          }
        }
      }
    }
    return warp_total(q);
  }

  // this lane's part of the target at quad q of y: the mixture's per-mode
  // squared distances, or the Gaussian's residual r = y - mean into R
  __device__ __forceinline__ void partial(float (&sq)[kMC], int q, bool on,
                                          float4 y, float* R) const {
    const int d = a.d;
    if constexpr (kKind == 1) {
#pragma unroll
      for (int m = 0; m < kMC; ++m) {
        const float4 c4 = ld4<kVec>(cm + m * ldc, q, d, on && m < tg.k);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e < d) {
            const float df = __fsub_rn(comp(y, e), comp(c4, e));
            sq[m] = fmaf(df, df, sq[m]);
          }
        }
      }
    } else {
      const float4 m4 = ld4<kVec>(mu, q, d, on);
      if (on)
        store4<kVec>(R, q, d,
                     make_float4(__fsub_rn(y.x, m4.x), __fsub_rn(y.y, m4.y),
                                 __fsub_rn(y.z, m4.z),
                                 __fsub_rn(y.w, m4.w)));
    }
  }

  __device__ __forceinline__ float target(float (&sq)[kMC],
                                          const float* R) {
    if constexpr (kKind == 1) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int m = 0; m < kMC; ++m)
          sq[m] = __fadd_rn(sq[m], __shfl_xor_sync(kFull, sq[m], off));
      // torch.logsumexp's max-shifted sum of (log_w + norm) - 0.5 sq / s^2
      // (target.cuh::mixture_lse, without its branch a mode)
      float mx = -INFINITY;
#pragma unroll
      for (int m = 0; m < kMC; ++m) {
        sq[m] = __fsub_rn(__fadd_rn(tg.log_w[m], tg.f0),
                          __fdiv_rn(__fmul_rn(0.5f, sq[m]), tg.f1));
        mx = fmaxf(mx, sq[m]);
      }
      const float shift = isinf(mx) ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kMC; ++m)
        sum = __fadd_rn(sum, expf(__fsub_rn(sq[m], shift)));
      return __fadd_rn(logf(sum), shift);
    } else {
      __syncwarp();                // R is whole
      const float q = gauss_q(R);
      return __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(q, tg.f0), tg.f1));
    }
  }

  // Chain c's generation g: the proposal y from x, the target, the
  // accept, the history row. X and Y swap where the proposal is accepted.
  __device__ void step(int c, int g, float& lp, float*& X, float*& Y) {
    const Slot s = slot(c, g);
    const int d = a.d;
    float* R = kKind == 0 ? vec(c, kR) : nullptr;
    const bool snk = s.sc[kSnooker] > 0.5f;
    const float log_u = s.sc[kLogU];
    float sq[kMC];
#pragma unroll
    for (int m = 0; m < kMC; ++m) sq[m] = 0.f;
    float log_jac = 0.f;
    if (!snk) {
      for (int t = 0; t < groups; ++t) {
        const int q = lane + 32 * t;
        const bool on = q < nq;
        const float4 x = ld4<kVec>(X, q, d, on);
        const float4 inc = ld4<kVec>(s.prep, q, d, on);
        const float4 y = make_float4(__fadd_rn(x.x, inc.x),
                                     __fadd_rn(x.y, inc.y),
                                     __fadd_rn(x.z, inc.z),
                                     __fadd_rn(x.w, inc.w));
        if (on) store4<kVec>(Y, q, d, y);
        partial(sq, q, on, y, R);
      }
    } else {
      // |x - z|^2 and (r1 - r2).(x - z), then x_snk and |x_snk - z|^2
      const float* z = s.rows;
      float den = 0.f, dot = 0.f;
      for (int t = 0; t < groups; ++t) {
        const int q = lane + 32 * t;
        const bool on = q < nq;
        const float4 x = ld4<kVec>(X, q, d, on);
        const float4 z4 = ld4<kVec>(z, q, d, on);
        const float4 dr = ld4<kVec>(s.prep, q, d, on);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e < d) {
            const float ud = __fsub_rn(comp(x, e), comp(z4, e));
            den = fmaf(ud, ud, den);
            dot = fmaf(comp(dr, e), ud, dot);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float pd = __shfl_xor_sync(kFull, den, off);
        const float pt = __shfl_xor_sync(kFull, dot, off);
        den = __fadd_rn(den, pd);
        dot = __fadd_rn(dot, pt);
      }
      const float denom = fmaxf(den, 1e-30f);
      const float coef = __fmul_rn(s.sc[kGammaS], __fdiv_rn(dot, denom));
      float num = 0.f;
      for (int t = 0; t < groups; ++t) {
        const int q = lane + 32 * t;
        const bool on = q < nq;
        const float4 x = ld4<kVec>(X, q, d, on);
        const float4 z4 = ld4<kVec>(z, q, d, on);
        float ys[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ud = __fsub_rn(comp(x, e), comp(z4, e));
          ys[e] = fmaf(coef, ud, comp(x, e));
          const float dz = __fsub_rn(ys[e], comp(z4, e));
          if (4 * q + e < d) num = fmaf(dz, dz, num);
        }
        const float4 y = make_float4(ys[0], ys[1], ys[2], ys[3]);
        if (on) store4<kVec>(Y, q, d, y);
        partial(sq, q, on, y, R);
      }
      num = warp_total(num);
      log_jac = __fmul_rn(a.jac_coef,
                          __fsub_rn(logf(fmaxf(num, 1e-30f)), logf(denom)));
    }
    const float lps = target(sq, R);
    const float log_alpha =
        isfinite(lps) ? min0(__fadd_rn(__fsub_rn(lps, lp), log_jac))
                      : -INFINITY;
    const bool acc = log_u < log_alpha;
    if (acc) {
      float* t = X;
      X = Y;
      Y = t;
      lp = lps;
    }
    const long long row = static_cast<long long>(g) * a.n + chain0 + c;
    float* xo = a.x_hist + row * d;
    const bool vo = d % 4 == 0 && aligned16(a.x_hist);
    for (int t = 0; t < groups; ++t) {
      const int q = lane + 32 * t;
      const bool on = q < nq;
      const float4 x = ld4<kVec>(X, q, d, on);
      if (on && vo)
        reinterpret_cast<float4*>(xo)[q] = x;
      else if (on)
        store4<false>(xo, q, d, x);
    }
    if (lane == 0) {
      a.logp_hist[row] = lp;
      a.accepted[row] = acc ? 1 : 0;
    }
  }
};

template <int kRoute, int kKind, bool kKernelRng, int kMC>
__global__ void __launch_bounds__(kThreads)
fused_chunk_kernel(Args a, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = a.d;
  Chunk<kRoute, kKind, kKernelRng, kMC> ck;
  ck.a = a;
  ck.p = p;
  ck.smem = smem;
  ck.lane = lane;
  ck.chain0 = static_cast<long long>(blockIdx.x) * p.cpb;
  ck.nc = static_cast<int>(
      a.n - ck.chain0 < p.cpb ? a.n - ck.chain0 : p.cpb);
  ck.nq = (d + 3) / 4;
  ck.groups = (ck.nq + 31) / 32;
  float* s_lw = smem;              // the mixture's log weights, -inf past
  if (kKind == 1 && tid < kModes)  // n_modes
    s_lw[tid] = tid < a.n_modes ? a.c1[tid] : -INFINITY;
  ck.tg.kind = kKind;
  ck.tg.c = nullptr;
  ck.tg.mu = nullptr;
  ck.tg.log_w = s_lw;
  ck.tg.k = a.n_modes;
  ck.tg.f0 = a.f0;
  ck.tg.f1 = a.f1;
  if constexpr (kRoute == kShared) {
    ck.cm = smem + p.off_c;
    ck.mu = ck.cm + static_cast<size_t>(d) * p.ld;
    ck.ldc = p.ld;
  } else {
    ck.cm = a.c0;
    ck.mu = a.c0;
    ck.ldc = d;
  }
  ck.ring = smem + p.off_c + static_cast<size_t>(warp) * kTiles * kTJ *
                                 kGroup;
  ck.next_slot = ck.next_row = ck.next_t = ck.use_slot = 0;
  ck.vec_inv = d % 4 == 0 && aligned16(a.c1);

  const bool owner = warp < ck.nc;
  float lp = 0.f;
  float* X = ck.vec(warp, kX);
  float* Y = ck.vec(warp, kY);
  if (owner) {
    lp = a.logp0[ck.chain0 + warp];
    for (int j = lane; j < d; j += 32) X[j] = a.x0[(ck.chain0 + warp) * d + j];
    if (kRoute == kGlobal && kKind == 0)
      for (int t = 0; t < kTiles - 1; ++t) ck.issue_tile();
  }
  if constexpr (kRoute == kShared) {
    ck.stage_consts(smem + p.off_c);
    ck.stage();
    cp_async_commit();
  }
  if constexpr (kKernelRng) ck.draw();   // while the copies fly
  if constexpr (kRoute == kShared) cp_async_wait<0>();
  __syncthreads();                 // inputs, constants, x, log_w in place
  for (int it = warp; it < a.G * ck.nc; it += kWarps)
    ck.prepare(it % ck.nc, it / ck.nc);
  __syncthreads();                 // every item prepared
  if (owner)
    for (int g = 0; g < a.G; ++g) ck.step(warp, g, lp, X, Y);
  cp_async_wait<0>();              // no copy outlives the block
}

bool device_smem(int* max_smem) {
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess &&
         cudaDeviceGetAttribute(max_smem,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device) == cudaSuccess;
}

using KernelFn = void (*)(Args, Plan);

template <int kRoute, int kKind, int kMC>
KernelFn pick(bool kernel_rng) {
  return kernel_rng ? fused_chunk_kernel<kRoute, kKind, true, kMC>
                    : fused_chunk_kernel<kRoute, kKind, false, kMC>;
}

template <int kRoute>
KernelFn pick(int kind, int n_modes, bool kernel_rng) {
  return kind == 0 ? pick<kRoute, 0, 1>(kernel_rng)
                   : (n_modes <= 4 ? pick<kRoute, 1, 4>(kernel_rng)
                                   : pick<kRoute, 1, kMaxModes>(kernel_rng));
}

}  // namespace

// The plan fused_chunk_launch makes for these shapes, into plan_out
// (int[5]): route (0 shared, 1 global), chains a block, threads a block,
// dynamic shared bytes and ld (the floats of a vector: the global route's
// workspace is [n, 3 + 3 G, ld] floats). route: -1 the route the shape
// takes, else 0-1 forced. Returns 0, or -1 where the route does not take
// the shape.
extern "C" int fused_chunk_plan(int n, int d, int G, int n_pairs, int kind,
                                int n_modes, int route, int* plan_out) {
  int max_smem = 0;
  if (!device_smem(&max_smem)) return static_cast<int>(cudaGetLastError());
  Plan p;
  if (!chunk_plan(n, d, G, n_pairs, kind, n_modes, route, max_smem, &p))
    return -1;
  plan_out[0] = p.route;
  plan_out[1] = p.cpb;
  plan_out[2] = p.threads;
  plan_out[3] = static_cast<int>(p.smem);
  plan_out[4] = p.ld;
  return 0;
}

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
// f1 = sigma^2. route: as fused_chunk_plan; work: the global route's
// workspace (null on the shared route). Outputs, contiguous: x_hist
// [G, n, d], logp_hist [G, n], accepted [G, n] bytes. Returns the
// launch's cudaError_t (0 on success), or -1, launching nothing, where
// the plan fails.
extern "C" int fused_chunk_launch(
    const void* x0, const void* logp0, const void* rows, int k,
    const void* u_mask, long long ld_um, const void* u_e, long long ld_ue,
    const void* eps, long long ld_eps, int kernel_rng,
    unsigned long long key, long long t0, const void* tb_m, const void* tb_e,
    const void* tb_n, const void* scal, int G, int n, int d, int n_pairs,
    float jac_coef, float b, float b_star, int kind, const void* c0,
    const void* c1, int n_modes, float f0, float f1, int route, void* work,
    void* x_hist, void* logp_hist, void* accepted, void* stream) {
  int max_smem = 0;
  if (!device_smem(&max_smem)) return static_cast<int>(cudaGetLastError());
  Plan p;
  if (!chunk_plan(n, d, G, n_pairs, kind, n_modes, route, max_smem, &p))
    return -1;
  if (n == 0 || G == 0) return 0;
  if (p.route == kGlobal && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x0),
               static_cast<const float*>(logp0),
               static_cast<const float*>(rows),
               k,
               static_cast<const float*>(u_mask),
               ld_um,
               static_cast<const float*>(u_e),
               ld_ue,
               static_cast<const float*>(eps),
               ld_eps,
               key,
               t0,
               static_cast<const unsigned*>(tb_m),
               static_cast<const unsigned*>(tb_e),
               static_cast<const unsigned*>(tb_n),
               static_cast<const float*>(scal),
               G,
               n,
               d,
               n_pairs,
               jac_coef,
               b,
               b_star,
               n_modes,
               static_cast<const float*>(c0),
               static_cast<const float*>(c1),
               f0,
               f1,
               static_cast<float*>(x_hist),
               static_cast<float*>(logp_hist),
               static_cast<unsigned char*>(accepted),
               static_cast<float*>(work)};
  const bool krng = kernel_rng != 0;
  const KernelFn kernel = p.route == kShared
                              ? pick<kShared>(kind, n_modes, krng)
                              : pick<kGlobal>(kind, n_modes, krng);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n + p.cpb - 1) / p.cpb;
  kernel<<<blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      a, p);
  return static_cast<int>(cudaGetLastError());
}
