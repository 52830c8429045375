// Kernel B6: batched Cholesky L = chol(A), with the forward solve
// z = L^-1 y woven in when y is given.
//
// Replaces bipymc_tpu/ops/pallas_bchol.py::cholesky_batched_pallas (:250)
// and cholesky_solve_batched_pallas (:274), both _bchol_fwd_impl (:177,
// the pallas_call at :210, kernel body _make_kernel :51). Plain version:
// bipymc_tpu_torch/ops/pallas_bchol.py::cholesky_solve_plain
// (torch.linalg.cholesky_ex + solve_triangular). One source serves both
// entry points: L is computed by the same instructions with and without
// y, so the two give bit-equal L.
//
// A matrix whose factorisation meets a pivot that is not > 0 (or is NaN)
// comes back all NaN, L and z: each CTA flags the pivots it takes, the
// flags are read across the cluster after the last step, and the launch
// never traps or stops early. The sampler then rejects that chain, as it
// rejects the reference's rsqrt of a negative pivot.
//
// What bounds it on the H100: the chain of dependent panel steps. At the
// GP's config-4 shape, 64 matrices of 512 x 512, the work is 64 x 512^3
// / 6 = 1.43 G FMAs for the factor and 64 x 512^2 / 2 FMAs for the solve
// (2.88 GFLOP, 0.043 ms at 67 TFLOP/s) and the bytes 2 x 67 MB (0.040 ms
// at 3.35 TB/s); but column block J cannot be factored before panels
// 0 .. J-1 have updated it, so each matrix walks 16 steps, each a
// 32-column dependent factor, a panel solve and a trailing update; one
// 512-thread block a matrix would leave 68 of the 132 SMs idle and stall
// its warps at every factor (PERF.md, section 6). This design:
// - plan (bchol_plan.cuh): P = 2 CTAs of a thread-block cluster a matrix
//   where the batch leaves SMs idle (config 4: 128 of 132 SMs), else 1,
//   the same code with a cluster of one. Block column J of the lower
//   triangle belongs to CTA owner(J), dealt in a snake; L is factored in
//   place in the output (a 512^2 matrix is 1 MB, beyond a cluster's
//   shared memory), and each CTA reads and writes only its own columns;
// - panel step k: every CTA copies the solved panel k (its rows below
//   the diagonal block, 32 floats each, quads XOR-swizzled by row) from L
//   into its shared memory through L2; the owner of column K = k + 1
//   first updates that column's tiles with every warp, then its first
//   four warps take the look-ahead while the CTA's other warps, and every
//   warp of the other CTA, update their own trailing tiles with panel k.
//   The look-ahead: one warp factors diagonal block K (lane i holds row
//   i; a column takes its pivot's reciprocal square root, rsqrtf, and
//   multiplies, so no IEEE square root or division sits on the dependent
//   chain) and solves z's block K; then the four warps solve panel K's
//   rows against it, a row a thread, multiplying by the same reciprocals,
//   read as plain shared loads; write them to L; and update z's rows
//   below. One barrier.cluster ends a step. The diagonal factor thus
//   hides behind the other warps' trailing update instead of stalling 15
//   warps. (Pushing the solved panel into every CTA's shared memory
//   through distributed shared memory, into a slot of the step's parity,
//   took 1.7 % longer at config 4 and needs two slots, which do not fit
//   past n = 896: PERF.md, section 6.);
// - a trailing tile C -= A B^T takes 64 threads, 4 x 4 outputs each (rows
//   ty + 8u, four adjacent columns 4 tx .. 4 tx + 3): the operands are
//   16-byte reads of the panel slot (A broadcast across 8 threads, B's 8
//   rows in 8 different bank groups by the swizzle), full float32 FMAs
//   summed over the panel's 32 columns in order (no TF32: at config 4 the
//   dependent chain, not the FMA rate, sets the pace). C is read and
//   written with 16-byte accesses where n % 4 == 0, and the next tile's C
//   is loaded into registers before this tile's FMAs, so its latency
//   hides under them. (A cp.async double buffer in shared memory would
//   need 8 groups x 8 KB beside the panel: it does not fit beside one
//   slot at n = 1600.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bchol_plan.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace b6plan;

constexpr unsigned kFull = 0xffffffffu;

// the float offset of quad q (columns 4q .. 4q + 3) of slot row r: rows of
// 32 floats, quad q stored at q ^ ((r / 4) % 8), so that the rows 4x + v,
// x = 0 .. 7, that 8 threads read together fall in 8 bank groups
__device__ __forceinline__ int pq(int r, int q) {
  return r * kNb + ((q ^ (r >> 2)) & 7) * 4;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Four consecutive columns col .. col + 3 of row `row` of the n x n matrix
// m: one 16-byte access where vec, else one float at a time, zeros (or no
// store) past n.
__device__ __forceinline__ float4 load4(const float* m, int row, int col,
                                        int n, bool vec) {
  const float* p = m + static_cast<long long>(row) * n + col;
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], col + 1 < n ? p[1] : 0.f,
                     col + 2 < n ? p[2] : 0.f, col + 3 < n ? p[3] : 0.f);
}

__device__ __forceinline__ void store4(float* m, int row, int col, int n,
                                       bool vec, float4 v) {
  float* p = m + static_cast<long long>(row) * n + col;
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (col + 1 < n) p[1] = v.y;
  if (col + 2 < n) p[2] = v.z;
  if (col + 3 < n) p[3] = v.w;
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// One group of 64 threads (lt = its thread) of G groups, the g-th: the
// tiles of a walk (bchol_plan.cuh::advance) from (I, J), every G-th from
// the g-th on, each C -= A B^T with A, B the rows of block rows I and J
// of the panel slot pk. The next tile's C is loaded before this tile's
// FMAs. In a diagonal tile (I == J) only the lower triangle changes (the
// strict upper one stays as read, zero).
__device__ __forceinline__ void update_tiles(float* Lm, const float* pk,
                                             int n, bool vec, int nb, int P,
                                             int me, bool one_column, int I,
                                             int J, int g, int G, int lt) {
  const int ty = lt / 8, tx = lt % 8;
  float4 cur[4];
  auto load_c = [&](int ti, int tj, float4 (&c)[4]) {
    const int col = tj * kNb + 4 * tx;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = ti * kNb + ty + 8 * u;
      c[u] = row < n && col < n ? load4(Lm, row, col, n, vec)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  advance(&I, &J, g, nb, P, me, one_column);
  if (J < nb) load_c(I, J, cur);
  while (J < nb) {
    float4 nxt[4];
    int In = I, Jn = J;
    advance(&In, &Jn, G, nb, P, me, one_column);
    if (Jn < nb) load_c(In, Jn, nxt);
    // slot rows are the matrix's rows less 32
    const float* pa = pk + (I - 1) * kNb * kNb;
    const float* pb = pk + (J - 1) * kNb * kNb;
    float acc[4][4] = {};
#pragma unroll
    for (int q = 0; q < kNb / 4; ++q) {
      float4 av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        av[u] = *reinterpret_cast<const float4*>(pa + pq(ty + 8 * u, q));
#pragma unroll
      for (int v = 0; v < 4; ++v)
        bv[v] = *reinterpret_cast<const float4*>(pb + pq(4 * tx + v, q));
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] = fmaf(av[u].x, bv[v].x, acc[u][v]);
          acc[u][v] = fmaf(av[u].y, bv[v].y, acc[u][v]);
          acc[u][v] = fmaf(av[u].z, bv[v].z, acc[u][v]);
          acc[u][v] = fmaf(av[u].w, bv[v].w, acc[u][v]);
        }
    }
    const int col = J * kNb + 4 * tx;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rr = ty + 8 * u, row = I * kNb + rr;
      float o[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float c = get(cur[u], v);
        o[v] = I != J || 4 * tx + v <= rr ? c - acc[u][v] : c;
      }
      if (row < n && col < n)
        store4(Lm, row, col, n, vec, make_float4(o[0], o[1], o[2], o[3]));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
    I = In;
    J = Jn;
  }
}

// One warp: diagonal block K of Lm factored in place. Lane i holds row i
// (rows past n hold the identity, so their pivots are 1); lt gets L^T,
// inv the reciprocal square roots of the pivots. A pivot that is not > 0
// sets *failed. Then, with z, z's block K solved (into zk and zm).
__device__ __forceinline__ void factor_diag(float* Lm, float* zm, int n,
                                            int K, bool vec, float* lt,
                                            float* inv, float* zk,
                                            int* failed) {
  const int i = threadIdx.x % 32, row = K * kNb + i;
  const bool in = row < n;
  float r[kNb];
#pragma unroll
  for (int q = 0; q < kNb; q += 4) {
    const int col = K * kNb + q;
    const float4 v = in && col < n ? load4(Lm, row, col, n, vec)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    r[q] = v.x; r[q + 1] = v.y; r[q + 2] = v.z; r[q + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < kNb; ++q)
    r[q] = in ? (q <= i ? r[q] : 0.f) : (q == i ? 1.f : 0.f);
  float d = __shfl_sync(kFull, r[0], 0);
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float inv_j = rsqrtf(d);            // NaN or inf unless d > 0
    inv[j] = inv_j;         // the same value from every lane, no branch
    bad |= !(d > 0.f);
    const float lj = i > j ? r[j] * inv_j : (i == j ? d * inv_j : 0.f);
    // the next pivot, from lane j+1's own values: the same FMA as its
    // update below, so the same bits
    float dn = 0.f;
    if (j + 1 < kNb)
      dn = __shfl_sync(kFull, fmaf(-lj, lj, r[j + 1]), j + 1);
    r[j] = lj;
    lt[j * kLd + i] = lj;
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4 * 4; q < kNb; q += 4) {
      const float4 l = *reinterpret_cast<const float4*>(lt + j * kLd + q);
      if (q > j) r[q] = fmaf(-lj, l.x, r[q]);
      if (q + 1 > j) r[q + 1] = fmaf(-lj, l.y, r[q + 1]);
      if (q + 2 > j) r[q + 2] = fmaf(-lj, l.z, r[q + 2]);
      if (q + 3 > j) r[q + 3] = fmaf(-lj, l.w, r[q + 3]);
    }
    d = dn;
  }
  if (bad) *failed = 1;
  // entries right of the diagonal took updates before their column set
  // them to 0; the block's strict upper triangle is written as zeros
  if (in) {
#pragma unroll
    for (int q = 0; q < kNb; q += 4) {
      const int col = K * kNb + q;
      if (col < n)
        store4(Lm, row, col, n, vec,
               make_float4(r[q], r[q + 1], r[q + 2], r[q + 3]));
    }
  }
  if (zm) {
    // z's rows of block K hold y less the panels before K (read through
    // L2: another CTA of the cluster may have written them)
    float zi = in ? __ldcg(zm + row) : 0.f;
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      const float zj = __shfl_sync(kFull, zi, j) * inv[j];
      zi = i == j ? zj : (i > j ? fmaf(-r[j], zj, zi) : zi);
    }
    zk[i] = zi;
    if (in) zm[row] = zi;
  }
}

// The look-ahead warps (tl = 0 .. 32 kLaWarps - 1): panel K's rows R >=
// 32 (K + 1), a row a thread, solve x L_KK^T = a against lt and inv (each
// column takes the updates of the columns before it in order, then
// multiplies by its reciprocal pivot); x is written to L; with z, z_R -=
// x . zk.
__device__ __forceinline__ void solve_panel(float* Lm, float* zm, int n,
                                            int K, bool vec, const float* lt,
                                            const float* inv, const float* zk,
                                            int tl) {
  for (int R = (K + 1) * kNb + tl; R < n; R += kLaWarps * 32) {
    // an opaque offset a row, so that the compiler reloads the diagonal
    // block's values from shared memory for each row instead of hoisting
    // all 560 of them into registers
    int o = 0;
    asm volatile("" : "+r"(o));
    float a[kNb];
#pragma unroll
    for (int q = 0; q < kNb; q += 4) {
      const float4 v = load4(Lm, R, K * kNb + q, n, vec);
      a[q] = v.x; a[q + 1] = v.y; a[q + 2] = v.z; a[q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      a[j] *= inv[o + j];
#pragma unroll
      for (int q = (j + 1) / 4 * 4; q < kNb; q += 4) {
        const float4 l =
            *reinterpret_cast<const float4*>(lt + o + j * kLd + q);
        if (q > j) a[q] = fmaf(-a[j], l.x, a[q]);
        if (q + 1 > j) a[q + 1] = fmaf(-a[j], l.y, a[q + 1]);
        if (q + 2 > j) a[q + 2] = fmaf(-a[j], l.z, a[q + 2]);
        if (q + 3 > j) a[q + 3] = fmaf(-a[j], l.w, a[q + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < kNb; q += 4) {
      store4(Lm, R, K * kNb + q, n, vec,
             make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]));
    }
    if (zm) {
      float s = __ldcg(zm + R);
#pragma unroll
      for (int j = 0; j < kNb; ++j) s = fmaf(-a[j], zk[o + j], s);
      zm[R] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bchol_kernel(const float* __restrict__ a, const float* __restrict__ y,
             float* L, float* z, int b, int n) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);   // the panel slot
  const int nb = (n + kNb - 1) / kNb;
  float* const lt = smem + (nb - 1) * kNb * kNb;  // L_KK^T, rows of kLd
  float* const inv = lt + kNb * kLd;            // 1 / diag(L_KK)
  float* const zk = inv + kNb;                  // z's block K, solved
  int* const failed = reinterpret_cast<int*>(zk + kNb);

  cg::cluster_group cluster = cg::this_cluster();
  const int P = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = tid / kGroupThreads, lt_id = tid % kGroupThreads;
  const long long nn = static_cast<long long>(n) * n;
  const int nq = nb * kNb / 4;                  // quads a padded row

  for (int c = blockIdx.y; c < b; c += gridDim.y) {
    const float* A = a + c * nn;
    float* Lm = L + c * nn;
    float* zm = y ? z + static_cast<long long>(c) * n : nullptr;
    const bool vec = n % 4 == 0 && aligned16(A) && aligned16(Lm);
    if (tid == 0) *failed = 0;
    // this CTA's column blocks of A's lower triangle into L, the strict
    // upper triangle as zeros; z = y (CTA 0, which owns column 0)
    for (long long e = tid; e < static_cast<long long>(n) * nq;
         e += kThreads) {
      const int row = static_cast<int>(e / nq), q = static_cast<int>(e % nq);
      const int col = 4 * q;
      if (owner(col / kNb, P) != me || col >= n) continue;
      const float* src = A + static_cast<long long>(row) * n + col;
      float4 v = vec ? __ldg(reinterpret_cast<const float4*>(src))
                     : load4(A, row, col, n, false);
      v.x = col <= row ? v.x : 0.f;
      v.y = col + 1 <= row ? v.y : 0.f;
      v.z = col + 2 <= row ? v.z : 0.f;
      v.w = col + 3 <= row ? v.w : 0.f;
      store4(Lm, row, col, n, vec, v);
    }
    if (zm && me == 0)
      for (int i = tid; i < n; i += kThreads)
        zm[i] = y[static_cast<long long>(c) * n + i];
    __threadfence();
    __syncthreads();

    // step k: panel k updates the trailing tiles; the owner of column K =
    // k + 1 updates that column first and then factors it and solves
    // panel K (the look-ahead). k = -1 is the look-ahead of column 0 alone.
    for (int k = -1; k + 1 < nb; ++k) {
      const int K = k + 1;
      const bool la = owner(K, P) == me;
      if (k >= 0) {
        // panel k from L (written by the look-ahead of the step before, in
        // either CTA), read through L2
        for (int e = tid; e < (n - K * kNb) * (kNb / 4); e += kThreads) {
          const int R = K * kNb + e / (kNb / 4), q = e % (kNb / 4);
          const float* p = Lm + static_cast<long long>(R) * n + k * kNb;
          const float4 v =
              vec ? __ldcg(reinterpret_cast<const float4*>(p) + q)
                  : make_float4(__ldcg(p + 4 * q), __ldcg(p + 4 * q + 1),
                                __ldcg(p + 4 * q + 2), __ldcg(p + 4 * q + 3));
          *reinterpret_cast<float4*>(smem + pq(R - kNb, q)) = v;
        }
        __syncthreads();
      }
      if (k >= 0 && la) {
        // column K first, every group
        update_tiles(Lm, smem, n, vec, nb, P, me, true, K, K, g, kGroups,
                     lt_id);
        __syncthreads();
      }
      if (la && warp < kLaWarps) {
        if (warp == 0) factor_diag(Lm, zm, n, K, vec, lt, inv, zk, failed);
        asm volatile("bar.sync 1, %0;" ::"n"(kLaWarps * 32) : "memory");
        solve_panel(Lm, zm, n, K, vec, lt, inv, zk, tid);
        __threadfence();
      } else if (k >= 0) {
        const int g0 = la ? kLaGroups : 0;
        const int J0 = first_own(K + 1, nb, P, me);
        update_tiles(Lm, smem, n, vec, nb, P, me, false, J0, J0, g - g0,
                     kGroups - g0, lt_id);
      }
      cluster.sync();
    }

    // every pivot has been taken: the cluster's flags, then no CTA leaves
    // or reuses its shared memory while another may still read it
    bool bad = false;
    for (int r = 0; r < P; ++r)
      bad |= *cluster.map_shared_rank(failed, r) != 0;
    cluster.sync();
    if (bad) {
      const float nan = __int_as_float(0x7fc00000);
      for (long long e = tid; e < static_cast<long long>(n) * nq;
           e += kThreads) {
        const int row = static_cast<int>(e / nq), col = 4 * (e % nq);
        if (owner(col / kNb, P) == me && col < n)
          store4(Lm, row, col, n, vec, make_float4(nan, nan, nan, nan));
      }
      if (zm && me == 0)
        for (int i = tid; i < n; i += kThreads) zm[i] = nan;
    }
  }
}

// the card's SM count and the shared memory a block may take, asked once
cudaError_t card(int* sms, int* max_smem) {
  static int s = 0, m = 0;
  if (s == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &m, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      s = 0;
      return err;
    }
  }
  *sms = s;
  *max_smem = m;
  return cudaSuccess;
}

}  // namespace

// The plan bchol_launch makes for b matrices of n x n on this card, into
// out: P, dynamic shared memory bytes. Returns -1 where no plan
// takes the shape, else the cudaError_t of asking the card.
extern "C" int bchol_plan(int b, int n, int* out) {
  int sms = 0, max_smem = 0;
  const cudaError_t err = card(&sms, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  if (!plan(b, n, sms, max_smem, &p)) return -1;
  out[0] = p.P;
  out[1] = static_cast<int>(p.smem);
  return 0;
}

// a: [b, n, n] (only the lower triangle is read), y: [b, n] or null,
// L: [b, n, n], z: [b, n] (ignored when y is null); all float32 and
// contiguous. The launch is bchol_plan's (written to plan_out, if not
// null): clusters of P CTAs, each cluster looping over the matrices it
// is given. Returns -1 where the plan does not take the shape, -2 where
// the card has no room for one cluster (cudaOccupancyMaxActiveClusters),
// else the cudaError_t of the launch (0 on success).
extern "C" int bchol_launch(const void* a, const void* y, void* L, void* z,
                            int b, int n, void* stream, int* plan_out) {
  if (b <= 0 || n <= 0) return 0;
  int sms = 0, max_smem = 0;
  cudaError_t err = card(&sms, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  if (!plan(b, n, sms, max_smem, &p)) return -1;
  if (plan_out) {
    plan_out[0] = p.P;
    plan_out[1] = static_cast<int>(p.smem);
  }
  const int smem = static_cast<int>(p.smem);
  static int attr_smem = 0;             // the largest size set so far
  if (smem > attr_smem) {
    err = cudaFuncSetAttribute(bchol_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_smem = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.P, b < 65535 ? b : 65535);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the occupancy query, once for each (P, smem) in turn
  static int checked_p = 0, checked_smem = 0;
  if (p.P != checked_p || smem != checked_smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, bchol_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return -2;
    checked_p = p.P;
    checked_smem = smem;
  }
  err = cudaLaunchKernelEx(&cfg, bchol_kernel, static_cast<const float*>(a),
                           static_cast<const float*>(y),
                           static_cast<float*>(L), static_cast<float*>(z), b,
                           n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
