// Kernel B7: the Cholesky factor L = chol(A) of one SPD matrix (or of each
// matrix of a batch), on one thread-block cluster a matrix, the factor
// held in the cluster's shared memory from the first read of A to the
// one write of L. The route for n <= 480; above, csrc/chol_coop.cu
// (ops/pallas_chol.py::plan picks the route from n before the launch).
//
// Replaces bipymc_tpu/ops/pallas_chol.py::cholesky_pallas (:188; the
// pallas_call in _chol_fwd_impl at :154, kernel body _make_kernel :46).
// Plain version: bipymc_tpu_torch/ops/pallas_chol.py::cholesky_plain
// (torch.linalg.cholesky_ex, NaN where info != 0). The gradient is the
// shared Cholesky adjoint, in PyTorch (ops/pallas_chol.py::chol_adjoint).
//
// A matrix whose factorisation meets a pivot that is not > 0 (or is NaN)
// comes back all NaN: each CTA flags the pivots it takes, the flags are
// read across the cluster after the last column, and the launch never
// traps or stops early.
//
// What bounds it on the H100: the chain of dependent steps, not bytes or
// FLOPs. At the GP's config-5 shape, one 256 x 256 matrix, the work is
// 256^3 / 3 = 5.6 M FMAs (11 MFLOP, 0.17 us at 67 TFLOP/s) and the bytes
// 2 x 256 KB (0.16 us at 3.35 TB/s); but the 8 panels of 32 columns come
// in order, and the 256 columns within them too. The cooperative design
// that came first (csrc/chol_coop.cu) took 0.089 ms there, against
// cholesky_ex's 0.069 (PERF.md): each panel step was a grid barrier
// through an atomic counter in L2 that up to 28 blocks waited at, the
// step's data went through L2 (the panel to scratch and back, each
// trailing tile read and written back), every block refactored the
// diagonal block in one warp while seven waited, and the wrapper's zeros
// for the counters were a launch of their own. This design:
// - one cluster of P CTAs a matrix (P = min(nb, 8), nb = ceil(n / 32),
//   the portable size), launched with cudaLaunchKernelEx; block row I of
//   the lower triangle's 32 x 32 tiles lives in the shared memory of CTA
//   owner(I), the rows dealt in a snake (0..P-1, P-1..0, ...) so the
//   CTAs' triangles are near equal (36 tiles, 4.5 KB each, at n = 256:
//   one block row a CTA);
// - A's lower triangle is read from device memory once (16-byte loads,
//   every one from a valid address and masked after, so that none waits
//   on another), L written once at the end, the strict upper triangle as
//   zeros; no scratch, no counters, nothing else touches device memory;
// - a panel step k is one cluster barrier (barrier.cluster, in hardware):
//   before it, each CTA solves its panel tiles (I, k) against L_kk^T and
//   pushes each into the shared memory of every CTA whose rows need it
//   (remote stores through distributed shared memory, into a slot of the
//   step's parity); the owner of row k+1 then updates tile (k+1, k+1)
//   with its own panel row, factors it (the look-ahead) and pushes L^T of
//   it and its reciprocal square roots to every CTA the same way. After
//   the barrier each CTA updates its own trailing tiles from what it
//   holds, the next panel row first. The critical path is the diagonal
//   tiles' 256 dependent columns, one panel solve and two tile updates a
//   step, and 8 barriers;
// - the diagonal tile is factored by one warp, right-looking, lane i
//   holding row i in registers: a column takes its pivot by shuffle, the
//   reciprocal square root (rsqrtf, within 2 ulp) and multiplies, and the
//   panel solve multiplies by the same reciprocals, which keeps IEEE
//   square roots and divisions off the dependent chain; the next pivot is
//   updated from the lane's own values, and the column reaches the other
//   lanes through its row of L^T in shared memory, read as float4s;
// - a panel tile is solved by four warps, four threads a row with 8
//   columns each: the thread holding a block of 8 columns substitutes
//   through them and passes them by shuffle to the row's threads right of
//   it, so each entry takes the updates of the columns before it in
//   order, as one thread substituting would;
// - a trailing tile C -= A B^T takes a quarter of the block, 64 threads
//   with 4 x 4 outputs each (the four quarters take four tiles at once),
//   and the look-ahead's one tile the whole block, 2 x 2 outputs a
//   thread; both operands as float4 reads of rows padded to 36 floats (8
//   rows read together fall in 8 different groups of 4 banks), full
//   float32 FMAs summed over the panel's 32 columns in order. No TF32:
//   config 5's Gram matrices reach cond 8.3e5;
// - no lane of a warp on the chain waits on another's branch: per-lane
//   choices are selects, and stores that one lane could make are made by
//   all with the same value.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNb = 32;                 // tile size and panel width
constexpr int kLd = kNb + 4;            // a tile row in shared memory
constexpr int kTile = kNb * kLd;        // floats a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxNb = 16;             // block rows: n <= 512
constexpr unsigned kFull = 0xffffffffu;

// the CTA of the cluster that holds block row I
__host__ __device__ __forceinline__ int owner(int I, int P) {
  const int g = I / P, r = I % P;
  return (g & 1) ? P - 1 - r : r;
}

// the offset (floats) of tile (I, J), J <= I, in the shared memory of
// owner(I): its block rows in order, each its I + 1 tiles
__device__ __forceinline__ int tile_off(int I, int J, int P) {
  const int c = owner(I, P), g = I / P;
  int base = 0;
  for (int h = 0; h < g; ++h) base += h * P + ((h & 1) ? P - 1 - c : c) + 1;
  return (base + J) * kTile;
}

__device__ __forceinline__ void load_row(const float* p, float (&r)[kNb]) {
#pragma unroll
  for (int q = 0; q < kNb; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + q);
    r[q] = v.x; r[q + 1] = v.y; r[q + 2] = v.z; r[q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_row(float* p, const float (&r)[kNb]) {
#pragma unroll
  for (int q = 0; q < kNb; q += 4)
    *reinterpret_cast<float4*>(p + q) =
        make_float4(r[q], r[q + 1], r[q + 2], r[q + 3]);
}

// One warp: the diagonal tile T = chol(T) in place, L^T into lt and the
// columns' reciprocal square roots into inv; a pivot that is not > 0
// sets *failed. Lane i holds row i; column j goes to the other lanes
// through row j of lt (L^T), read as float4s.
__device__ __forceinline__ void factor_diag(float* T, float* lt, float* inv,
                                            int* failed) {
  const int i = threadIdx.x % 32;
  float r[kNb];
  load_row(T + i * kLd, r);
#pragma unroll
  for (int q = 0; q < kNb; ++q) r[q] = q <= i ? r[q] : 0.f;
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
  // them to 0; the tile's strict upper triangle is 0 from here on
  store_row(T + i * kLd, r);
}

// Four warps (128 threads): the panel tile X (in place) solves X L^T = A,
// L the diagonal tile given as lt = L^T and inv = 1 / diag(L). Row r is
// four threads, each with 8 columns in registers; in block b of 8
// columns the thread holding them substitutes through them, passes the 8
// solved values to the row's other threads by shuffle, and those to its
// right subtract them from theirs: each column takes the updates of the
// columns before it in order, as one thread substituting would. Every
// lane runs both parts and keeps its own result by a select, so that no
// lane waits on another's branch.
__device__ __forceinline__ void solve_panel(float* T, const float* lt,
                                            const float* inv) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row = (threadIdx.x % 128) / 4, c0 = 8 * t;
  float a[8];
#pragma unroll
  for (int v = 0; v < 8; v += 4) {
    const float4 x = *reinterpret_cast<const float4*>(T + row * kLd + c0 + v);
    a[v] = x.x; a[v + 1] = x.y; a[v + 2] = x.z; a[v + 3] = x.w;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float s[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] = a[u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float x = s[u] * inv[8 * b + u];
      s[u] = x;
#pragma unroll
      for (int v = u + 1; v < 8; ++v)
        s[v] = fmaf(-x, lt[(8 * b + u) * kLd + 8 * b + v], s[v]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = t == b ? s[u] : a[u];
    float xs[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      xs[u] = __shfl_sync(kFull, a[u], (lane & ~3) | b);
    float w[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) w[v] = a[v];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* l = lt + (8 * b + u) * kLd + c0;
      const float4 l0 = *reinterpret_cast<const float4*>(l);
      const float4 l1 = *reinterpret_cast<const float4*>(l + 4);
      w[0] = fmaf(-xs[u], l0.x, w[0]);
      w[1] = fmaf(-xs[u], l0.y, w[1]);
      w[2] = fmaf(-xs[u], l0.z, w[2]);
      w[3] = fmaf(-xs[u], l0.w, w[3]);
      w[4] = fmaf(-xs[u], l1.x, w[4]);
      w[5] = fmaf(-xs[u], l1.y, w[5]);
      w[6] = fmaf(-xs[u], l1.z, w[6]);
      w[7] = fmaf(-xs[u], l1.w, w[7]);
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) a[v] = t > b ? w[v] : a[v];
  }
#pragma unroll
  for (int v = 0; v < 8; v += 4)
    *reinterpret_cast<float4*>(T + row * kLd + c0 + v) =
        make_float4(a[v], a[v + 1], a[v + 2], a[v + 3]);
}

// 64 threads (a quarter of the block, g = threadIdx.x / 64): C -= A B^T
// over 32 x 32 tiles; thread (ty, tx) of the group's 8 x 8 takes rows
// ty + 8u and columns tx + 8v, u, v < 4: 8 float4 reads for 64 FMAs.
__device__ __forceinline__ void update_tile(float* C, const float* A,
                                            const float* B) {
  const int ty = (threadIdx.x % 64) / 8, tx = threadIdx.x % 8;
  float acc[4][4] = {};
#pragma unroll
  for (int q = 0; q < kNb; q += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      av[h] = *reinterpret_cast<const float4*>(A + (ty + 8 * h) * kLd + q);
      bv[h] = *reinterpret_cast<const float4*>(B + (tx + 8 * h) * kLd + q);
    }
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
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      C[(ty + 8 * u) * kLd + tx + 8 * v] -= acc[u][v];
}

// All threads: C -= A B^T for one tile, the look-ahead's; thread (ty, tx)
// takes rows ty, ty + 16 and columns tx, tx + 16.
__device__ __forceinline__ void update_one_tile(float* C, const float* A,
                                                const float* B) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[2][2] = {};
#pragma unroll
  for (int q = 0; q < kNb; q += 4) {
    float4 av[2], bv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      av[h] = *reinterpret_cast<const float4*>(A + (ty + 16 * h) * kLd + q);
      bv[h] = *reinterpret_cast<const float4*>(B + (tx + 16 * h) * kLd + q);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        acc[u][v] = fmaf(av[u].x, bv[v].x, acc[u][v]);
        acc[u][v] = fmaf(av[u].y, bv[v].y, acc[u][v]);
        acc[u][v] = fmaf(av[u].z, bv[v].z, acc[u][v]);
        acc[u][v] = fmaf(av[u].w, bv[v].w, acc[u][v]);
      }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      C[(ty + 16 * u) * kLd + tx + 16 * v] -= acc[u][v];
}

// Own block rows of a's lower triangle into shared memory: zero beyond n,
// with 1 on the diagonal of the last tile's rows beyond n.
__device__ void load_rows(const float* __restrict__ A, float* own, int n,
                          int nb, int P, int me, bool vec) {
  for (int g = 0, base = 0;; ++g) {
    const int I = g * P + ((g & 1) ? P - 1 - me : me);
    if (I >= nb) break;
    const int cnt = (I + 1) * (kNb * kNb / 4);      // float4s of the row
    for (int e0 = threadIdx.x; e0 < cnt; e0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        const int J = e / (kNb * kNb / 4), w = e % (kNb * kNb / 4);
        const int row = I * kNb + w / 8, col = J * kNb + 4 * (w % 8);
        // every load from a valid address, the masks after: a load under
        // a condition would wait for the one before it
        const float* src = A + static_cast<long long>(min(row, n - 1)) * n;
        float t[4];
        if (vec) {
          const float4 x = __ldg(
              reinterpret_cast<const float4*>(src + min(col, n - 4)));
          t[0] = x.x; t[1] = x.y; t[2] = x.z; t[3] = x.w;
        } else {
#pragma unroll
          for (int h = 0; h < 4; ++h) t[h] = __ldg(src + min(col + h, n - 1));
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bool in = e < cnt && row < n && col + h < n;
          t[h] = in ? t[h] : (row >= n && col + h == row ? 1.f : 0.f);
        }
        v[u] = make_float4(t[0], t[1], t[2], t[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        if (e < cnt) {
          const int J = e / (kNb * kNb / 4), w = e % (kNb * kNb / 4);
          *reinterpret_cast<float4*>(own + (base + J) * kTile +
                                     (w / 8) * kLd + 4 * (w % 8)) = v[u];
        }
      }
    }
    base += I + 1;
  }
}

// Own block rows of L into device memory, whole rows: the tiles left of
// the diagonal, its lower triangle, zeros right of it; all NaN if bad.
__device__ void store_rows(float* __restrict__ Lm, const float* own, int n,
                           int nb, int P, int me, bool vec, bool bad) {
  const float nan = __int_as_float(0x7fc00000);
  for (int g = 0, base = 0;; ++g) {
    const int I = g * P + ((g & 1) ? P - 1 - me : me);
    if (I >= nb) break;
    const int rows = min(kNb, n - I * kNb);
    const int per_row = vec ? n / 4 : n;
    for (int rr = threadIdx.x / 32; rr < rows; rr += kWarps) {
      const int row = I * kNb + rr;
      for (int e = threadIdx.x % 32; e < per_row; e += 32) {
        const int col0 = vec ? 4 * e : e;
        float t[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int col = col0 + h, J = col / kNb;
          t[h] = J < I || (J == I && col <= row)
                     ? own[(base + J) * kTile + rr * kLd + col % kNb]
                     : 0.f;
          if (bad) t[h] = nan;
        }
        float* dst = Lm + static_cast<long long>(row) * n + col0;
        if (vec)
          *reinterpret_cast<float4*>(dst) =
              make_float4(t[0], t[1], t[2], t[3]);
        else
          *dst = t[0];
      }
    }
    base += I + 1;
  }
}

__global__ void __launch_bounds__(kThreads)
chol_kernel(const float* __restrict__ a, float* __restrict__ L, int c_total,
            int n, int own_tiles) {
  extern __shared__ float4 smem_[];
  const int nb = (n + kNb - 1) / kNb;
  float* const own = reinterpret_cast<float*>(smem_);  // own block rows
  float* const panel = own + own_tiles * kTile;  // [2][nb]: L_Jk pushed in
  float* const lt = panel + 2 * nb * kTile;      // [2]: L_kk^T by parity
  float* const inv = lt + 2 * kTile;             // [2][32]: 1 / diag(L_kk)
  __shared__ int failed;
  __shared__ int row_owner[kMaxNb];     // owner(I)
  __shared__ int row_base[kMaxNb];      // block row I's first tile there
  __shared__ int cta_last[kMaxCluster];  // each CTA's last block row

  cg::cluster_group cluster = cg::this_cluster();
  const int P = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32;
  const int rr = tid / 8, c4 = 4 * (tid % 8);   // a float4 of a tile
  int last = -1;                                // this CTA's last row
  for (int I = 0; I < nb; ++I)
    if (owner(I, P) == me) last = I;
  if (tid < nb) {
    row_owner[tid] = owner(tid, P);
    row_base[tid] = tile_off(tid, 0, P) / kTile;
  }
  if (tid < P) {
    cta_last[tid] = -1;
    for (int I = 0; I < nb; ++I)
      if (owner(I, P) == tid) cta_last[tid] = I;
  }
  // tile (I, J) in the shared memory of I's owner (this CTA's own if it
  // holds row I)
  auto tile = [&](int I, int J) { return own + (row_base[I] + J) * kTile; };

  for (int c = blockIdx.y; c < c_total; c += gridDim.y) {
    const float* A = a + static_cast<long long>(c) * n * n;
    float* Lm = L + static_cast<long long>(c) * n * n;
    const bool vec = n % 4 == 0 &&
                     (reinterpret_cast<unsigned long long>(A) & 15) == 0 &&
                     (reinterpret_cast<unsigned long long>(Lm) & 15) == 0;
    if (tid == 0) failed = 0;
    load_rows(A, own, n, nb, P, me, vec);
    __syncthreads();

    // the diagonal tile k's L^T and reciprocals, from the CTA that
    // factored it into every other CTA's buffer of parity k & 1
    auto push = [&](int k) {
      float* src_lt = lt + (k & 1) * kTile;
      float* src_inv = inv + (k & 1) * kNb;
      const float4 v =
          *reinterpret_cast<const float4*>(src_lt + rr * kLd + c4);
      const float w = tid < kNb ? src_inv[tid] : 0.f;
      for (int r = 0; r < P; ++r) {
        if (r == me) continue;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(src_lt, r) +
                                   rr * kLd + c4) = v;
        if (tid < kNb) cluster.map_shared_rank(src_inv, r)[tid] = w;
      }
    };
    auto factor = [&](int k) {
      if (warp == 0)
        factor_diag(tile(k, k), lt + (k & 1) * kTile, inv + (k & 1) * kNb,
                    &failed);
      __syncthreads();
      push(k);
    };
    if (row_owner[0] == me) factor(0);
    cluster.sync();

    for (int k = 0; k + 1 < nb; ++k) {
      const float* ltk = lt + (k & 1) * kTile;
      const float* invk = inv + (k & 1) * kNb;
      // ---- the panel: own tiles (I, k), I > k, four warps a tile -----
      for (int I = k + 1, w = 0; I <= last; ++I) {
        if (row_owner[I] != me) continue;
        if (w % 2 == warp / 4) solve_panel(tile(I, k), ltk, invk);
        ++w;
      }
      __syncthreads();
      // each solved tile to the CTAs whose rows need it (those holding a
      // row >= I), into their slot of parity k & 1
      for (int I = k + 1; I <= last; ++I) {
        if (row_owner[I] != me) continue;
        const float4 v =
            *reinterpret_cast<const float4*>(tile(I, k) + rr * kLd + c4);
        float* dst = panel + ((k & 1) * nb + I) * kTile + rr * kLd + c4;
        for (int r = 0; r < P; ++r)
          if (r != me && cta_last[r] >= I)
            *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, r)) = v;
      }
      // ---- the look-ahead: tile (k+1, k+1) updated by its panel row and
      // factored, before the cluster waits on it
      if (row_owner[k + 1] == me) {
        update_one_tile(tile(k + 1, k + 1), tile(k + 1, k), tile(k + 1, k));
        __syncthreads();
        factor(k + 1);
      }
      cluster.sync();
      // ---- the trailing update with panel column k: own tiles (I, J),
      // k < J <= I, but (k+1, k+1), a quarter of the block each, rows in
      // order so the row of the next look-ahead comes first
      const float* pk = panel + (k & 1) * nb * kTile;
      for (int I = k + 2, w = 0; I <= last; ++I) {
        if (row_owner[I] != me) continue;
        for (int J = k + 1; J <= I; ++J, ++w) {
          if (w % 4 != warp / 2) continue;
          const float* B = row_owner[J] == me ? tile(J, k) : pk + J * kTile;
          update_tile(tile(I, J), tile(I, k), B);
        }
      }
      // (the next step's panel solve reads these tiles after this barrier)
      __syncthreads();
    }

    // every pivot has been taken: the cluster's flags, then no CTA leaves
    // or reuses its shared memory while another may still read it
    bool bad = false;
    for (int r = 0; r < P; ++r)
      bad |= *cluster.map_shared_rank(&failed, r) != 0;
    cluster.sync();
    store_rows(Lm, own, n, nb, P, me, vec, bad);
    __syncthreads();
  }
}

// the most tiles one CTA of a P-CTA cluster holds: the I + 1 tiles of each
// block row I that owner() deals it, as the kernel lays them out
int own_tiles_of(int nb, int P) {
  int most = 0;
  for (int r = 0; r < P; ++r) {
    int tiles = 0;
    for (int I = 0; I < nb; ++I)
      if (owner(I, P) == r) tiles += I + 1;
    most = tiles > most ? tiles : most;
  }
  return most;
}

}  // namespace

// a: [c, n, n] (only the lower triangle is read), L: [c, n, n], both
// contiguous float32. The launch is derived here from n alone, with the
// kernel's own owner(): P = min(nb, 8) CTAs a matrix, and a CTA's dynamic
// shared memory, (own_tiles + 2 nb + 2) tiles of 32 x 36 floats and 64
// floats, own_tiles the most tiles one CTA holds; it fits for n <= 480
// (ops/pallas_chol.py::plan, which picks this route there, mirrors it).
// Clusters of a batch loop over its matrices. Returns -1 if that shared
// memory exceeds what a block may take, -2 if the card cannot hold one
// such cluster (cudaOccupancyMaxActiveClusters), else the cudaError_t of
// the launch.
extern "C" int chol_launch(const void* a, void* L, int c, int n,
                           void* stream) {
  if (c <= 0 || n <= 0) return 0;
  const int nb = (n + kNb - 1) / kNb;
  if (nb > kMaxNb) return -1;
  const int P = nb < kMaxCluster ? nb : kMaxCluster;
  const int own_tiles = own_tiles_of(nb, P);
  const int smem = static_cast<int>(
      ((own_tiles + 2 * nb + 2) * kTile + 2 * kNb) * sizeof(float));
  static int max_smem = 0;              // the card's, asked once
  cudaError_t err = cudaSuccess;
  if (max_smem == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > max_smem) return -1;
  static int attr_smem = 0;             // the largest size set so far
  if (smem > attr_smem) {
    err = cudaFuncSetAttribute(chol_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_smem = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, c < 65535 ? c : 65535);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the occupancy query, once for each (P, smem) in turn
  static int checked_p = 0, checked_smem = 0;
  if (P != checked_p || smem != checked_smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, chol_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return -2;
    checked_p = P;
    checked_smem = smem;
  }
  const float* a_ = static_cast<const float*>(a);
  float* L_ = static_cast<float*>(L);
  err = cudaLaunchKernelEx(&cfg, chol_kernel, a_, L_, c, n, own_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
