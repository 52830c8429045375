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
// comes back all NaN, L and z: the launch never traps or stops early,
// and the sampler then rejects that chain, as it rejects the reference's
// rsqrt of a negative pivot.
//
// What bounds it on the H100: the chain of dependent columns. At the GP's
// config-4 shape, 64 matrices of 512 x 512, the work is 64 x 512^3 / 3 =
// 2.86 G FMAs (5.73 GFLOP, ~0.086 ms at 67 TFLOP/s) and the bytes
// 2 x 67 MB (~0.040 ms at 3.35 TB/s); but column j cannot start before
// columns < j are done, and one block works on one matrix, so the kernel
// is bound by 16 panel steps, each a serial 32-column factorisation of the
// diagonal block, a row-wise triangular solve of the panel below it and a
// trailing update. The design (simple first; wgmma, TMA and clusters are
// later work):
// - one block of 512 threads per matrix; L is factored in place in the
//   output, in global memory (a 512^2 matrix is 1 MB, beyond shared
//   memory), right-looking with panels of 32 columns;
// - the 32 x 32 diagonal block is factored by one warp, left-looking:
//   lane i holds row i in registers and reads row j's values by shuffle
//   (IEEE sqrtf and division, no fast math); the block's piece of z the
//   same way;
// - the panel below it is solved one row per thread, the row's 32 values
//   in registers, and written to L and to shared memory (rows padded to
//   36 floats: 480 x 36 floats, 69 KB at n = 512); the same thread
//   updates that row's z;
// - the trailing update A -= P P^T, lower triangle only, in 32 x 32 tiles
//   that eight 64-thread groups take in turn with no barrier between
//   tiles: each thread keeps a 4 x 4 block of outputs in registers, both
//   operands come from the panel in shared memory as float4 reads (8
//   loads for 64 FMAs), the products are full float32 FMAs summed over
//   the panel's 32 columns in order, and each output is read and written
//   once in global memory per panel step.

#include <cuda_runtime.h>

namespace {

constexpr int kNb = 32;                       // panel width
constexpr int kThreads = 512;
constexpr int kTileThreads = 64;              // a 32 x 32 trailing tile
constexpr int kTiles = kThreads / kTileThreads;
// a panel row, padded to 36 floats: 16-byte aligned for float4 reads, and
// 8 rows read together fall in 8 different groups of 4 banks
constexpr int kLd = kNb + 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 1)
bchol_kernel(const float* __restrict__ a, const float* __restrict__ y,
             float* L, float* z, int n) {
  extern __shared__ float4 panel4[];  // [round_up(n - kNb, kNb)][kLd]
  float* panel = reinterpret_cast<float*>(panel4);
  __shared__ float diag[kNb][kNb + 1];
  __shared__ float zk[kNb];
  __shared__ int failed;

  const long long nn = static_cast<long long>(n) * n;
  const float* A = a + blockIdx.x * nn;
  float* Lm = L + blockIdx.x * nn;
  const float* ym = y ? y + static_cast<long long>(blockIdx.x) * n : nullptr;
  float* zm = y ? z + static_cast<long long>(blockIdx.x) * n : nullptr;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  if (tid == 0) failed = 0;
  // the lower triangle of A into L; the strict upper triangle is zero
  for (int i = warp; i < n; i += kThreads / 32) {
    const long long off = static_cast<long long>(i) * n;
    for (int j = lane; j < n; j += 32)
      Lm[off + j] = j <= i ? A[off + j] : 0.f;
  }
  if (zm)
    for (int i = tid; i < n; i += kThreads) zm[i] = ym[i];
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += kNb) {
    const int kb = min(kNb, n - k0);
    const int r0 = k0 + kNb;                 // first row below the block

    // ---- 1. the diagonal block, by warp 0, lane i holding row i --------
    if (warp == 0) {
      const int i = lane;
      float r[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c)
        r[c] = (i < kb && c <= i)
                   ? Lm[static_cast<long long>(k0 + i) * n + k0 + c] : 0.f;
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        if (j < kb) {                        // uniform across the warp
          float s = r[j];
#pragma unroll
          for (int p = 0; p < j; ++p)
            s = fmaf(-r[p], __shfl_sync(kFull, r[p], j), s);
          const float d = __shfl_sync(kFull, s, j);
          const float piv = sqrtf(d);
          if (i == 0 && !(d > 0.f)) failed = 1;
          r[j] = i == j ? piv : (i > j ? s / piv : 0.f);
        }
      }
      if (zm) {
        float zi = i < kb ? zm[k0 + i] : 0.f;
#pragma unroll
        for (int j = 0; j < kNb; ++j) {
          if (j < kb) {
            const float zj = __shfl_sync(kFull, zi, j) /
                             __shfl_sync(kFull, r[j], j);
            zi = i == j ? zj : (i > j ? fmaf(-r[j], zj, zi) : zi);
          }
        }
        zk[i] = zi;
        if (i < kb) zm[k0 + i] = zi;
      }
      if (i < kb) {
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          diag[i][c] = r[c];
          if (c <= i) Lm[static_cast<long long>(k0 + i) * n + k0 + c] = r[c];
        }
      }
    }
    __syncthreads();
    if (r0 >= n) break;                      // the last block: done

    // ---- 2. the panel: rows r0.. solved against the block, one a thread.
    // The block is read through a volatile pointer: its 528 values are
    // the same for every row, and hoisting them out of the row loop into
    // registers would spill.
    const volatile float* dg = &diag[0][0];  // row stride kNb + 1
    const volatile float* zk_v = zk;
    for (int i = r0 + tid; i < n; i += kThreads) {
      float* row = Lm + static_cast<long long>(i) * n + k0;
      float* prow = panel + (i - r0) * kLd;
      float x[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c) x[c] = row[c];
#pragma unroll
      for (int c = 0; c < kNb; ++c) {
        float s = x[c];
#pragma unroll
        for (int p = 0; p < c; ++p)
          s = fmaf(-x[p], dg[c * (kNb + 1) + p], s);
        x[c] = s / dg[c * (kNb + 1) + c];
        row[c] = x[c];
        prow[c] = x[c];
      }
      if (zm) {
        float s = zm[i];
#pragma unroll
        for (int c = 0; c < kNb; ++c) s = fmaf(-x[c], zk_v[c], s);
        zm[i] = s;
      }
    }
    __syncthreads();

    // ---- 3. the trailing update, lower triangle, tile (I, J) with J <= I:
    // eight tiles at a time, 64 threads a tile, 4 x 4 outputs a thread
    // (rows tr + 8i, columns tc + 8j), operands read 4 columns at a time
    const int T = (n - r0 + kNb - 1) / kNb;
    const int n_tiles = T * (T + 1) / 2;
    const int g = tid / kTileThreads, lt = tid % kTileThreads;
    const int tr = lt / 8, tc = lt % 8;
    for (int t = g; t < n_tiles; t += kTiles) {
      int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((I + 1) * (I + 2) / 2 <= t) ++I;
      while (I * (I + 1) / 2 > t) --I;
      const int J = t - I * (I + 1) / 2;
      const float* pa = panel + (I * kNb + tr) * kLd;
      const float* pb = panel + (J * kNb + tc) * kLd;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int p = 0; p < kNb; p += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = *reinterpret_cast<const float4*>(pa + i * 8 * kLd + p);
          bv[i] = *reinterpret_cast<const float4*>(pb + i * 8 * kLd + p);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + I * kNb + tr + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = r0 + J * kNb + tc + 8 * j;
          if (row < n && col <= row) {
            float* dst = Lm + static_cast<long long>(row) * n + col;
            *dst = *dst - acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }

  __syncthreads();
  if (failed) {
    const float nan = __int_as_float(0x7fc00000);
    for (long long e = tid; e < nn; e += kThreads) Lm[e] = nan;
    if (zm)
      for (int i = tid; i < n; i += kThreads) zm[i] = nan;
  }
}

}  // namespace

// a: [b, n, n] (only the lower triangle is read), y: [b, n] or null,
// L: [b, n, n], z: [b, n] (ignored when y is null); all float32 and
// contiguous. The panel, round_up(n - 32, 32) x 36 floats, lives in
// shared memory, which bounds n at 1600. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bchol_launch(const void* a, const void* y, void* L, void* z,
                            int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const int rows = (n - 1) / kNb * kNb;      // round_up(n - 32, 32)
  const int smem = (rows > 0 ? rows : 1) * kLd * static_cast<int>(
      sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      bchol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bchol_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<float*>(L), static_cast<float*>(z), n);
  return static_cast<int>(cudaGetLastError());
}
