// Kernel B8: blocked triangular solves with a lower-triangular L,
// forward (L x = b) and backward (L^T y = c) substitution.
//
// Replaces bipymc_tpu/ops/pallas_solve.py::tri_solve (:181) and
// tri_solve_t (:189), both _solve_impl (:118, the pallas_call at :165,
// kernel bodies _fwd_kernel :79 and _bwd_kernel :95). Plain versions:
// bipymc_tpu_torch/ops/pallas_solve.py::tri_solve_plain and
// tri_solve_t_plain (torch.linalg.solve_triangular). Each direction's
// gradient launches the other direction of this kernel
// (ops/pallas_solve.py), as the reference's VJPs call its other kernel.
//
// What bounds it on the H100: the chain of dependent block rows. At the
// GP's config-5 shapes, L 256 x 256 with b [256] (Adam and fit) or
// [256, 1024] (the surrogate's variance, a DREAM generation), the work is
// n^2 m / 2 FMAs (34 M at m = 1024, 67 MFLOP: 1.0 us at 67 TFLOP/s) and
// the bytes 256 KB of L plus 2 x 1 MB of b and x (0.7 us at 3.35 TB/s);
// but row block i needs every solved block before it. The design (simple
// first):
// - independent right-hand-side columns go to independent blocks, 8 to a
//   block (m = 1024: 128 blocks), a batch axis to gridDim.y: the
//   reference's parallel m-tile axis. A loop over the 32-row blocks inside
//   the block replaces its sequential grid axis;
// - the block's 8 columns of b, all n rows, stay in shared memory from
//   the first load to the last store (rows padded to 9 floats);
// - the kernel solves each 32 x 32 diagonal block itself, one warp a
//   column, lane r holding row r and reading the solved values by
//   shuffle; each lane inverts its pivot once (IEEE division) and the
//   substitution multiplies, which keeps a division off the 32-step
//   dependent chain (PERF.md; the reference instead precomputes the
//   diagonal blocks' inverses in XLA and multiplies);
// - then it subtracts the solved block from every block row still to
//   solve (right-looking): the 8 warps take those block rows in turn, each
//   lane one row and the 8 columns, its 32 values of L read through a
//   32 x 32 tile of the warp's own in shared memory where the rows of L
//   are the block's rows (forward: one coalesced row a load) and straight
//   from global memory where they are its columns (transposed), the
//   solved values from shared memory, full float32 FMAs in order; the
//   next diagonal block is fetched into registers meanwhile;
// - the ragged edges are masked in the kernel: rows beyond n solve against
//   an identity block and are never stored, columns beyond m are zero and
//   never stored, so every column of the last partial tile is written.

#include <cuda_runtime.h>

namespace {

constexpr int kBs = 32;                 // block rows
constexpr int kTm = 8;                  // right-hand-side columns a block
constexpr int kThreads = 256;           // 8 warps: one a column
constexpr int kXld = kTm + 1;           // row stride of X in shared memory
constexpr int kLd = kBs + 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPer = kBs * kBs / kThreads;   // diagonal values a thread

static_assert(kThreads / 32 == kTm, "one warp a column");

__global__ void __launch_bounds__(kThreads)
trisolve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                float* __restrict__ x, int n, int m, long long l_stride,
                int transposed) {
  extern __shared__ float X[];          // [n_pad][kXld]
  __shared__ float Ld[kBs][kLd];        // the diagonal block
  __shared__ float Lw[kThreads / 32][kBs][kLd];   // a warp's block of L
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * kTm;
  const float* Lm = L + blockIdx.y * l_stride;
  const long long bm_off = static_cast<long long>(blockIdx.y) * n * m;
  const float* bm = b + bm_off;
  float* xm = x + bm_off;
  const int nb = (n + kBs - 1) / kBs;

  // the block's columns of b, zero beyond n and m
  for (int e = tid; e < nb * kBs * kTm; e += kThreads) {
    const int r = e / kTm, q = e % kTm;
    X[r * kXld + q] = (r < n && c0 + q < m)
        ? bm[static_cast<long long>(r) * m + c0 + q] : 0.f;
  }
  // diagonal block i's value number k of this thread (identity beyond n)
  auto diag_value = [&](int i, int k) {
    const int e = tid + k * kThreads, rr = e / kBs, q = e % kBs;
    const int o = i * kBs;
    return (o + rr < n && o + q < n)
        ? Lm[static_cast<long long>(o + rr) * n + o + q]
        : (rr == q ? 1.f : 0.f);
  };
  float dnext[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    dnext[k] = diag_value(transposed ? nb - 1 : 0, k);

  for (int s = 0; s < nb; ++s) {
    const int i = transposed ? nb - 1 - s : s;
    const int o = i * kBs;
    __syncthreads();                    // X written, Ld free
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      Ld[e / kBs][e % kBs] = dnext[k];
    }
    __syncthreads();

    // ---- the diagonal block: warp w solves column w, lane r row r ------
    {
      float v = X[(o + lane) * kXld + warp];
      // the lane's pivot, inverted once: not a division on the chain
      const float rinv = 1.f / Ld[lane][lane];
      if (!transposed) {
#pragma unroll
        for (int q = 0; q < kBs; ++q) {
          const float xq = __shfl_sync(kFull, v * rinv, q);
          v = lane == q ? xq : (lane > q ? fmaf(-Ld[lane][q], xq, v) : v);
        }
      } else {
#pragma unroll
        for (int q = kBs - 1; q >= 0; --q) {
          const float xq = __shfl_sync(kFull, v * rinv, q);
          v = lane == q ? xq : (lane < q ? fmaf(-Ld[q][lane], xq, v) : v);
        }
      }
      X[(o + lane) * kXld + warp] = v;
    }
    if (s + 1 < nb) {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        dnext[k] = diag_value(transposed ? i - 1 : i + 1, k);
    }
    __syncthreads();

    // ---- the block rows still to solve, one a warp at a time -----------
    // forward: block rows j > i, X_j -= L[j, i] X_i;
    // transposed: block rows j < i, X_j -= L[i, j]^T X_i
    const int j_lo = transposed ? 0 : i + 1, j_hi = transposed ? i : nb;
    for (int j = j_lo + warp; j < j_hi; j += kThreads / 32) {
      const int row = j * kBs + lane;
      float lv[kBs];
      if (!transposed) {
        // L[j rows, i cols], staged through the warp's tile so that a
        // load reads one row's 32 neighbouring values
        float(*w)[kLd] = Lw[warp];
#pragma unroll 8
        for (int r = 0; r < kBs; ++r)
          w[r][lane] = j * kBs + r < n
              ? __ldg(Lm + static_cast<long long>(j * kBs + r) * n + o +
                      lane)
              : 0.f;
        __syncwarp();
#pragma unroll
        for (int q = 0; q < kBs; ++q) lv[q] = w[lane][q];
        __syncwarp();
      } else {                          // L[i rows, j cols]: coalesced
#pragma unroll
        for (int q = 0; q < kBs; ++q)
          lv[q] = o + q < n
              ? __ldg(Lm + static_cast<long long>(o + q) * n + row) : 0.f;
      }
      float acc[kTm];
#pragma unroll
      for (int cc = 0; cc < kTm; ++cc) acc[cc] = 0.f;
#pragma unroll
      for (int q = 0; q < kBs; ++q)
#pragma unroll
        for (int cc = 0; cc < kTm; ++cc)
          acc[cc] = fmaf(lv[q], X[(o + q) * kXld + cc], acc[cc]);
#pragma unroll
      for (int cc = 0; cc < kTm; ++cc) X[row * kXld + cc] -= acc[cc];
    }
  }
  __syncthreads();
  for (int e = tid; e < n * kTm; e += kThreads) {
    const int r = e / kTm, q = e % kTm;
    if (c0 + q < m) xm[static_cast<long long>(r) * m + c0 + q] =
        X[r * kXld + q];
  }
}

}  // namespace

// L: [n, n] lower triangular (l_stride 0, shared by the batch) or
// [batch, n, n] (l_stride n * n); b, x: [batch, n, m]; all float32 and
// contiguous. transposed = 0 solves L x = b, 1 solves L^T x = b. The
// block's n_pad x 9 floats of b live in shared memory beside 37 KB of
// static tiles, which bounds n at about 5,400 of the 227 KB (the wrapper
// takes n <= 4096). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int trisolve_launch(const void* L, const void* b, void* x,
                               int batch, int n, int m, long long l_stride,
                               int transposed, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const int n_pad = (n + kBs - 1) / kBs * kBs;
  const int smem = n_pad * kXld * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      trisolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kTm - 1) / kTm, batch);
  trisolve_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(b),
      static_cast<float*>(x), n, m, l_stride, transposed);
  return static_cast<int>(cudaGetLastError());
}
