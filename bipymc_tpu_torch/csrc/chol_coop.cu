// Kernel B7, the route for 480 < n <= 1024: the Cholesky factor L =
// chol(A) of one SPD matrix, spread over many blocks of one cooperative
// launch (or of each matrix of a batch). The route for n <= 480 is the
// cluster kernel of csrc/chol.cu; ops/pallas_chol.py::plan picks the route
// from n before the launch.
//
// Replaces bipymc_tpu/ops/pallas_chol.py::cholesky_pallas (:188; the
// pallas_call in _chol_fwd_impl at :154, kernel body _make_kernel :46).
// Plain version: bipymc_tpu_torch/ops/pallas_chol.py::cholesky_plain
// (torch.linalg.cholesky_ex, NaN where info != 0). The gradient is the
// shared Cholesky adjoint, in PyTorch (ops/pallas_chol.py::chol_adjoint).
//
// A matrix whose factorisation meets a pivot that is not > 0 (or is NaN)
// comes back all NaN: every block keeps a flag, read after the last
// column, and the launch never traps or stops early.
//
// What bounds it on the H100: the chain of dependent panel steps, not
// bytes or FLOPs; and, in this design, what each step costs beyond its
// arithmetic. At 256 x 256 it took 0.089 ms of device time, against
// cholesky_ex's 0.069 (PERF.md, kernel table): every panel step is one
// grid barrier through an atomic counter in global memory, which all of
// the up-to-28 blocks wait at; every step's data goes through L2 (the
// solved panel to a scratch buffer and back, each trailing tile read and
// written back); and every block refactors the 32 x 32 diagonal block,
// in one warp, while its other seven warps wait. The cluster kernel
// (csrc/chol.cu) keeps the factor in shared memory instead; its
// clusters' shared memory holds n <= 480, and this kernel stays the route
// above. The design:
// - one cooperative launch of P blocks a matrix (P = the trailing tiles
//   of the first step, at most 2 a SM), with a grid barrier of its own
//   (two counters in global memory) between panel steps: one barrier a
//   step, so each step is one pass of the whole grid;
// - L is factored in place in the output (a 1024^2 matrix is 4 MB,
//   beyond a cluster's shared memory), right-looking with panels of 32;
// - every block factors the 32 x 32 diagonal block itself, in one warp
//   (lane i holds row i in registers): the same instructions on the same
//   data, so all blocks agree, and no barrier is spent on handing the
//   block round. A column takes the pivot's reciprocal square root
//   (rsqrtf, within 2 ulp) and multiplies, and the panel solve multiplies
//   by the same reciprocals, which keeps IEEE square roots and divisions
//   off the dependent chains (PERF.md);
// - the trailing lower triangle is cut into 32 x 32 tiles (I, J), J <= I,
//   dealt out to the blocks; a block solves the panel rows of its tile's
//   row and column blocks against the diagonal block (one row a thread, in
//   registers), then updates the tile, 4 outputs a thread, full float32
//   FMAs summed over the panel's 32 columns in order;
// - the solved panel cannot go back into L during the step, because other
//   blocks still read the unsolved values there: the diagonal tile's block
//   writes it to a scratch panel, double-buffered by the step's parity,
//   and the next step copies it into L before it reads anything;
// - reads of what other blocks wrote go through L2 (ld.global.cg).

#include <cuda_runtime.h>

namespace {

constexpr int kNb = 32;                 // panel width and tile size
constexpr int kThreads = 256;
constexpr int kLd = kNb + 1;            // smem row stride: no bank conflicts
constexpr unsigned kFull = 0xffffffffu;

// All blocks of a group (gridDim.x of them) wait here until every one has
// arrived. count returns to 0 at each barrier, gen counts barriers.
__device__ __forceinline__ void grid_barrier(int* count, int* gen,
                                             int nblocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* vgen = gen;
    const int g = *vgen;
    __threadfence();
    if (atomicAdd(count, 1) == nblocks - 1) {
      atomicExch(count, 0);
      __threadfence();
      atomicAdd(gen, 1);
    } else {
      while (*vgen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
chol_coop_kernel(const float* __restrict__ a, float* L, float* panel,
                 int* bar, int c_total, int n) {
  __shared__ float dg[kNb][kLd];        // the factored diagonal block
  __shared__ float dinv[kNb];           // 1 / its diagonal
  __shared__ float pi[kNb][kLd];        // the panel rows of tile row I
  __shared__ float pj[kNb][kLd];        // the panel rows of tile row J
  __shared__ int failed;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int P = gridDim.x, blk = blockIdx.x;
  const long long stride = static_cast<long long>(P) * kThreads;
  const long long first = static_cast<long long>(blk) * kThreads + tid;
  int* count = bar + 2 * blockIdx.y;
  int* gen = count + 1;
  const long long nn = static_cast<long long>(n) * n;
  const long long panel_sz = static_cast<long long>(n) * kNb;
  float* S0 = panel + blockIdx.y * 2 * panel_sz;   // [2][n][kNb]

  for (int c = blockIdx.y; c < c_total; c += gridDim.y) {
    const float* A = a + c * nn;
    float* Lm = L + c * nn;
    if (tid == 0) failed = 0;
    // the lower triangle of A into L; the strict upper triangle is zero
    for (long long e = first; e < nn; e += stride) {
      const long long i = e / n, j = e % n;
      Lm[e] = j <= i ? A[e] : 0.f;
    }
    grid_barrier(count, gen, P);

    int step = 0, k0 = 0;
    for (;; ++step, k0 += kNb) {
      const int kb = min(kNb, n - k0);
      const int r0 = k0 + kNb;                // first row below the block
      float* S = S0 + (step & 1) * panel_sz;

      // ---- 1. the last step's solved columns, from its buffer into L --
      if (step > 0) {
        const float* Sp = S0 + ((step - 1) & 1) * panel_sz;
        const int p0 = k0 - kNb;
        const long long cnt = static_cast<long long>(n - p0) * kNb;
        for (long long e = first; e < cnt; e += stride) {
          const long long r = p0 + e / kNb;
          const int q = static_cast<int>(e % kNb);
          Lm[r * n + p0 + q] = __ldcg(Sp + r * kNb + q);
        }
      }

      // ---- 2. the diagonal block, in every block, by warp 0 -----------
      if (warp == 0) {
        const int i = lane;
        float r[kNb];
#pragma unroll
        for (int q = 0; q < kNb; ++q)
          r[q] = (i < kb && q <= i)
                     ? __ldcg(Lm + static_cast<long long>(k0 + i) * n + k0 + q)
                     : 0.f;
#pragma unroll
        for (int j = 0; j < kNb; ++j) {
          if (j < kb) {                       // uniform across the warp
            float s = r[j];
#pragma unroll
            for (int p = 0; p < j; ++p)
              s = fmaf(-r[p], __shfl_sync(kFull, r[p], j), s);
            const float d = __shfl_sync(kFull, s, j);
            const float inv = rsqrtf(d);      // NaN or inf unless d > 0
            if (i == 0 && !(d > 0.f)) failed = 1;
            r[j] = i == j ? d * inv : (i > j ? s * inv : 0.f);
            if (i == j) dinv[j] = inv;
          }
        }
#pragma unroll
        for (int q = 0; q < kNb; ++q) {
          dg[i][q] = r[q];
          if (blk == 0 && i < kb)
            S[static_cast<long long>(k0 + i) * kNb + q] = r[q];
        }
      }
      __syncthreads();
      if (r0 >= n) break;                     // the last block: done

      // ---- 3. the trailing tiles (I, J), J <= I, dealt out to blocks --
      const int T = (n - r0 + kNb - 1) / kNb;
      const int n_tiles = T * (T + 1) / 2;
      const int tc = tid % 32, tr = tid / 32;
      for (int t = blk; t < n_tiles; t += P) {
        int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while ((I + 1) * (I + 2) / 2 <= t) ++I;
        while (I * (I + 1) / 2 > t) --I;
        const int J = t - I * (I + 1) / 2;
        const int ri = r0 + I * kNb, rj = r0 + J * kNb;
        // the unsolved panel rows of both tile rows, zero beyond n
        for (int e = tid; e < kNb * kNb; e += kThreads) {
          const int rr = e / kNb, q = e % kNb;
          pi[rr][q] = ri + rr < n
              ? __ldcg(Lm + static_cast<long long>(ri + rr) * n + k0 + q)
              : 0.f;
          if (J != I)
            pj[rr][q] = rj + rr < n
                ? __ldcg(Lm + static_cast<long long>(rj + rr) * n + k0 + q)
                : 0.f;
        }
        __syncthreads();
        // row x of the panel solves x L_kk^T = a: warp 0 the rows of I,
        // warp 1 those of J
        if (warp < (J == I ? 1 : 2)) {
          float(*p)[kLd] = warp == 0 ? pi : pj;
          float x[kNb];
#pragma unroll
          for (int q = 0; q < kNb; ++q) x[q] = p[lane][q];
#pragma unroll
          for (int q = 0; q < kNb; ++q) {
            float s = x[q];
#pragma unroll
            for (int u = 0; u < q; ++u) s = fmaf(-x[u], dg[q][u], s);
            x[q] = s * dinv[q];
          }
#pragma unroll
          for (int q = 0; q < kNb; ++q) p[lane][q] = x[q];
        }
        __syncthreads();
        if (J == I) {                         // keep the solved rows
          for (int e = tid; e < kNb * kNb; e += kThreads) {
            const int rr = e / kNb, q = e % kNb;
            if (ri + rr < n)
              S[static_cast<long long>(ri + rr) * kNb + q] = pi[rr][q];
          }
        }
        float(*pb)[kLd] = J == I ? pi : pj;
        // L[ri + tr + 8k, rj + tc] -= sum_q pi[tr + 8k][q] pb[tc][q]
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < kNb; ++q) {
          const float bq = pb[tc][q];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[k] = fmaf(pi[tr + 8 * k][q], bq, acc[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int row = ri + tr + 8 * k, col = rj + tc;
          if (row < n && col <= row) {
            float* dst = Lm + static_cast<long long>(row) * n + col;
            *dst = __ldcg(dst) - acc[k];
          }
        }
        __syncthreads();                      // smem reused by the next tile
      }
      grid_barrier(count, gen, P);
    }

    // the last diagonal block, from the last step's buffer into L; or, if
    // a pivot was not > 0, the whole matrix NaN
    grid_barrier(count, gen, P);
    if (failed) {
      const float nan = __int_as_float(0x7fc00000);
      for (long long e = first; e < nn; e += stride) Lm[e] = nan;
    } else {
      const float* S = S0 + (step & 1) * panel_sz;
      const int kb = n - k0;
      const long long cnt = static_cast<long long>(kb) * kNb;
      for (long long e = first; e < cnt; e += stride) {
        const long long r = k0 + e / kNb;
        const int q = static_cast<int>(e % kNb);
        if (q < kb) Lm[r * n + k0 + q] = __ldcg(S + r * kNb + q);
      }
    }
    __syncthreads();                          // `failed` is reset next
  }
}

}  // namespace

// a: [c, n, n] (only the lower triangle is read), L: [c, n, n], panel:
// [c, 2, n, 32] scratch, bar: [c, 2] int32 zeros; all contiguous, float32
// but bar. Blocks of one matrix must all be resident at once for the grid
// barrier, which the cooperative launch guarantees (it fails otherwise);
// a batch runs in as many groups of P blocks as fit, each group looping
// over its matrices. Returns the cudaError_t of the launch (0 on success).
extern "C" int chol_coop_launch(const void* a, void* L, void* panel, void* bar,
                                int c, int n, void* stream) {
  if (c <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chol_coop_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = sms * per_sm;
  const int T = n > kNb ? (n - 1) / kNb : 0;  // trailing tile rows, step 0
  int P = T * (T + 1) / 2;
  P = P < 1 ? 1 : P;
  P = P < 2 * sms ? P : 2 * sms;
  P = P < resident ? P : resident;
  int groups = resident / P;
  groups = groups < c ? groups : c;
  groups = groups < 1 ? 1 : groups;
  const float* a_ = static_cast<const float*>(a);
  float* L_ = static_cast<float*>(L);
  float* panel_ = static_cast<float*>(panel);
  int* bar_ = static_cast<int*>(bar);
  void* args[] = {&a_, &L_, &panel_, &bar_, &c, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_coop_kernel),
                                    dim3(P, groups), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
