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
// but block row i needs every solved block before it. The design that
// came first took 0.021 ms at both shapes, against solve_triangular's
// 0.0197 at b [256] (PERF.md): it gave a block 8 columns, one warp a
// column, so at m = 1 seven of eight warps solved zeros; and each of the
// 8 steps ran a 32-long chain of shuffles in the diagonal block, then
// read that step's tiles of L from device memory, all on the chain. This
// design:
// - a block takes MB right-hand-side columns, a template argument: 1 at
//   m = 1 (the GP's b [256], so no warp works on a column of zeros there),
//   else 8 ([256, 1024]: 128 blocks; 2 <= m < 8, which no path sends,
//   pads to 8 with columns of zeros); their n rows stay in shared memory
//   from the first load to the last store, a batch axis is gridDim.y;
// - the off-diagonal tiles of L's lower triangle are copied into shared
//   memory with cp.async in the order the steps use them (forward: block
//   row by block row; transposed: block column by block column), each
//   tile completing an mbarrier of its own, all of them issued at the
//   start where they fit (n <= 256: 28 tiles of 32 x 36 floats), else
//   through a ring of tiles refilled as the steps consume them (up to
//   n = 4096); a step waits on its own tiles only, and no load of L is on
//   the chain;
// - the diagonal blocks are inverted up front, as the reference does
//   (_diag_block_inverses, :50), one warp each (lane c takes column c of
//   the inverse, right-looking, each pivot's reciprocal one IEEE
//   division), eight at a time: at n <= 256 all of them before the first
//   step; beyond, the next eight when the steps reach them;
// - step i is r_i = b_i - sum_j L_ij x_j, warp w taking the step's tiles
//   w, w + 8, ..., one row a lane, each tile summed over its 32 columns in
//   order; up to 8 tiles a step the block then subtracts whole tiles in
//   order, as a right-looking substitution does. Then x_i = D_i^-1 r_i and
//   one step of refinement, x_i += D_i^-1 (r_i - D_i x_i) (transposed:
//   D_i^-T and D_i^T), warp c taking column c with the values by shuffle:
//   three 32-long products a step instead of a 32-long chain of
//   shuffles, two block barriers, full float32 FMAs. On config 5's
//   factors (cond up to 8.3e5) the product alone stood further from a
//   float64 solve than phase 2d's rule allows (1.5 x solve_triangular's
//   distance); with the refinement step it stands within it
//   (tests/test_torch_chol_solve.py emulates this arithmetic);
// - the ragged edges are masked in the kernel: rows beyond n are zero and
//   their diagonal blocks the identity, never stored; columns beyond m are
//   zero and never stored.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBs = 32;                 // block rows
constexpr int kLd = kBs + 4;            // a tile row in shared memory
constexpr int kTile = kBs * kLd;        // floats a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // diagonal inverses at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros
// where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the thread's cp.asyncs so far arrive on bar when they complete
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One warp: column `lane` of diagonal block blk of L (the identity beyond
// n), v[r] = D[r][lane], from device memory
__device__ __forceinline__ void load_diag(const float* __restrict__ Lm, int n,
                                          int blk, float (&v)[kBs]) {
  const int lane = threadIdx.x % 32, o = blk * kBs;
  const int gc = min(o + lane, n - 1);
  // every load from a valid address, the masks after: a load under a
  // condition would wait for the one before it
#pragma unroll
  for (int r = 0; r < kBs; ++r)
    v[r] = __ldg(Lm + static_cast<long long>(min(o + r, n - 1)) * n + gc);
#pragma unroll
  for (int r = 0; r < kBs; ++r)
    v[r] = (o + r < n && o + lane < n) ? (lane <= r ? v[r] : 0.f)
                                       : (r == lane ? 1.f : 0.f);
}

// One warp, from v (load_diag): D into Sd and D^-1 into Si, row-major with
// rows of kLd floats (kTrans: D^T and D^-T, so that both directions read
// rows). Lane c takes column c of the inverse, right-looking, from D^T
// staged in Si.
template <bool kTrans>
__device__ void invert_diag(const float (&v)[kBs], float* Sd, float* Si) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kBs; r += 4)      // Si[c][r] = D[r][c]
    *reinterpret_cast<float4*>(Si + lane * kLd + r) =
        make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
  if (kTrans) {
#pragma unroll
    for (int r = 0; r < kBs; r += 4)
      *reinterpret_cast<float4*>(Sd + lane * kLd + r) =
          make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < kBs; ++r) Sd[r * kLd + lane] = v[r];
  }
  __syncwarp();
  const float rinv = 1.f / Si[lane * kLd + lane];
  float y[kBs];                         // column `lane` of D^-1
#pragma unroll
  for (int r = 0; r < kBs; ++r) y[r] = r == lane ? 1.f : 0.f;
#pragma unroll
  for (int q = 0; q < kBs; ++q) {
    y[q] *= __shfl_sync(kFull, rinv, q);
#pragma unroll
    for (int r = (q + 1) / 4 * 4; r < kBs; r += 4) {
      const float4 d = *reinterpret_cast<const float4*>(Si + q * kLd + r);
      if (r > q) y[r] = fmaf(-d.x, y[q], y[r]);
      if (r + 1 > q) y[r + 1] = fmaf(-d.y, y[q], y[r + 1]);
      if (r + 2 > q) y[r + 2] = fmaf(-d.z, y[q], y[r + 2]);
      if (r + 3 > q) y[r + 3] = fmaf(-d.w, y[q], y[r + 3]);
    }
  }
  __syncwarp();
  if (kTrans) {
#pragma unroll
    for (int r = 0; r < kBs; r += 4)
      *reinterpret_cast<float4*>(Si + lane * kLd + r) =
          make_float4(y[r], y[r + 1], y[r + 2], y[r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < kBs; ++r) Si[r * kLd + lane] = y[r];
  }
}

// acc[c] = sum over the tile's 32 columns q, in order, of
// L_ij[lane][q] x_j[q][c] (forward; T holds L_ij) or L_ji[q][lane] x_j[q][c]
// (transposed; T holds L_ji): one row a lane, the whole tile
template <int MB, bool kTrans>
__device__ __forceinline__ void tile_sum(float (&acc)[MB], const float* T,
                                         const float* Xj) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < MB; ++c) acc[c] = 0.f;
#pragma unroll
  for (int q = 0; q < kBs; q += 4) {
    float l[4];
    if (!kTrans) {
      const float4 v = *reinterpret_cast<const float4*>(T + lane * kLd + q);
      l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) l[t] = T[(q + t) * kLd + lane];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* xr = Xj + (q + t) * MB;
      float xv[MB];
      if constexpr (MB % 4 == 0) {
#pragma unroll
        for (int c = 0; c < MB; c += 4) {
          const float4 w = *reinterpret_cast<const float4*>(xr + c);
          xv[c] = w.x; xv[c + 1] = w.y; xv[c + 2] = w.z; xv[c + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < MB; ++c) xv[c] = xr[c];
      }
#pragma unroll
      for (int c = 0; c < MB; ++c) acc[c] = fmaf(l[t], xv[c], acc[c]);
    }
  }
}

// One warp, lane rho: sum_q M[rho][q] v_q, v_q the value of lane q, in
// four sums by q mod 4
__device__ __forceinline__ float matvec(const float* M, float v) {
  const int lane = threadIdx.x % 32;
  float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < kBs; q += 4) {
    const float4 w = *reinterpret_cast<const float4*>(M + lane * kLd + q);
    y[0] = fmaf(w.x, __shfl_sync(kFull, v, q), y[0]);
    y[1] = fmaf(w.y, __shfl_sync(kFull, v, q + 1), y[1]);
    y[2] = fmaf(w.z, __shfl_sync(kFull, v, q + 2), y[2]);
    y[3] = fmaf(w.w, __shfl_sync(kFull, v, q + 3), y[3]);
  }
  return (y[0] + y[1]) + (y[2] + y[3]);
}

template <int MB, bool kTrans>
__global__ void __launch_bounds__(kThreads)
trisolve_kernel(const float* __restrict__ L, const float* __restrict__ b,
                float* __restrict__ x, int n, int m, long long l_stride,
                int ring, int chunk) {
  extern __shared__ float4 smem_[];
  const int nb = (n + kBs - 1) / kBs;
  const int total = nb * (nb - 1) / 2;  // off-diagonal tiles
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_);   // [ring]
  float* const tiles = reinterpret_cast<float*>(smem_) + (ring + 1) / 2 * 4;
  float* const dmat = tiles + ring * kTile;          // [kWarps] tiles: D
  float* const dinv = dmat + kWarps * kTile;         // [kWarps] tiles: D^-1
  float* const X = dinv + kWarps * kTile;            // [nb * 32][MB]
  float* const part = X + nb * kBs * MB;             // [kWarps][MB][32]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * MB;
  const float* Lm = L + blockIdx.y * l_stride;
  const long long off = static_cast<long long>(blockIdx.y) * n * m;
  const float* bm = b + off;
  float* xm = x + off;
  const bool vec = n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(Lm) & 15) == 0;
  // the first window's diagonal blocks, in flight before anything else
  float dv[kBs];
  const int blk0 = kTrans ? nb - 1 - warp : warp;
  if (blk0 >= 0 && blk0 < nb) load_diag(Lm, n, blk0, dv);

  for (int s = tid; s < ring; s += kThreads) mbar_init(full + s, 32);
  for (int e = tid; e < nb * kBs * MB; e += kThreads) {
    const int r = e / MB, q = e % MB;
    X[e] = (r < n && c0 + q < m)
               ? bm[static_cast<long long>(r) * m + c0 + q] : 0.f;
  }
  __syncthreads();

  // the ring's tiles in the order of use: step s (s = 1 .. nb-1) uses s
  // tiles, u = 0 .. s-1: forward (s, u); transposed (i + 1 + u, i) with
  // i = nb - 1 - s. Warp t % 8 copies tile t, lane l its float4s l + 32h,
  // and the warp's 32 arrivals complete the tile's mbarrier.
  int t_issue = 0, slot = 0, is = 1, iu = 0;
  auto issue = [&]() {
    if (t_issue % kWarps == warp) {
      const int i = kTrans ? nb - 1 - is : is;
      const int I = kTrans ? i + 1 + iu : i, J = kTrans ? i : iu;
      float* base = tiles + slot * kTile;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int rr = lane / 8 + 4 * h, c4 = 4 * (lane % 8);
        const int row = I * kBs + rr, col = J * kBs + c4;
        const float* src = Lm + static_cast<long long>(row) * n + col;
        float* dst = base + rr * kLd + c4;
        if (vec) {
          const bool ok = row < n && col < n;
          cp_async16(dst, ok ? src : Lm, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row < n && col + e < n;
            cp_async4(dst + e, ok ? src + e : Lm, ok);
          }
        }
      }
      cp_async_arrive(full + slot);
    }
    ++t_issue;
    if (++slot == ring) slot = 0;
    if (++iu == is) {
      ++is;
      iu = 0;
    }
  };
  while (t_issue < total && t_issue < ring) issue();

  const bool streaming = ring < total;   // the ring is refilled in a step

  int t_cons = 0;                       // tiles consumed before this step
  for (int s = 0; s < nb; ++s) {
    const int i = kTrans ? nb - 1 - s : s;
    if (s % kWarps == 0) {              // this window's diagonal blocks
      const int blk = kTrans ? i - warp : i + warp;
      if (blk >= 0 && blk < nb) {
        if (s > 0) load_diag(Lm, n, blk, dv);
        invert_diag<kTrans>(dv, dmat + warp * kTile, dinv + warp * kTile);
      }
      __syncthreads();
    }
    // r_i = b_i - sum_j L_ij x_j: warp w sums the step's tiles w, w + 8,
    // ..., each over its 32 columns in order, so up to 8 tiles a step the
    // reduction below subtracts whole tiles in order
    float p[MB];
#pragma unroll
    for (int c = 0; c < MB; ++c) p[c] = 0.f;
    for (int u0 = 0; u0 < s; u0 += chunk) {
      const int u1 = min(s, u0 + chunk);
      for (int u = u0 + (warp - u0 % kWarps + kWarps) % kWarps; u < u1;
           u += kWarps) {
        const int t = t_cons + u;
        const int ts = t < ring ? t : t % ring;
        mbar_wait(full + ts, t < ring ? 0 : (t / ring) & 1);
        const int j = kTrans ? i + 1 + u : u;
        float acc[MB];
        tile_sum<MB, kTrans>(acc, tiles + ts * kTile, X + j * kBs * MB);
#pragma unroll
        for (int c = 0; c < MB; ++c) p[c] += acc[c];
      }
      if (streaming && t_issue < total) {   // refill the slots just read
        __syncthreads();
        while (t_issue < total && t_issue < t_cons + u1 + ring) issue();
      }
    }
    t_cons += s;
#pragma unroll
    for (int c = 0; c < MB; ++c) part[(warp * MB + c) * kBs + lane] = p[c];
    __syncthreads();
    // x_i = D_i^-1 r_i, then one step of refinement, x_i += D_i^-1 (r_i -
    // D_i x_i) (transposed: D_i^-T, D_i^T, as invert_diag stored them):
    // warp c takes column c
    if (warp < MB) {
      const int c = warp, row = i * kBs + lane;
      float r = X[row * MB + c];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) r -= part[(w * MB + c) * kBs + lane];
      const float* Di = dinv + (s % kWarps) * kTile;
      const float* Dd = dmat + (s % kWarps) * kTile;
      float xi = matvec(Di, r);
      const float e = r - matvec(Dd, xi);
      xi += matvec(Di, e);
      X[row * MB + c] = xi;
    }
    __syncthreads();
  }
  for (int e = tid; e < n * MB; e += kThreads) {
    const int r = e / MB, q = e % MB;
    if (c0 + q < m) xm[static_cast<long long>(r) * m + c0 + q] = X[e];
  }
}

template <int MB, bool kTrans>
int launch(const float* L, const float* b, float* x, int batch, int n,
           int m, long long l_stride, int ring, int chunk, int smem,
           cudaStream_t stream) {
  static int attr_smem = 0;             // the largest size set so far
  if (smem > attr_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        trisolve_kernel<MB, kTrans>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_smem = smem;
  }
  const dim3 grid((m + MB - 1) / MB, batch);
  trisolve_kernel<MB, kTrans><<<grid, kThreads, smem, stream>>>(
      L, b, x, n, m, l_stride, ring, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: [n, n] lower triangular (l_stride 0, shared by the batch) or
// [batch, n, n] (l_stride n * n); b, x: [batch, n, m]; all float32 and
// contiguous. transposed = 0 solves L x = b, 1 solves L^T x = b. The launch
// is derived here from n and m: MB columns a block (1 at m = 1, else 8),
// and a block's shared memory, the fixed part (the diagonal blocks and
// their inverses, b's n rows of MB, the warps' partial sums) and as many
// of the off-diagonal tiles (each with an 8-byte mbarrier) as fit beside
// it: all of them (n <= 256; no refill) or a ring refilled half at a time
// (ops/pallas_solve.py::plan mirrors it). Returns -1 if not one tile fits,
// else the cudaError_t of the launch (0 on success).
extern "C" int trisolve_launch(const void* L, const void* b, void* x,
                               int batch, int n, int m, long long l_stride,
                               int transposed, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  static int max_smem = 0;              // the card's, asked once
  if (max_smem == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nb = (n + kBs - 1) / kBs, total = nb * (nb - 1) / 2;
  const int mb = m == 1 ? 1 : 8;
  const int tile_bytes = kTile * static_cast<int>(sizeof(float));
  const int fixed = 2 * kWarps * tile_bytes +
                    (nb * kBs * mb + kWarps * mb * kBs) *
                        static_cast<int>(sizeof(float));
  const int fit = (max_smem - fixed - 16) / (tile_bytes + 8);
  const int ring = total < fit ? total : fit;
  if (total > 0 && ring < 1) return -1;
  const int chunk = ring == total ? (nb > 1 ? nb : 1)
                                  : (ring / 2 > 1 ? ring / 2 : 1);
  const int smem = (ring + 1) / 2 * 16 + ring * tile_bytes + fixed;
  const float* L_ = static_cast<const float*>(L);
  const float* b_ = static_cast<const float*>(b);
  float* x_ = static_cast<float*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mb == 1)
    return transposed ? launch<1, true>(L_, b_, x_, batch, n, m, l_stride,
                                        ring, chunk, smem, s)
                      : launch<1, false>(L_, b_, x_, batch, n, m, l_stride,
                                         ring, chunk, smem, s);
  return transposed ? launch<8, true>(L_, b_, x_, batch, n, m, l_stride,
                                      ring, chunk, smem, s)
                    : launch<8, false>(L_, b_, x_, batch, n, m, l_stride,
                                       ring, chunk, smem, s);
}
