// Kernel B5: pairwise squared distances, max(|a|^2 + |b|^2 - 2 a.b, 0).
//
// Replaces bipymc_tpu/ops/pallas_kernels.py::_sqdist_pallas_call (the
// pallas_call at :80; dispatcher pairwise_sqdist at :112). Plain version:
// bipymc_tpu_torch/ops/pallas_kernels.py::sqdist_plain. The reference
// computes the cross term with Precision.HIGHEST, because the expansion's
// cancellation turns a TF32-sized product error into distance errors of
// ~0.1; here every product is a full float32 FMA (no tensor cores, no
// TF32) and the three sums are formed separately, as the reference forms
// them, before the clamp. The clamp keeps NaN (a NaN input stays NaN, as
// jnp.maximum and torch.clamp_min keep it).
//
// What bounds it on the H100: the output. At the GP's config-4 shape,
// 64 chains x [512, 2] x [512, 2], it reads 0.5 MB and writes 64 x 512^2
// floats = 67 MB, ~0.020 ms of HBM time; its ~2 k FMAs per output are
// negligible for k = 2. The design: one block per 32 x 32 output tile,
// the batch on blockIdx.z; the tile's 32 rows of A and of B are staged in
// shared memory 32 features at a time (the B rows padded to 33 floats so
// that a warp's 32 reads of one feature hit 32 banks); each of the 256
// threads computes a column of 4 outputs, and a warp stores 32
// neighbouring floats of one output row (128 coalesced bytes).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // output tile: kTile x kTile
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;   // 8
constexpr int kChunk = 32;                // features staged per pass

__global__ void __launch_bounds__(kTile * kThreadsY)
sqdist_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ out, int n, int m, int k) {
  __shared__ float sa[kTile][kChunk + 1];
  __shared__ float sb[kTile][kChunk + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const long long c = blockIdx.z;
  const float* a = A + c * n * k;
  const float* b = B + c * m * k;

  float cross[kRowsPerThread], a_nrm[kRowsPerThread], b_nrm = 0.f;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) cross[q] = a_nrm[q] = 0.f;

  for (int f0 = 0; f0 < k; f0 += kChunk) {
    const int kc = min(kChunk, k - f0);
    // stage rows row0.. of A and col0.. of B, features f0 .. f0+kc
    for (int e = tid; e < kTile * kChunk; e += kTile * kThreadsY) {
      const int r = e / kChunk, f = e % kChunk;
      const bool in_f = f < kc;
      sa[r][f] = (in_f && row0 + r < n)
                     ? a[static_cast<long long>(row0 + r) * k + f0 + f] : 0.f;
      sb[r][f] = (in_f && col0 + r < m)
                     ? b[static_cast<long long>(col0 + r) * k + f0 + f] : 0.f;
    }
    __syncthreads();
    for (int f = 0; f < kc; ++f) {
      const float bv = sb[tx][f];
      b_nrm = fmaf(bv, bv, b_nrm);
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float av = sa[ty + q * kThreadsY][f];
        cross[q] = fmaf(av, bv, cross[q]);
        a_nrm[q] = fmaf(av, av, a_nrm[q]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= m) return;
  float* o = out + c * n * m;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int row = row0 + ty + q * kThreadsY;
    if (row < n) {
      const float v = a_nrm[q] + b_nrm - 2.f * cross[q];
      o[static_cast<long long>(row) * m + col] = v < 0.f ? 0.f : v;
    }
  }
}

}  // namespace

// A: [c, n, k], B: [c, m, k], out: [c, n, m], all float32 and contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sqdist_launch(const void* A, const void* B, void* out, int c,
                             int n, int m, int k, void* stream) {
  if (c <= 0 || n <= 0 || m <= 0) return 0;
  if (c > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, c);
  const dim3 block(kTile, kThreadsY);
  sqdist_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(out), n, m, k);
  return static_cast<int>(cudaGetLastError());
}
