// Kernel B5: pairwise squared distances, max(|a|^2 + |b|^2 - 2 a.b, 0).
//
// Replaces bipymc_tpu/ops/pallas_kernels.py::_sqdist_pallas_call (the
// pallas_call at :80; dispatcher pairwise_sqdist at :112). Plain version:
// bipymc_tpu_torch/ops/pallas_kernels.py::sqdist_plain. The reference
// computes the cross term with Precision.HIGHEST, because the expansion's
// cancellation turns a TF32-sized product error into distance errors of
// ~0.1; here every product is a full float32 FMA (no tensor cores, no
// TF32) and the three sums are formed separately, as the reference forms
// them, each in feature order, one fmaf a term, before the clamp. The
// clamp keeps NaN (a NaN input stays NaN, as jnp.maximum and
// torch.clamp_min keep it).
//
// What bounds it on the H100: the output. At the GP's config-4 shape,
// 64 chains x [512, 2] x [512, 2], it reads 0.5 MB and writes 64 x 512^2
// floats = 67 MB, ~0.020 ms of HBM time; its ~7 operations per output are
// negligible for k = 2. So the design spends nothing per output but its
// k FMAs, the subtract and the store:
// - one block of 256 threads per 32 x 128 output tile, all tiles of all
//   chains on one flat grid;
// - only the k features a row has are staged, feature-major in shared
//   memory: k itself for k <= 8 (a template, one pass; configs 4 and 5
//   have k = 2), passes of 8 above that;
// - each row's and column's norm is formed once, by the thread that
//   stages it, and kept in shared memory;
// - a thread holds its 4 columns' features in registers and owns those 4
//   columns in 4 rows; a warp writes 128 neighbouring floats of a row as
//   32 16-byte stores. Where m % 4 != 0 (or the output is not 16-byte
//   aligned) a row does not start 16-byte aligned, and the launch picks
//   the scalar-store instance once.
// On the H100 (chip_smoke.py phase 2c; PERF.md's kernel table): 0.021 ms at
// config 4, within 4 % of the bound, against 0.068 for the first design's
// 32 x 32 tiles with 4-byte stores. Three choices were timed in turns,
// with bit-equal outputs: streaming stores (__stcs, evict-first) were
// faster than plain ones, since the 67 MB written pass through a 50 MB L2
// and are never read back, so evicting them first keeps L2's write-back
// from competing with the stream; one block a tile
// was faster than a grid of 8 blocks a SM walking over the tiles, which
// adds a loop and index arithmetic for nothing a launch does not already
// give; 64-row tiles tied at config 4 and lost at config 5's [256] x
// [256] (8 blocks against 16), so the tiles stay 32 rows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;                 // output tile: kRows x kCols
constexpr int kCols = 128;                // a warp's 32 lanes x 4 columns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;      // 4
constexpr int kChunk = 8;                 // features staged a pass, k > 8

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// KC: features staged a pass (k itself where k <= kChunk, so one pass).
// kVec: rows start 16-byte aligned (m % 4 == 0), so a thread's 4 columns
// go out as one float4.
template <int KC, bool kVec>
__global__ void __launch_bounds__(kThreads)
sqdist_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ out, int n, int m, int k, int tiles_n,
              int tiles_m) {
  __shared__ __align__(16) float sb[KC][kCols];     // B's tile, by feature
  __shared__ float sa[KC][kRows];
  __shared__ __align__(16) float sb_nrm[kCols];
  __shared__ float sa_nrm[kRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // threads 0..127 stage the tile's B rows, 128..159 its A rows
  const bool stages_b = tid < kCols;
  const int sr = stages_b ? tid : tid - kCols;
  const bool stages = stages_b || sr < kRows;

  const long long t = blockIdx.x;
  const int tm = static_cast<int>(t % tiles_m);
  const long long rest = t / tiles_m;
  const int tn = static_cast<int>(rest % tiles_n);
  const long long c = rest / tiles_n;
  const int row0 = tn * kRows, col0 = tm * kCols;
  const int src_row = (stages_b ? col0 : row0) + sr;
  const bool live = stages && src_row < (stages_b ? m : n);
  const float* src = (stages_b ? B + c * m * k : A + c * n * k) +
                     static_cast<long long>(src_row) * k;

  float nrm = 0.f;
  float cross[kRowsPerWarp][4];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) cross[q][j] = 0.f;

  for (int f0 = 0; f0 < k; f0 += KC) {
    if (stages) {
      // zeros past k leave every sum exact: fmaf(0, 0, s) == s
#pragma unroll
      for (int f = 0; f < KC; ++f) {
        const float v = (live && f0 + f < k) ? src[f0 + f] : 0.f;
        nrm = fmaf(v, v, nrm);
        if (stages_b) sb[f][sr] = v; else sa[f][sr] = v;
      }
    }
    __syncthreads();
    float4 bq[KC];
#pragma unroll
    for (int f = 0; f < KC; ++f)
      bq[f] = *reinterpret_cast<const float4*>(&sb[f][4 * lane]);
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int r = warp + q * kWarps;
#pragma unroll
      for (int f = 0; f < KC; ++f) {
        const float av = sa[f][r];
        cross[q][0] = fmaf(av, bq[f].x, cross[q][0]);
        cross[q][1] = fmaf(av, bq[f].y, cross[q][1]);
        cross[q][2] = fmaf(av, bq[f].z, cross[q][2]);
        cross[q][3] = fmaf(av, bq[f].w, cross[q][3]);
      }
    }
    __syncthreads();           // sa and sb are free for the next pass
  }
  if (stages_b) sb_nrm[sr] = nrm; else if (stages) sa_nrm[sr] = nrm;
  __syncthreads();

  const float4 bn = *reinterpret_cast<const float4*>(&sb_nrm[4 * lane]);
  const int col = col0 + 4 * lane;
  float* o = out + c * n * m;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int r = warp + q * kWarps;
    const int row = row0 + r;
    if (row >= n || col >= m) continue;
    const float an = sa_nrm[r];
    const float v0 = clamp0(an + bn.x - 2.f * cross[q][0]);
    const float v1 = clamp0(an + bn.y - 2.f * cross[q][1]);
    const float v2 = clamp0(an + bn.z - 2.f * cross[q][2]);
    const float v3 = clamp0(an + bn.w - 2.f * cross[q][3]);
    float* p = o + static_cast<long long>(row) * m + col;
    if (kVec) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(v0, v1, v2, v3));
    } else {
      __stcs(p, v0);
      if (col + 1 < m) __stcs(p + 1, v1);
      if (col + 2 < m) __stcs(p + 2, v2);
      if (col + 3 < m) __stcs(p + 3, v3);
    }
  }
}

template <int KC>
cudaError_t launch(bool vec, dim3 grid, cudaStream_t stream, const float* A,
                   const float* B, float* out, int n, int m, int k,
                   int tiles_n, int tiles_m) {
  if (vec)
    sqdist_kernel<KC, true><<<grid, kThreads, 0, stream>>>(
        A, B, out, n, m, k, tiles_n, tiles_m);
  else
    sqdist_kernel<KC, false><<<grid, kThreads, 0, stream>>>(
        A, B, out, n, m, k, tiles_n, tiles_m);
  return cudaGetLastError();
}

}  // namespace

// A: [c, n, k], B: [c, m, k], out: [c, n, m], all float32 and contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sqdist_launch(const void* A, const void* B, void* out, int c,
                             int n, int m, int k, void* stream) {
  if (c <= 0 || n <= 0 || m <= 0) return 0;
  const int tiles_n = (n + kRows - 1) / kRows;
  const int tiles_m = (m + kCols - 1) / kCols;
  const long long n_tiles = static_cast<long long>(c) * tiles_n * tiles_m;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_tiles));
  // decided once a launch: every row starts 16-byte aligned, or none may
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const float*>(A);
  const auto b = static_cast<const float*>(B);
  const auto o = static_cast<float*>(out);
  cudaError_t e;
  switch (k) {
    case 1: e = launch<1>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 2: e = launch<2>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 3: e = launch<3>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 4: e = launch<4>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 5: e = launch<5>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 6: e = launch<6>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 7: e = launch<7>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    case 8: e = launch<8>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m); break;
    default: e = launch<kChunk>(vec, grid, s, a, b, o, n, m, k, tiles_n, tiles_m);
  }
  return static_cast<int>(e);
}
