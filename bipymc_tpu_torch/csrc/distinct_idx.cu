// Kernel B3: k distinct row indices per chain, uniform on [0, n).
//
// Replaces bipymc_tpu/ops/distinct_idx.py::distinct_idx_pallas (the
// pallas_call at :95). Plain version: bipymc_tpu_torch/ensemble/
// indices.py::distinct_from_bits, which this kernel matches bit for bit:
// the same masked 31-bit words, the same int32 remainder, the same shift
// and sorted-insert order.
//
// What bounds it on the H100: nothing but the launch. At the main path's
// 256 chains x k = 6 it reads 6 KB of words and writes 6 KB of indices,
// a few nanoseconds of HBM time, and does ~30 dependent integer ops per
// draw. The design keeps it to one launch and no memory traffic beyond
// that: one thread per chain, k and m = k (+1 with `exclude`) are
// template parameters so the `taken` list is fully unrolled into
// registers, and the words are read in place from the generation's word
// block through a row stride (no copy kernel before it).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <int K, bool EXCL>
__global__ void __launch_bounds__(kThreads)
distinct_idx_kernel(const uint32_t* __restrict__ bits, long long ld,
                    int n_chains, int n, const int32_t* __restrict__ exclude,
                    int32_t* __restrict__ out) {
  constexpr int M = K + (EXCL ? 1 : 0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_chains) return;

  int32_t taken[M];
#pragma unroll
  for (int j = 0; j < M; ++j) taken[j] = INT_MAX;
  if (EXCL) taken[0] = exclude[i];
  const int32_t avail = n - (EXCL ? 1 : 0);
  const uint32_t* w = bits + static_cast<long long>(i) * ld;
  int32_t* o = out + static_cast<long long>(i) * K;

#pragma unroll
  for (int t = 0; t < K; ++t) {
    int32_t r = static_cast<int32_t>(w[t] & 0x7FFFFFFFu) % (avail - t);
    // shift past the taken values, in increasing order
#pragma unroll
    for (int j = 0; j < M; ++j) r += (r >= taken[j]) ? 1 : 0;
    o[t] = r;
    // branchless insert of r into the sorted list (INT_MAX sentinels last)
    int pos = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) pos += (taken[j] < r) ? 1 : 0;
    int32_t next[M];
#pragma unroll
    for (int j = 0; j < M; ++j)
      next[j] = (j < pos) ? taken[j]
                          : ((j == pos) ? r : taken[j > 0 ? j - 1 : 0]);
#pragma unroll
    for (int j = 0; j < M; ++j) taken[j] = next[j];
  }
}

template <int K>
void launch(const uint32_t* bits, long long ld, int n_chains, int n,
            const int32_t* exclude, int32_t* out, cudaStream_t stream) {
  const dim3 grid((n_chains + kThreads - 1) / kThreads);
  if (exclude != nullptr)
    distinct_idx_kernel<K, true><<<grid, kThreads, 0, stream>>>(
        bits, ld, n_chains, n, exclude, out);
  else
    distinct_idx_kernel<K, false><<<grid, kThreads, 0, stream>>>(
        bits, ld, n_chains, n, exclude, out);
}

}  // namespace

// bits: [n_chains, >= k] 32-bit words, row stride `ld` (in words);
// exclude: [n_chains] int32 or null; out: [n_chains, k] int32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int distinct_idx_launch(const void* bits, long long ld,
                                   int n_chains, int k, int n,
                                   const void* exclude, void* out,
                                   void* stream) {
  if (n_chains == 0) return 0;
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* ex = static_cast<const int32_t*>(exclude);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(b, ld, n_chains, n, ex, o, s); break;
    case 2: launch<2>(b, ld, n_chains, n, ex, o, s); break;
    case 3: launch<3>(b, ld, n_chains, n, ex, o, s); break;
    case 4: launch<4>(b, ld, n_chains, n, ex, o, s); break;
    case 5: launch<5>(b, ld, n_chains, n, ex, o, s); break;
    case 6: launch<6>(b, ld, n_chains, n, ex, o, s); break;
    case 7: launch<7>(b, ld, n_chains, n, ex, o, s); break;
    case 8: launch<8>(b, ld, n_chains, n, ex, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
