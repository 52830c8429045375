// Kernel B11: out[r] = buf[clip(idx[r], 0, cap - 1)], rows copied as bytes.
//
// Replaces bipymc_tpu/ops/gather_rows.py::gather_rows_pallas (the
// pallas_call at :94). Plain version: bipymc_tpu_torch/ops/gather_rows.py::
// gather_rows_reference (clamp, index_select, reshape); a copy is a copy,
// so the two are bit-equal for every element type.
//
// The clamp is the reference's (gather_rows.py:80-82): an index below 0
// reads row 0 and one at or above cap reads row cap - 1. Plain torch
// indexing, buf[idx], would wrap a negative index instead.
//
// Left behind, as TPU mechanics with no counterpart here: the per-row DMA
// semaphores and `rows_per_cell` with its padding of the row count
// (gather_rows.py:38-50, :83-93), and the 128-lane padding of a ragged d,
// one [cap, d_pad] copy a call (:70-79). A warp reads any row at any d.
//
// What bounds it on the H100: bytes. At config 3's fused chunk it reads
// 15,360 rows of 400 B and writes as many, with 61 KB of indices: 12.35
// MB, 0.0037 ms at 3.35 TB/s. The rows are scattered, so each is a
// separate 400 B request; the design keeps one warp on one row and every
// lane's load as wide as the operands allow, so a row is a few wide
// requests. It is the simple form: a TMA bulk copy a row (cp.async.bulk),
// or B1 reading the archive by index so that the [G, n, k, d] block is
// never written, are later designs.
//
// Design: one warp per output row. Lane 0 reads the row's index (int32 or
// int64), clamps it and broadcasts it with __shfl_sync; the lanes then
// copy the row in vectors of V bytes through the read-only path (__ldg),
// V the widest of 16, 8, 4, 2, 1 that divides the row bytes, the row
// stride in bytes and both base addresses.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // 8 warps, 8 rows a block
constexpr int kRowsPerBlock = kThreads / 32;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ buf, long long ld, long long cap,
                   int n_vec, const I* __restrict__ idx, long long n_rows,
                   V* __restrict__ out) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;             // the whole warp leaves together
  long long src_row = 0;
  if (lane == 0) {
    const long long i = static_cast<long long>(idx[row]);
    src_row = i < 0 ? 0 : (i >= cap ? cap - 1 : i);
  }
  src_row = __shfl_sync(0xffffffffu, src_row, 0);
  const V* src = buf + src_row * ld;
  V* dst = out + row * n_vec;
  for (int j = lane; j < n_vec; j += 32) dst[j] = __ldg(src + j);
}

template <typename V, typename I>
void launch(const void* buf, long long ld_bytes, long long cap,
            int row_bytes, const void* idx, long long n_rows, void* out,
            cudaStream_t stream) {
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<V, I><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const V*>(buf), ld_bytes / static_cast<long long>(sizeof(V)),
      cap, row_bytes / static_cast<int>(sizeof(V)),
      static_cast<const I*>(idx), n_rows, static_cast<V*>(out));
}

template <typename I>
void launch_widest(const void* buf, long long ld_bytes, long long cap,
                   int row_bytes, const void* idx, long long n_rows,
                   void* out, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(buf) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(ld_bytes) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0)
    launch<uint4, I>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out, stream);
  else if (a % 8 == 0)
    launch<uint2, I>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out, stream);
  else if (a % 4 == 0)
    launch<unsigned int, I>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out,
                            stream);
  else if (a % 2 == 0)
    launch<unsigned short, I>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out,
                              stream);
  else
    launch<unsigned char, I>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out,
                             stream);
}

}  // namespace

// buf: [cap, d] elements of `elem_size` bytes, row stride `ld` elements,
// unit stride along d; idx: n_rows contiguous int32 (idx64 = 0) or int64
// (idx64 = 1) indices; out: [n_rows, d], contiguous. cap >= 1.
// Returns the cudaError_t of the launch (0 on success; nothing is
// launched for n_rows = 0).
extern "C" int gather_rows_launch(const void* buf, long long ld,
                                  long long cap, int d, int elem_size,
                                  const void* idx, int idx64,
                                  long long n_rows, void* out,
                                  void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  if (cap < 1 || elem_size < 1 ||
      (n_rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ld_bytes = ld * elem_size;
  const int row_bytes = d * elem_size;
  auto s = static_cast<cudaStream_t>(stream);
  if (idx64)
    launch_widest<long long>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out,
                             s);
  else
    launch_widest<int32_t>(buf, ld_bytes, cap, row_bytes, idx, n_rows, out,
                           s);
  return static_cast<int>(cudaGetLastError());
}
