// Kernel B10: the DREAM-zs Metropolis tail for every chain in one launch.
//
// Replaces bipymc_tpu/ops/accept_select.py::accept_select_pallas (the
// pallas_call at :75; body _kernel :35). Plain version:
// bipymc_tpu_torch/ops/accept_select.py::accept_select_reference, which is
// the port's default route (ops/fused_chunk.py::metropolis_select, then
// logp_sum + logp_new). For chain i:
//
//   log_alpha       = min(0, (logp*[i] - logp[i]) + log_jac[i])
//   acc             = isfinite(logp*[i]) && log_u[i] < log_alpha
//   x_new[i, :]     = acc ? x*[i, :] : x[i, :]
//   logp_new[i]     = acc ? logp*[i] : logp[i]
//   logp_sum_new[i] = logp_sum[i] + logp_new[i]
//   accepted[i]     = acc
//
// Every operation is exact (compare, select, min, add; no multiply, so no
// contraction), so the kernel is bit-equal to the plain version. Two
// spellings matter. The min keeps NaN, as torch.clamp_max and jnp.minimum
// do: fminf(0, NaN) is 0, which would ACCEPT a chain whose current logp
// or log Jacobian is NaN; bipymc::min0 rejects it. And the build adds
// no fast-math flag, so isfinite and the NaN compares stay IEEE. The log
// of the accept uniform stays outside, in torch, as in the reference.
//
// Left behind, as TPU layout with no counterpart here: the five scalars
// packed into one [n, 128] operand and the three results into another,
// and n and d padded to 128 (accept_select.py:29-31, :63-85).
//
// What bounds it on the H100: bytes. x_new's row is a copy of one of the
// two rows, so the function reads only the row it keeps. At config 3's
// [256, 100] float32 that row read and x_new written are 204,800 B, with
// 29 B of scalars a chain 212,224 B: 0.000063 ms at 3.35 TB/s. The launch
// itself takes microseconds, so at that size the kernel is launch-bound.
// It copies the kept row as bytes, in the widest vectors the operands
// allow (the pattern of csrc/gather_rows.cu).
//
// Design: one warp a chain, four chains a 128-thread block. Every lane
// reads the chain's scalars (one broadcast load each) and computes acc;
// the lanes copy the kept row in vectors of V bytes through the read-only
// path; lane 0 writes the three results.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChainsPerBlock = kThreads / 32;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
accept_select_kernel(const V* __restrict__ x, long long ldx,
                     const V* __restrict__ xs, long long ldxs, int n_vec,
                     const T* __restrict__ logp,
                     const T* __restrict__ logp_star,
                     const T* __restrict__ log_jac,
                     const T* __restrict__ log_u,
                     const T* __restrict__ logp_sum, long long n,
                     V* __restrict__ x_new, T* __restrict__ logp_new,
                     T* __restrict__ logp_sum_new,
                     unsigned char* __restrict__ accepted) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kChainsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;                    // the whole warp leaves together
  const T lp = logp[i];
  const T lps = logp_star[i];
  const T log_alpha = bipymc::min0((lps - lp) + log_jac[i]);
  const bool acc = isfinite(lps) && log_u[i] < log_alpha;
  const V* src = acc ? xs + i * ldxs : x + i * ldx;
  V* dst = x_new + i * n_vec;
  for (int j = lane; j < n_vec; j += 32) dst[j] = __ldg(src + j);
  if (lane == 0) {
    const T lp_new = acc ? lps : lp;
    logp_new[i] = lp_new;
    logp_sum_new[i] = logp_sum[i] + lp_new;
    accepted[i] = acc ? 1 : 0;
  }
}

template <typename T, typename V>
void launch(const void* x, long long ldx_bytes, const void* xs,
            long long ldxs_bytes, int row_bytes, const void* const* vec,
            long long n, void* x_new, void* const* out, cudaStream_t stream) {
  const long long blocks = (n + kChainsPerBlock - 1) / kChainsPerBlock;
  const auto w = static_cast<long long>(sizeof(V));
  accept_select_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(
      static_cast<const V*>(x), ldx_bytes / w, static_cast<const V*>(xs),
      ldxs_bytes / w, row_bytes / static_cast<int>(w),
      static_cast<const T*>(vec[0]), static_cast<const T*>(vec[1]),
      static_cast<const T*>(vec[2]), static_cast<const T*>(vec[3]),
      static_cast<const T*>(vec[4]), n, static_cast<V*>(x_new),
      static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<unsigned char*>(out[2]));
}

template <typename T>
void launch_widest(const void* x, long long ldx_bytes, const void* xs,
                   long long ldxs_bytes, int row_bytes,
                   const void* const* vec, long long n, void* x_new,
                   void* const* out, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(xs) |
                      reinterpret_cast<uintptr_t>(x_new) |
                      static_cast<uintptr_t>(ldx_bytes) |
                      static_cast<uintptr_t>(ldxs_bytes) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0)
    launch<T, uint4>(x, ldx_bytes, xs, ldxs_bytes, row_bytes, vec, n, x_new,
                     out, stream);
  else if (a % 8 == 0)
    launch<T, uint2>(x, ldx_bytes, xs, ldxs_bytes, row_bytes, vec, n, x_new,
                     out, stream);
  else
    launch<T, unsigned int>(x, ldx_bytes, xs, ldxs_bytes, row_bytes, vec, n,
                            x_new, out, stream);
}

}  // namespace

// x, x_star: [n, d] elements of `elem_size` bytes (4: float, 8: double),
// row strides ldx / ldxs elements, unit stride along d; logp, logp_star,
// log_jac, log_u, logp_sum: [n] contiguous, of the same type. Outputs:
// x_new [n, d] contiguous, logp_new and logp_sum_new [n] of the same type,
// accepted [n] bytes (0 or 1, a torch.bool tensor).
// Returns the cudaError_t of the launch (0 on success; nothing is
// launched for n = 0).
extern "C" int accept_select_launch(
    const void* x, long long ldx, const void* x_star, long long ldxs, int d,
    int elem_size, const void* logp, const void* logp_star,
    const void* log_jac, const void* log_u, const void* logp_sum, long long n,
    void* x_new, void* logp_new, void* logp_sum_new, void* accepted,
    void* stream) {
  if (n == 0) return 0;
  if (d < 0 || (elem_size != 4 && elem_size != 8) ||
      (n + kChainsPerBlock - 1) / kChainsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* vec[5] = {logp, logp_star, log_jac, log_u, logp_sum};
  void* out[3] = {logp_new, logp_sum_new, accepted};
  const long long ldx_bytes = ldx * elem_size;
  const long long ldxs_bytes = ldxs * elem_size;
  const int row_bytes = d * elem_size;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4)
    launch_widest<float>(x, ldx_bytes, x_star, ldxs_bytes, row_bytes, vec, n,
                         x_new, out, s);
  else
    launch_widest<double>(x, ldx_bytes, x_star, ldxs_bytes, row_bytes, vec,
                          n, x_new, out, s);
  return static_cast<int>(cudaGetLastError());
}
