// The launch plan of kernel B6 (bchol.cu): how many CTAs of a thread-block
// cluster factor one matrix, the shared memory each takes, and which CTA
// updates which trailing tile at each panel step.
// Plain C++ with no CUDA header, so the CPU tests build it with the host's
// compiler; the kernel deals its tiles with the same functions.

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define B6_HD __host__ __device__
#else
#define B6_HD
#endif

namespace b6plan {

constexpr int kNb = 32;             // tile size and panel width
constexpr int kThreads = 512;       // a CTA: 16 warps
constexpr int kGroupThreads = 64;   // threads a trailing tile
constexpr int kGroups = kThreads / kGroupThreads;
constexpr int kLaWarps = 4;         // the look-ahead: factor, panel solve
constexpr int kLaGroups = kLaWarps * 32 / kGroupThreads;
constexpr int kLd = kNb + 4;        // a row of the diagonal block in smem
constexpr int kMaxN = 1600;

struct Plan {
  int P;              // CTAs of a cluster a matrix: 1 or 2
  int nb;             // block columns, ceil(n / 32)
  std::size_t smem;   // bytes of dynamic shared memory a CTA
};

// The CTA of P (1 or 2) that owns block column J, dealt in a snake: 0, 1,
// 1, 0, 0, 1, 1, ... for P = 2 (the low bit of J's Gray code), so that
// the CTAs' shares of the triangle's J (nb - J) tile updates come out near
// equal.
B6_HD inline int owner(int J, int P) {
  return P == 1 ? 0 : (J ^ (J >> 1)) & 1;
}

// Shared memory of one CTA: the panel slot, the panel's rows below the
// first diagonal block, (nb - 1) x 32 rows of 32 floats; the diagonal
// block's L^T (32 rows of kLd), its reciprocal pivots, z's block, and a
// flag (4 floats).
inline std::size_t smem_bytes(int nb) {
  return (static_cast<std::size_t>(nb - 1) * kNb * kNb + kNb * kLd +
          2 * kNb + 4) * sizeof(float);
}

// The launch for b matrices of n x n on a card of `sms` SMs whose blocks
// may take max_smem bytes of shared memory. Two CTAs a matrix where the
// batch leaves SMs idle (2 b <= sms: config 4's 64 matrices take 128 of
// the H100's 132 SMs) and there are two block columns to deal; else one,
// the same code with a cluster of one. Returns false where n is out of
// range or the panel slot does not fit (n = 1600 takes 205,584 of 227 KB).
inline bool plan(int b, int n, int sms, int max_smem, Plan* p) {
  if (b < 1 || n < 1 || n > kMaxN) return false;
  p->nb = (n + kNb - 1) / kNb;
  p->P = p->nb >= 2 && 2 * b <= sms ? 2 : 1;
  p->smem = smem_bytes(p->nb);
  return p->smem <= static_cast<std::size_t>(max_smem);
}

// Panel step k (k = 0 .. nb - 2) updates the tiles (I, J), k < J <= I <
// nb, each by the CTA that owns column J. The owner of column K = k + 1
// updates that column's tiles (K .. nb - 1, K) first, then the look-ahead
// factors them; the "rest" of a CTA's step are its other columns' tiles,
// J > K. Each is a walk over tiles, by columns, then rows, ascending: it
// starts at (J0, J0), J0 = K for the column, first_own(K + 1, ...) for the
// rest, and a group of threads takes every G-th tile from its own start.

// The first column >= j that CTA me owns, or nb.
B6_HD inline int first_own(int j, int nb, int P, int me) {
  while (j < nb && owner(j, P) != me) ++j;
  return j;
}

// (*I, *J) moved `steps` tiles on along the walk: down column *J, then to
// the next column CTA me owns (none after the first where one_column);
// *J = nb past the walk's last tile.
B6_HD inline void advance(int* I, int* J, int steps, int nb, int P, int me,
                          bool one_column) {
  while (*J < nb) {
    const int left = nb - 1 - *I;          // tiles below (*I, *J)
    if (steps <= left) {
      *I += steps;
      return;
    }
    steps -= left + 1;
    *J = one_column ? nb : first_own(*J + 1, nb, P, me);
    *I = *J;
  }
}

}  // namespace b6plan
