// The launch plan of kernel B9 (fused_stretch.cu): its routes, their sizes
// and the one function that chooses among them. Plain C++ with no CUDA
// header, so the CPU tests build it with the host's compiler and hold
// ops/fused_stretch.py::plan to it.

#pragma once

#include <cstddef>

namespace b9plan {

// where the population (x, logp) lives: shared memory for the whole
// launch, or x_hist itself in device memory
constexpr int kShared = 0, kGlobal = 1;
// where the target's constants are read: shared memory (copied once a
// launch), or device memory (the Gaussian's inverse through a ring)
constexpr int kConstShared = 0, kConstDevice = 1;
constexpr int kThreads = 1024;
// The register instance: the Gaussian at d <= kRegD, kRegL lanes a walker,
// each holding kRegD / kRegL columns of inv in registers
constexpr int kRegD = 16, kRegL = 4, kRegThreads = 512;
// The ring (the Gaussian, constants in device memory): tiles of kRingTJ
// rows x kRingE L columns of inv (kRingE columns a lane), stored
// transposed with kRingLdt floats a column (4 mod 8: eight lanes' 16-byte
// reads of eight columns fall in eight bank quads), kRingSlots deep
constexpr int kRingE = 4, kRingTJ = 64, kRingLdt = kRingTJ + 4;
constexpr int kRingSlots = 2;

struct Plan {
  int route, consts, reg, L, threads, groups, ld, ldc;
  // 16-byte accesses: the shared route's write-back (d and ld multiples
  // of 4, x_hist aligned) and the words' copies (n a multiple of 4, the
  // operands aligned); set by the launch, which sees the pointers
  bool vec_x, vec_words;
  std::size_t smem;            // bytes
  // float offsets into shared memory: the groups' residuals, the words'
  // buffers and the population; the constants or the ring start at 0
  std::size_t off_r, off_buf, off_x;
};

inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The launch for n walkers (n even) in d dimensions on target kind (0 the
// correlated Gaussian, 1 the mixture of n_modes modes), within max_smem
// bytes of shared memory. An aligned group of L lanes takes a walker (L
// the power of two >= d, at most 32, halved until L x n/2 <= kThreads;
// kRegL for the register instance's shapes, whatever the route), and the
// groups take a half's walkers in rounds.
// The constants: in shared memory (inv transposed [d, ldc] and the mean
// [ldc], or the means [n_modes, d]) where they fit beside the words'
// buffers and one group's residual, as every shape of the kernel before
// this route had them; else read from device memory, the Gaussian's
// inverse through a ring of kRingSlots tiles. force_consts: -1 that
// choice, or kConstShared / kConstDevice.
// The population: in shared memory (x [n, ld], logp [n]) where it fits
// beside the rest with one round a half-update, else in x_hist, with as
// many groups as their residuals leave room for. force_route: -1 that
// choice, or kShared / kGlobal.
// Returns false where the route asked for does not fit, or where not even
// one group's residual [ldc] fits (the Gaussian past d ~ 40,000).
inline bool fused_stretch_plan(int n, int d, int kind, int n_modes,
                               int max_smem, int force_route,
                               int force_consts, Plan* p) {
  const int half = n / 2;
  const bool reg_shape =
      kind == 0 && d <= kRegD && kRegL * half <= kRegThreads;
  int L = 1;
  while (L < d && L < 32) L *= 2;
  while (L > 1 && L * half > kThreads) L /= 2;
  if (reg_shape) L = kRegL;
  p->L = L;
  int ldc = round_up(d < kRegD ? kRegD : d, 4);   // >= kRegD: see eval_reg
  if (ldc % 8 == 0) ldc += 4;
  p->ldc = ldc;
  p->ld = round_up(d, L);
  if (p->ld / L % 2 == 0) p->ld += L;            // an odd multiple of L
  const std::size_t cap = static_cast<std::size_t>(max_smem) / sizeof(float);
  const std::size_t words = 6 * static_cast<std::size_t>(round_up(n, 4));
  const std::size_t state =
      static_cast<std::size_t>(n) * p->ld + round_up(n, 4);
  const std::size_t r_per_group = kind == 0 ? static_cast<std::size_t>(ldc)
                                            : 0;
  const std::size_t n_const = static_cast<std::size_t>(round_up(
      kind == 0 ? d * ldc + ldc : n_modes * d, 4));
  const bool const_fits = n_const + words + r_per_group <= cap;
  if (force_consts == kConstShared && !const_fits) return false;
  p->consts = (force_consts == kConstDevice || !const_fits) ? kConstDevice
                                                           : kConstShared;
  p->reg = reg_shape && p->consts == kConstShared;
  const std::size_t ring =
      p->consts == kConstDevice && kind == 0
          ? static_cast<std::size_t>(kRingSlots) * kRingE * L * kRingLdt
          : 0;
  const std::size_t front = p->consts == kConstShared ? n_const : ring;
  const std::size_t fixed = front + words;
  if (fixed + r_per_group > cap) return false;   // not even one group
  int groups = half < kThreads / L ? half : kThreads / L;
  const bool shared_fits = fixed + groups * r_per_group + state <= cap;
  if (force_route == kShared && !shared_fits) return false;
  p->route = (force_route == kGlobal || !shared_fits) ? kGlobal : kShared;
  if (p->route == kGlobal && r_per_group) {
    const std::size_t room = (cap - fixed) / r_per_group;
    if (room < static_cast<std::size_t>(groups)) groups = static_cast<int>(room);
  }
  p->groups = groups;
  p->threads = round_up(groups * L, 32);
  p->off_r = front;
  p->off_buf = p->off_r + round_up(static_cast<int>(groups * r_per_group), 4);
  p->off_x = p->off_buf + words;
  p->smem = sizeof(float) *
            (p->off_x + (p->route == kShared ? state : 0));
  p->vec_x = p->route == kShared && d % 4 == 0 && p->ld % 4 == 0;
  p->vec_words = n % 4 == 0;
  return true;
}

}  // namespace b9plan
