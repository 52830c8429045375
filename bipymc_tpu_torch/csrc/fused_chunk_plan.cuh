// The launch plan of kernel B1 (fused_chunk.cu): its routes, their sizes
// and the one function that chooses among them. Plain C++ with no CUDA
// header, so the CPU tests build it with the host's compiler and hold
// ops/fused_chunk.py::plan to it.

#pragma once

#include <cstddef>

namespace b1plan {

constexpr int kShared = 0, kGlobal = 1;   // routes
constexpr int kThreads = 256;      // threads a block, both routes
constexpr int kMaxCpb = 8;         // shared route: chains a block
constexpr int kCpbN = 128;         // chains a block = n / kCpbN
constexpr int kGlobalCpb = 4;      // global route: chains a block, at most
constexpr int kTJ = 8;             // global route: rows of inv a tile
constexpr int kTiles = 8;          // global route: tiles a warp's ring
constexpr int kGroup = 128;        // columns of a tile: a quad a lane
constexpr int kModes = 16;         // the mixture's modes, at most
constexpr int kScalPad = 8;        // floats of a staged scal row (6 used)
constexpr int kDraws = 3;          // u_mask, u_e, eps rows a generation
constexpr int kWorkVecs = 3;       // global route: x, y, r a chain

struct Plan {
  int route, cpb, threads, ld, rows;
  std::size_t smem;                // bytes of dynamic shared memory
  // float offsets: the constants (shared route) or the first chain's ring
  // (global route), the chains' vectors, the slots
  std::size_t off_c, off_vec, off_stage;
  std::size_t slot;                // floats of a staged (chain, generation)
  std::size_t work;                // global route: workspace floats a chain
};

inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The launch for n chains of d coordinates, G generations, n_pairs DE
// pairs (the kernel reads rows 0 .. max(2 n_pairs, 3) - 1 of each
// chain's archive rows), target kind (0 the correlated Gaussian, 1 the
// mixture of n_modes modes). force: -1 the route the shape takes (shared
// where it fits max_smem, else global), or a route to take.
// Shared route: the target's constants in shared memory, read once a
// block (inv [d, ld] and the mean [ld]; the means [n_modes, ld]), each
// chain's x, y (and r, the Gaussian) [ld], and each (chain, generation)'s
// inputs staged in a slot: its rows [ld], the prepared vector [ld], the
// draws [ld + 4] (a row placed at its address's offset in a quad) and a
// scal row (ld = d rounded up to 4). n / kCpbN chains a block (1 to
// kMaxCpb): the largest count whose slots for all G generations fit. A
// shape where one chain's vectors and G slots do not fit beside the
// constants takes the global route (the Gaussian past d = 192 at G = 10).
// Global route: the constants read from device memory, the Gaussian's
// inverse through a ring of kTiles tiles a chain (kTJ rows x kGroup
// columns), and each chain's vectors in a workspace of
// (kWorkVecs + kDraws G) [ld] the wrapper allocates; up to kGlobalCpb
// chains a block. Returns false where the route does not take the shape.
inline bool chunk_plan(int n, int d, int G, int n_pairs, int kind,
                       int n_modes, int force, int max_smem, Plan* p) {
  if (kind == 1 && (n_modes < 1 || n_modes > kModes)) return false;
  if (force < -1 || force > kGlobal) return false;
  const int ld = round_up(d, 4);
  const int rows = 2 * n_pairs > 3 ? 2 * n_pairs : 3;
  const std::size_t slot =
      static_cast<std::size_t>(rows + 1 + kDraws) * ld + 4 * kDraws +
      kScalPad;
  const std::size_t room = static_cast<std::size_t>(max_smem) / 4;
  int cpb0 = n / kCpbN;
  cpb0 = cpb0 < 1 ? 1 : (cpb0 > kMaxCpb ? kMaxCpb : cpb0);
  p->ld = ld;
  p->rows = rows;
  p->threads = kThreads;
  p->slot = slot;
  if (force != kGlobal) {
    const std::size_t consts =
        kind == 0 ? static_cast<std::size_t>(d + 1) * ld
                  : static_cast<std::size_t>(n_modes) * ld;
    const int vecs = kind == 0 ? 3 : 2;
    for (int cpb = cpb0; cpb >= 1; --cpb) {
      const std::size_t fixed =
          kModes + consts + static_cast<std::size_t>(cpb) * vecs * ld;
      const std::size_t staged = static_cast<std::size_t>(cpb) * G * slot;
      if (fixed + staged > room) continue;
      p->route = kShared;
      p->cpb = cpb;
      p->off_c = kModes;
      p->off_vec = kModes + consts;
      p->off_stage = p->off_vec + static_cast<std::size_t>(cpb) * vecs * ld;
      p->smem = sizeof(float) * (fixed + staged);
      p->work = 0;
      return true;
    }
    if (force == kShared) return false;
  }
  int cpb = n / kCpbN;
  cpb = cpb < 1 ? 1 : (cpb > kGlobalCpb ? kGlobalCpb : cpb);
  const std::size_t ring =
      kind == 0 ? static_cast<std::size_t>(kTiles) * kTJ * kGroup : 0;
  for (; cpb >= 1; --cpb) {
    const std::size_t fl = kModes + cpb * ring;
    if (fl > room) continue;
    p->route = kGlobal;
    p->cpb = cpb;
    p->off_c = p->off_vec = p->off_stage = kModes;
    p->smem = sizeof(float) * fl;
    p->work = static_cast<std::size_t>(kWorkVecs + kDraws * G) * ld;
    return true;
  }
  return false;
}

}  // namespace b1plan
