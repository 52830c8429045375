// The launch plan of kernel B4 (fused_rw_chunk.cu): its routes, their
// sizes and the one function that chooses among them. Plain C++ with no
// CUDA header, so the CPU tests build it with the host's compiler and
// hold ops/fused_rw_chunk.py::plan to it.

#pragma once

#include <cstddef>

namespace b4plan {

constexpr int kLatency = 0, kThroughput = 1, kGlobal = 2;        // routes
constexpr int kStageNone = 0, kStageRing = 1, kStageWhole = 2;   // inputs
constexpr int kLatD = 32;          // latency route: a lane a coordinate
constexpr int kThrD = 128;         // throughput route: a thread a column
constexpr int kMaxCpb = 8;         // chains a block
constexpr int kCpbN = 128;         // chains a block = n / kCpbN
constexpr int kRing = 4;           // staging ring: steps deep
constexpr int kWholeBytes = 96 * 1024;   // stage all K steps up to this
constexpr int kTJ = 8;             // global route: rows of inv a tile
constexpr int kTiles = 8;          // global route: tiles in flight
constexpr int kGlobalThreads = 256;
constexpr int kVecs = 7;           // a chain's x, y1, y2 (global route) and
                                   // four s halves
constexpr int kGlobalCpb = 4;      // global route: chains a block, at most
constexpr int kModes = 16;         // the mixture's modes, at most

struct Plan {
  int route, cpb, threads, stage, ld;
  std::size_t smem;                // bytes of dynamic shared memory
  std::size_t off_vec, off_r, off_ring, off_stage;   // float offsets
};

inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The launch for n chains of d coordinates, K steps, target kind (0 the
// correlated Gaussian, 1 the mixture of n_modes modes). force: -1 the
// route the shape takes (latency for d <= 32, throughput for the Gaussian
// up to 128, else global), or a route to take. n / kCpbN chains a block
// (1 to kMaxCpb), fewer where their vectors would not fit max_smem.
// The throughput route takes two threads a column of inv, the global route
// one (up to kGlobalThreads) and at most kGlobalCpb chains a block.
// Shared memory, in floats: the mixture's log weights; the throughput
// route's mean [ld] and each chain's kVecs vectors [ld] (ld = d rounded up
// to 32); each chain's r1 and r2 [ld] in the block routes (the
// Gaussian); the global route's ring of
// inv tiles (the Gaussian); the latency and throughput routes' staged
// per-step inputs, all K steps where they fit kWholeBytes, else kRing.
// Returns false where the route does not take the shape or even one
// chain a block does not fit max_smem.
inline bool rw_plan(int n, int d, int K, int kind, int n_modes, int force,
                    int max_smem, Plan* p) {
  if (kind == 1 && (n_modes < 1 || n_modes > kModes)) return false;
  const bool lat = d <= kLatD;
  const bool thr = kind == 0 && d <= kThrD;
  const int route = force >= 0 ? force
                                : (lat ? kLatency : (thr ? kThroughput
                                                         : kGlobal));
  if ((route == kLatency && !lat) || (route == kThroughput && !thr) ||
      route < 0 || route > kGlobal)
    return false;
  const int cap = route == kGlobal ? kGlobalCpb : kMaxCpb;
  int cpb = n / kCpbN;
  cpb = cpb < 1 ? 1 : (cpb > cap ? cap : cpb);
  const int ld = round_up(d, 32);
  const int cols = round_up(d, 32);
  for (; cpb >= 1; --cpb) {
    int threads = 32 * cpb;
    if (route == kThroughput && 2 * cols > threads) threads = 2 * cols;
    if (route == kGlobal && kind == 0) {   // a thread a column of inv
      const int g = cols < kGlobalThreads ? cols : kGlobalThreads;
      if (g > threads) threads = g;
    }
    const std::size_t chains = static_cast<std::size_t>(cpb);
    std::size_t fl = kModes;       // the mixture's log weights
    p->off_vec = fl;
    if (route == kThroughput) fl += ld + chains * kVecs * ld;
    p->off_r = fl;
    if (route != kLatency && kind == 0) fl += 2 * chains * ld;
    p->off_ring = fl;
    if (route == kGlobal && kind == 0)
      fl += static_cast<std::size_t>(kTiles) * kTJ * threads;
    p->off_stage = fl;
    int stage = kStageNone;
    if (route != kGlobal) {
      const std::size_t slot = chains * (2 * d + 4);
      const std::size_t all_k = slot * static_cast<std::size_t>(K);
      stage = 4 * all_k <= static_cast<std::size_t>(kWholeBytes)
                  ? kStageWhole : kStageRing;
      fl += stage == kStageWhole ? all_k : kRing * slot;
    }
    p->route = route;
    p->cpb = cpb;
    p->threads = threads;
    p->stage = stage;
    p->ld = ld;
    p->smem = sizeof(float) * fl;
    if (p->smem <= static_cast<std::size_t>(max_smem)) return true;
  }
  return false;
}

}  // namespace b4plan
