// The DREAM-zs proposal's one shared rule, for kernels B2
// (dream_proposal.cu, one generation) and B1 (fused_chunk.cu, G
// generations a launch): the crossover mask forces in the FIRST lane
// holding the minimum u (ops/dream_proposal.py::propose_block), which both
// kernels find with min_first, each lane over its coordinates, then a
// butterfly of shuffles.

#pragma once

#include <cuda_runtime.h>

namespace bipymc {

// (u, lane) lexicographic min: the smaller u, and on a tie the first lane
__device__ __forceinline__ void min_first(float& u, int& lane, float u2,
                                          int lane2) {
  if (u2 < u || (u2 == u && lane2 < lane)) {
    u = u2;
    lane = lane2;
  }
}

}  // namespace bipymc
