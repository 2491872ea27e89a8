// A pointer chase through L2, for Hopper (sm_90a): the latency of one
// dependent load that hits L2, which is what bounds the search's descent
// kernel (mcts/csrc/descent.cu) a level. Not on any path of the search:
// connect4_tpu_torch/scripts/l2_latency.py times it.
//
// One thread follows `steps` links of the chain `next` (next[i] is the
// index of the next link), each load __ldcg (cached in L2, not in L1), so
// every step waits for one round trip to L2 before it can issue the next.
// With steps = 0 the kernel does one store: the device time of a kernel
// that does nothing.

#include <cuda_runtime.h>

namespace {

__global__ void l2_chase_kernel(const int* __restrict__ next, int start, int steps, int* __restrict__ out) {
  int i = start;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

// Follows `steps` links from `start` on `stream`, writing the last index
// to `out`; returns the launch's cudaError_t (0 when it was accepted).
extern "C" int c4_l2_chase(const void* next, int start, int steps, void* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(next), start, steps,
                                                                   static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
