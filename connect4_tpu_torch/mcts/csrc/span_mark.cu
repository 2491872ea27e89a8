// Marks of the program's spans on the card, for Hopper (sm_90a): one empty
// kernel for each span, span_mark<i> for the span of index i in
// connect4_tpu_torch/launches.py:SPANS (0 the mark that closes a
// partition), so that each span's mark has a name of its own in a profiler's
// trace.
//
// Replaces no TPU kernel. On the TPU the search is one XLA program whose
// profile names each fused op; here a search iteration is one replayed CUDA
// graph whose nodes are ATen kernels that name no phase of the search, and
// no range on the host can label work that the card replays after the host
// has moved on. A mark captured into the graph runs at every replay, so in
// a device trace the work between one mark and the next on a stream is the
// work of the first mark's span.
//
// Bound: launch latency alone. The kernel reads and writes nothing; a
// launch is one block of one thread, about a microsecond of the card's time
// inside a graph.

#include <cuda_runtime.h>

#include <utility>

// not in an anonymous namespace, so that the trace shows span_mark<i>
template <int I>
__global__ void span_mark() {}

namespace {

constexpr int kMarks = 32;

template <int... I>
const void* mark_of(int index, std::integer_sequence<int, I...>) {
  static const void* const table[] = {reinterpret_cast<const void*>(&span_mark<I>)...};
  return table[index];
}

}  // namespace

// Launch span_mark<index> on `stream`; returns the launch's cudaError_t (0
// when it was accepted, cudaErrorInvalidValue for an index outside [0, 32)).
extern "C" int c4_span_mark(int index, void* stream) {
  if (index < 0 || index >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = mark_of(index, std::make_integer_sequence<int, kMarks>{});
  return static_cast<int>(cudaLaunchKernel(kernel, dim3(1), dim3(1), nullptr, 0, static_cast<cudaStream_t>(stream)));
}
