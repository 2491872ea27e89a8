// The descent of the batched MCTS, for Hopper (sm_90a): one launch walks
// every row of a search workspace from where it stands to a childless node,
// in place.
//
// Replaces the two lax.while_loops of the JAX search's descent,
// connect4_tpu/mcts/batched.py:393-419 (_simulate_exact, the exact PUCT
// score, _child_score_parts) and connect4_tpu/mcts/batched.py:874-898
// (_simulate_parallel, the K lockstep walkers' constant-overlay score,
// _const_overlay_score_parts). They are XLA code, not Pallas: a loop whose
// condition, jnp.any(descending), the device computes. On Hopper that loop
// becomes a loop inside one kernel, each row's ending where the row reaches
// its leaf. The plain version is
// connect4_tpu_torch/mcts/descent.py::descend_plain: batched._descend_level
// repeated until no row descends.
//
// What a row b that is still descending does (slabs [B, N+1, ...], column N
// the dump row), while it has walked fewer than path_max - 2 levels:
//   base  = children_base[b, node]
//   score the 7 child slots (batched._score_parts; k = 0 the exact score,
//         k = K the constant overlay of K walkers), -inf on a full column
//   move  = the argmax, ties to the larger move (batched._argmax_prefer_large)
//   drop the stone of the side to move (age % 2) into column move
//         (batched._light_step: one bit of pieces, height[move] + 1, age + 1)
//   node  = base + move; path[b, depth + 1] = node; depth += 1
//   stop where children_base[b, node] < 0 (descending[b] = false)
// and then level = max(level, depth): the levels the batch walked, as the
// JAX loop's counter i leaves them. Rows that do not descend are left as
// they are, as the plain version leaves them.
//
// Numerics. The search compares the kernel's walk with the plain version's
// bit for bit, so every score is computed as the ATen kernels compute it
// on the card: one IEEE rounding an op (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn, which nvcc never contracts into an FMA; the plain version's
// pb_c * prior + value is two kernels, two roundings), logf without fast
// math (ATen's log), the division by the Python scalar pb_c_base as a
// product with its float reciprocal (ATen's div_true_kernel_cuda does that
// for a CPU scalar divisor), the scalars in float32 and the adds in the
// plain version's order. A child block is read as batched._take_child_block
// reads it, its index clamped to capacity - 1.
//
// Bound. The work is a pointer chase: each level needs the node's child
// block before it can score, and the move before it knows the next node.
// The bytes are few: a level needs 7 x 16 B of child stats, the node's
// 28 B prior row and the chosen child's 4 B block base (the node's visits
// are the chosen child's of the level before), some 150 B with its path
// entry and stone; this kernel also reads the other six block bases, its
// prefetch. At 512 rows the deepest descents need some 0.2 MB, under 0.1 us
// at 3.35 TB/s. The slabs sit in the 50 MB L2 (5.7 MB of stats and 10 MB of
// priors at 512 rows and 701 nodes), so the time is the chain of dependent
// L2 round trips: two before the first level (the node, then its block
// base) and one a level here (two without the prefetch), times the deepest
// row's levels, plus what an empty kernel takes
// (connect4_tpu_torch/scripts/l2_latency.py measures both).
//
// Design. One warp a row, four rows a block. Lane c < 7 owns child slot c:
// it keeps height[c] in a register and, at the top of a level, loads child
// c's stats, child c's children_base and the node's prior[c] together (the
// node's visits too, the same address in every lane). The argmax is a
// shuffle butterfly; the next node's children_base is then a shuffle from
// the lane of the move, already loaded, so one round trip to L2 separates
// two levels. The lane of the move drops the stone. Lane 0 writes path,
// node, age, depth and descending. Nothing is allocated; the launch goes on
// the caller's stream (the capture stream while a CUDA graph is captured).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWidth = 7;
constexpr int kHeight = 6;
constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr unsigned kFull = 0xffffffffu;

// Is (score s, move m) chosen over (score t, move n)? torch.argmax over the
// flipped scores: the largest score, NaN above every number, ties to the
// larger move. Lanes without a slot carry move -1 and -inf, and lose.
__device__ __forceinline__ bool better(float s, int m, float t, int n) {
  const bool s_nan = s != s, t_nan = t != t;
  if (s_nan || t_nan) return s_nan && (!t_nan || m > n);
  return s > t || (s == t && m > n);
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
descent_kernel(const int* __restrict__ children_base, const float4* __restrict__ stats,
               const float* __restrict__ prior, long long* __restrict__ node_io,
               uint8_t* __restrict__ pieces, int* __restrict__ height, int* __restrict__ age,
               uint8_t* __restrict__ descending, long long* __restrict__ path,
               long long* __restrict__ depth_io, unsigned long long* __restrict__ level, int batch,
               int capacity, int path_max, int k, float pb_c_base, float pb_c_init) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= batch || !descending[b]) return;  // the same for the whole warp

  const long long n1 = static_cast<long long>(capacity) + 1;
  const int* cb_row = children_base + b * n1;
  const float4* st_row = stats + b * n1;
  const float* pr_row = prior + b * n1 * kWidth;
  const bool slot = lane < kWidth;
  const float inv_base = __fdiv_rn(1.0f, pb_c_base);
  const long long max_depth = path_max - 2;

  int h = slot ? height[b * kWidth + lane] : kHeight;
  int a = age[b];
  long long node = node_io[b];
  long long depth = depth_io[b];
  int base = cb_row[node];
  bool still = true;

  while (depth < max_depth) {
    // everything this level reads, issued together
    float pv = st_row[node].x;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float p = 0.0f;
    int next_base = -1;
    if (slot) {
      const long long ci = static_cast<long long>(base) + lane;
      const long long clamped = ci < 0 ? 0 : (ci > capacity - 1 ? capacity - 1 : ci);
      c = st_row[clamped];
      next_base = cb_row[ci < 0 ? 0 : (ci > n1 - 1 ? n1 - 1 : ci)];
      p = pr_row[node * kWidth + lane];
    }

    float score = -INFINITY;
    if (slot && h < kHeight) {
      if (k > 0) pv = __fadd_rn(pv, static_cast<float>(k));
      const float log_term = logf(__fmul_rn(__fadd_rn(__fadd_rn(pv, pb_c_base), 1.0f), inv_base));
      const float pb_c0 = __fmul_rn(__fadd_rn(log_term, pb_c_init), __fsqrt_rn(pv));
      const float visits = c.x, vsum = c.y, tval = c.z;
      const bool term = c.w > 0.5f;
      const bool known = term || visits > 0.0f;
      const float clamped_visits = visits < 1.0f ? 1.0f : visits;  // clamp(min=1.0), NaN kept
      const bool side0 = (a & 1) == 0;  // age % 2, as torch takes it
      float value;
      if (k > 0) {
        const float side_sum = side0 ? vsum : __fsub_rn(visits, vsum);
        const float diluted = __fdiv_rn(side_sum, clamped_visits);
        const float term_val = side0 ? tval : __fsub_rn(1.0f, tval);
        value = term ? term_val : (known ? diluted : 0.0f);
      } else {
        const float mean = __fdiv_rn(vsum, clamped_visits);
        const float abs_val = term ? tval : (visits > 0.0f ? mean : 0.0f);
        value = known ? (side0 ? abs_val : __fsub_rn(1.0f, abs_val)) : 0.0f;
      }
      const float pb_c = __fdiv_rn(pb_c0, __fadd_rn(visits, 1.0f));
      score = __fadd_rn(__fmul_rn(pb_c, p), value);
    }

    float best = score;
    int move = slot ? lane : -1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(kFull, best, off);
      const int other_move = __shfl_xor_sync(kFull, move, off);
      if (better(other, other_move, best, move)) {
        best = other;
        move = other_move;
      }
    }
    const int child_base = __shfl_sync(kFull, next_base, move);

    if (lane == move) {  // the stone: row height[move] of the mover's plane
      if (h >= 0 && h < kHeight) pieces[((b * 2LL + (a & 1)) * kHeight + h) * kWidth + move] = 1;
      h += 1;
    }
    a += 1;
    node = static_cast<long long>(base) + move;
    depth += 1;
    if (lane == 0) path[b * static_cast<long long>(path_max) + depth] = node;
    base = child_base;
    if (base < 0) {
      still = false;
      break;
    }
  }

  if (slot) height[b * kWidth + lane] = h;
  if (lane == 0) {
    node_io[b] = node;
    age[b] = a;
    depth_io[b] = depth;
    descending[b] = still ? 1 : 0;
    atomicMax(level, static_cast<unsigned long long>(depth));
  }
}

}  // namespace

// The whole descent of a workspace of `batch` rows on `stream`; returns the
// launch's cudaError_t (0 when it was accepted).
extern "C" int c4_descend(const void* children_base, const void* stats, const void* prior, void* node,
                          void* pieces, void* height, void* age, void* descending, void* path, void* depth,
                          void* level, int batch, int capacity, int path_max, int k, float pb_c_base,
                          float pb_c_init, void* stream) {
  const int blocks = (batch + kRowsPerBlock - 1) / kRowsPerBlock;
  descent_kernel<<<blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(children_base), static_cast<const float4*>(stats),
      static_cast<const float*>(prior), static_cast<long long*>(node), static_cast<uint8_t*>(pieces),
      static_cast<int*>(height), static_cast<int*>(age), static_cast<uint8_t*>(descending),
      static_cast<long long*>(path), static_cast<long long*>(depth),
      static_cast<unsigned long long*>(level), batch, capacity, path_max, k, pb_c_base, pb_c_init);
  return static_cast<int>(cudaGetLastError());
}
