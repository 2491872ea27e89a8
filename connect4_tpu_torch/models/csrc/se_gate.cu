// The learner's squeeze-and-excitation gate (Leela Chess Zero's body,
// config.SENetConfig) for Hopper (sm_90a): one kernel forward and one
// backward, a block a board, over NHWC activations (rows of C channels, 42
// rows a board).
//
// Replaces no TPU kernel (the JAX package has no such net). The plain
// version is connect4_tpu_torch/models/se_gate.py::_GatePlain, the same
// arithmetic in PyTorch ops. Written because the gate in PyTorch ops takes
// about 25 launches a block, forward and backward: at 20 blocks the
// learner's step then queues more kernels than the card's launch queue
// holds, and the host waits on the card.
//
// Forward, for y the second BatchNorm's output and x the block's input
// (float32, [N*42, C]), W1 [S, C], b1 [S], W2 [2C, S], b2 [2C] (float32):
//   s  = mean of y over the board's 42 rows                    [N, C]
//   z  = relu(W1 s + b1)                                        [N, S]
//   e  = W2 z + b2;  g = sigmoid(e[:C]);  h = e[C:]              [N, 2C]
//   out = relu(g * y + h + x), float32, and its bf16 copy
// and it keeps s, z and g for the backward. Backward, given the gradients
// of out (float32) and of the copy (bf16), either of which may be absent:
//   d    = (d_out + d_copy) where out > 0, else 0     (the skip's gradient)
//   d_e  = [sum_rows(d * y) * g * (1 - g), sum_rows(d)]
//   d_h  = (W2^T d_e) where z > 0, else 0
//   d_y  = d * g + (W1^T d_h) / 42
// d_e and d_h are written out; the weights' gradients, which sum over the
// boards, are products of them with z and s in PyTorch (se_gate.py).
//
// A block is C threads (C a multiple of 32, at most 1024): thread c owns
// channel c of the board's 42 rows, which it keeps in registers; the Dense
// layers run a warp an output with a shuffle sum, or a thread an output.
// Each sum is taken in a fixed order, so a run is repeatable.
// Nothing is allocated here; every launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 42;  // rows of a board
constexpr int kMaxC = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[j] = sum_c w[j * ld + c] * v[c] for j < n (a warp an output, lanes over
// c), then fn(j, out[j]) by lane 0
template <typename Fn>
__device__ __forceinline__ void warp_dense(const float* __restrict__ w, const float* v, int n, int len, int ld,
                                           Fn fn) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int j = threadIdx.x >> 5; j < n; j += warps) {
    float a = 0.f;
    for (int c = lane; c < len; c += 32) a += w[size_t(j) * ld + c] * v[c];
    a = warp_sum(a);
    if (lane == 0) fn(j, a);
  }
}

__global__ void se_gate_fwd(const float* __restrict__ y, const float* __restrict__ x, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2, float* __restrict__ out, __nv_bfloat16* __restrict__ out_c,
                            float* __restrict__ s_out, float* __restrict__ z_out, float* __restrict__ g_out, int C,
                            int S) {
  extern __shared__ float sh[];  // s [C], z [S]
  float* s = sh;
  float* z = sh + C;
  const int n = blockIdx.x, c = threadIdx.x;
  const size_t base = size_t(n) * kRows * C + c;
  float v[kRows];
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    v[p] = y[base + size_t(p) * C];
    sum += v[p];
  }
  s[c] = sum / float(kRows);
  s_out[size_t(n) * C + c] = s[c];
  __syncthreads();
  warp_dense(w1, s, S, C, C, [&](int j, float a) {
    const float h = a + b1[j];
    z[j] = h > 0.f ? h : 0.f;
    z_out[size_t(n) * S + j] = z[j];
  });
  __syncthreads();
  float eg = b2[c], eh = b2[C + c];
  for (int j = 0; j < S; ++j) {
    eg += w2[size_t(c) * S + j] * z[j];
    eh += w2[size_t(C + c) * S + j] * z[j];
  }
  const float g = 1.f / (1.f + expf(-eg));
  g_out[size_t(n) * C + c] = g;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const size_t i = base + size_t(p) * C;
    float o = fmaf(g, v[p], eh) + x[i];
    o = o > 0.f ? o : 0.f;
    out[i] = o;
    if (out_c != nullptr) out_c[i] = __float2bfloat16_rn(o);
  }
}

__global__ void se_gate_bwd(const float* __restrict__ d_out, const __nv_bfloat16* __restrict__ d_copy,
                            const float* __restrict__ y, const float* __restrict__ out,
                            const float* __restrict__ g_in, const float* __restrict__ z_in,
                            const float* __restrict__ w1, const float* __restrict__ w2, float* __restrict__ d_skip,
                            float* __restrict__ d_y, float* __restrict__ d_e, float* __restrict__ d_h, int C,
                            int S) {
  extern __shared__ float sh[];  // d_e [2C], d_h [S]
  float* de = sh;
  float* dh = sh + 2 * C;
  const int n = blockIdx.x, c = threadIdx.x;
  const size_t base = size_t(n) * kRows * C + c;
  const float g = g_in[size_t(n) * C + c];
  float d[kRows];
  float sum_d = 0.f, sum_dy = 0.f;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const size_t i = base + size_t(p) * C;
    float gr = d_out != nullptr ? d_out[i] : 0.f;
    if (d_copy != nullptr) gr += __bfloat162float(d_copy[i]);
    d[p] = out[i] > 0.f ? gr : 0.f;
    d_skip[i] = d[p];
    sum_d += d[p];
    sum_dy += d[p] * y[i];
  }
  de[c] = sum_dy * g * (1.f - g);
  de[C + c] = sum_d;
  d_e[size_t(n) * 2 * C + c] = de[c];
  d_e[size_t(n) * 2 * C + C + c] = sum_d;
  __syncthreads();
  // d_h[j] = sum_k W2[k][j] d_e[k]: a warp an output, lanes over k
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int j = threadIdx.x >> 5; j < S; j += warps) {
    float a = 0.f;
    for (int k = lane; k < 2 * C; k += 32) a += w2[size_t(k) * S + j] * de[k];
    a = warp_sum(a);
    if (lane == 0) {
      const float h = z_in[size_t(n) * S + j] > 0.f ? a : 0.f;
      dh[j] = h;
      d_h[size_t(n) * S + j] = h;
    }
  }
  __syncthreads();
  float ds = 0.f;
  for (int j = 0; j < S; ++j) ds += w1[size_t(j) * C + c] * dh[j];
  ds /= float(kRows);
#pragma unroll
  for (int p = 0; p < kRows; ++p) d_y[base + size_t(p) * C] = fmaf(d[p], g, ds);
}

}  // namespace

// y, x, out: float32 [n*42, C]; out_c: bf16 [n*42, C] or null; w1 [S, C],
// b1 [S], w2 [2C, S], b2 [2C] float32; s_out, g_out [n, C] and z_out [n, S]
// float32 out. C a multiple of 32 up to 1024. Returns a cudaError_t.
extern "C" int c4_se_gate_fwd(const void* y, const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, void* out_c, void* s_out, void* z_out, void* g_out, int n,
                              int C, int S, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  if (C % 32 || C > kMaxC || S < 1) return int(cudaErrorInvalidValue);
  se_gate_fwd<<<n, C, (C + S) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(out_c), static_cast<float*>(s_out),
      static_cast<float*>(z_out), static_cast<float*>(g_out), C, S);
  return int(cudaGetLastError());
}

// d_out: float32 or null, d_copy: bf16 or null (not both null), y, out:
// float32 [n*42, C]; g [n, C], z [n, S], w1 [S, C], w2 [2C, S] float32;
// d_skip, d_y: float32 [n*42, C] out; d_e [n, 2C], d_h [n, S] float32 out.
extern "C" int c4_se_gate_bwd(const void* d_out, const void* d_copy, const void* y, const void* out, const void* g,
                              const void* z, const void* w1, const void* w2, void* d_skip, void* d_y, void* d_e,
                              void* d_h, int n, int C, int S, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  if (C % 32 || C > kMaxC || S < 1 || (d_out == nullptr && d_copy == nullptr)) return int(cudaErrorInvalidValue);
  se_gate_bwd<<<n, C, (2 * C + S) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_out), static_cast<const __nv_bfloat16*>(d_copy), static_cast<const float*>(y),
      static_cast<const float*>(out), static_cast<const float*>(g), static_cast<const float*>(z),
      static_cast<const float*>(w1), static_cast<const float*>(w2), static_cast<float*>(d_skip),
      static_cast<float*>(d_y), static_cast<float*>(d_e), static_cast<float*>(d_h), C, S);
  return int(cudaGetLastError());
}
