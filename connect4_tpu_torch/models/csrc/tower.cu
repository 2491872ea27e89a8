// Folded-BN conv tower of the Connect4 value+policy net, for Hopper (sm_90a).
//
// Replaces the TPU kernel connect4_tpu/models/pallas_net.py::_tower_kernel
// (launched by pl.pallas_call inside make_pallas_forward). It computes the
// same function: the input 3x3 conv, then n_residuals residual blocks of
// two 3x3 convs, every conv SAME-padded with float32 accumulation, a float32
// bias, LeakyReLU(0.01) and a round to bf16 (round to nearest even) at every
// layer boundary; the residual add y2 + x happens in float32 before the
// LeakyReLU. The two heads stay outside, in plain tensor code
// (connect4_tpu_torch/models/tower.py), as they stay in XLA on the TPU.
//
// Design. The Pallas kernel's TILE=128 boards and its ~40 MB VMEM working
// set do not carry over: a block here has at most 227 KB of shared memory.
// One thread block takes a tile of TB=8 boards (336 rows of (board, r, c),
// exactly 21 row tiles of 16) and keeps the tile's activations in shared
// memory across all layers: two [336, F] bf16 buffers, X (block input and
// output; the second conv of a block adds into it in place, since each
// element is read and written by the one thread that owns it) and Y (the
// block's inner activation), plus one layer's weights [F, 9F] bf16. At F=64
// that is 2 x 48,384 + 74,752 bytes, about 172 KB, so one block per SM.
// The im2col patch matrix of the Pallas kernel (_shift_rows x _tap_mask) is
// never stored: tap (dr, dc) of row (b, r, c) reads row (b, r+dr-1, c+dc-1)
// when that lies on the board and 0 otherwise, from a 9-bit mask per row.
// The 3x3 convs of the residual blocks run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): each warp owns one 16-row
// tile at a time and all F output columns. The input conv (3 channels,
// K=27) is scalar FMA. Row strides are padded by 8 bf16 so the fragment
// loads are free of bank conflicts. The ragged last tile is masked: rows of
// boards past the batch read zeros and are never stored.
//
// Bound. At F=64, n_residuals=6 a board costs
// 12 x 42 x 2 x 576 x 64 + 42 x 2 x 27 x 64 = 37.3 MFLOP, so 4096 boards
// (one search iteration of the self-play bench: 512 slots x K=8) take at
// least 0.155 ms at the H100's 989 TFLOP/s dense bf16 rate, while the
// ~25 MB of input, weights and output take 7.5 us at 3.35 TB/s: the kernel
// is bound by operations. This first version reloads each layer's weights
// from L2 into shared memory per block and does not overlap those loads
// with the products (no TMA, no wgmma); that is work for a later version.
//
// Interface: plain C, loaded with ctypes. The kernel runs on the caller's
// stream, allocates nothing, and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArea = 42;
constexpr int kWidth = 7;
constexpr int kHeight = 6;
constexpr int kTB = 8;                  // boards per block
constexpr int kRows = kTB * kArea;      // 336 rows of (board, r, c)
constexpr int kRowTiles = kRows / 16;   // 21 mma row tiles
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCin0 = 4;
constexpr float kSlope = 0.01f;

static_assert(kRows % 16 == 0, "tile rows must be a multiple of 16");

template <int F>
struct Layout {
  static constexpr int kAS = F + 8;      // activation row stride (bf16)
  static constexpr int kK = 9 * F;       // im2col depth of a 3x3 conv
  static constexpr int kWS = kK + 8;     // weight row stride (bf16)
  static constexpr size_t kActBytes = size_t(kRows) * kAS * 2;
  static constexpr size_t kWBytes = size_t(F) * kWS * 2;
  static constexpr size_t kBiasOff = 2 * kActBytes + kWBytes;
  static constexpr size_t kMaskOff = kBiasOff + F * sizeof(float);
  static constexpr size_t kSmem = kMaskOff + kRows * sizeof(uint16_t);
  // the input conv stages its planes in Y and its weights in W as floats
  static_assert(size_t(kRows) * kMaxCin0 * 4 <= kActBytes, "input staging");
  static_assert(size_t(9) * kMaxCin0 * F * 4 <= kWBytes, "conv1 staging");
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3x3 conv layer on the tile: dst = bf16(lrelu(conv(src) + b [+ dst])).
// src, dst: [kRows, kAS] bf16; w: [F, kWS] bf16, row n holds output channel
// n's weights in (dr, dc, cin) order; bias: [F] f32.
template <int F, bool kResidual>
__device__ void conv3x3_mma(const __nv_bfloat16* src, __nv_bfloat16* dst,
                            const __nv_bfloat16* w, const float* bias,
                            const uint16_t* tapmask) {
  using L = Layout<F>;
  constexpr int NT = F / 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // group: fragment row / B column
  const int t = lane & 3;   // thread in group: fragment column pair

  for (int mt = warp; mt < kRowTiles; mt += kWarps) {
    const int r0 = mt * 16 + g;
    const int r1 = r0 + 8;
    const uint32_t m0 = tapmask[r0];
    const uint32_t m1 = tapmask[r1];
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * kWidth + (tap % 3 - 1);
      const bool v0 = (m0 >> tap) & 1u;
      const bool v1 = (m1 >> tap) & 1u;
      // only dereferenced when the tap lies on the board
      const __nv_bfloat16* a0p = src + (v0 ? (r0 + off) : r0) * L::kAS + 2 * t;
      const __nv_bfloat16* a1p = src + (v1 ? (r1 + off) : r1) * L::kAS + 2 * t;
      const __nv_bfloat16* bp = w + g * L::kWS + tap * F + 2 * t;
#pragma unroll
      for (int kc = 0; kc < F; kc += 16) {
        uint32_t a[4];
        a[0] = v0 ? ld32(a0p + kc) : 0u;
        a[1] = v1 ? ld32(a1p + kc) : 0u;
        a[2] = v0 ? ld32(a0p + kc + 8) : 0u;
        a[3] = v1 ? ld32(a1p + kc + 8) : 0u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // Each 16-deep product starts from zero and is added to the
          // running sum with a rounded float32 add: the tensor core
          // truncates when it aligns its addends, and feeding it the
          // running sum would accumulate that bias over all 9F/16 steps.
          const __nv_bfloat16* b = bp + nt * 8 * L::kWS + kc;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, a, ld32(b), ld32(b + 8));
          acc[nt][0] += d[0];
          acc[nt][1] += d[1];
          acc[nt][2] += d[2];
          acc[nt][3] += d[3];
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? r1 : r0;
        __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst + row * L::kAS + col);
        float y0 = acc[nt][2 * h] + b0;
        float y1 = acc[nt][2 * h + 1] + b1;
        if (kResidual) {
          const float2 x = __bfloat1622float2(*out);
          y0 += x.x;
          y1 += x.y;
        }
        *out = __floats2bfloat162_rn(lrelu(y0), lrelu(y1));
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
tower_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ conv1_w,
             const __nv_bfloat16* __restrict__ conv1_b,
             const __nv_bfloat16* __restrict__ res_wt,
             const __nv_bfloat16* __restrict__ res_b, __nv_bfloat16* __restrict__ out,
             int n_boards, int cin0, int n_res_layers) {
  using L = Layout<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(smem + L::kActBytes);
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem + 2 * L::kActBytes);
  float* bias = reinterpret_cast<float*>(smem + L::kBiasOff);
  uint16_t* tapmask = reinterpret_cast<uint16_t*>(smem + L::kMaskOff);
  float* xin = reinterpret_cast<float*>(Y);   // input conv staging
  float* w1 = reinterpret_cast<float*>(W);

  const int tid = threadIdx.x;
  const long row_base = long(blockIdx.x) * kRows;
  const long total_rows = long(n_boards) * kArea;
  const int valid_rows = int(total_rows - row_base < kRows ? total_rows - row_base : kRows);

  // --- per-row tap masks, input planes (rounded to bf16) and conv1 -------
  for (int i = tid; i < kRows; i += kThreads) {
    const int p = i % kArea, r = p / kWidth, c = p % kWidth;
    uint32_t m = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int rr = r + tap / 3 - 1, cc = c + tap % 3 - 1;
      if (rr >= 0 && rr < kHeight && cc >= 0 && cc < kWidth) m |= 1u << tap;
    }
    tapmask[i] = uint16_t(m);
  }
  for (int i = tid; i < kRows * cin0; i += kThreads) {
    const int row = i / cin0;
    const float v = row < valid_rows ? x[row_base * cin0 + i] : 0.f;
    xin[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  for (int i = tid; i < 9 * cin0 * F; i += kThreads) w1[i] = __bfloat162float(conv1_w[i]);
  for (int i = tid; i < F; i += kThreads) bias[i] = __bfloat162float(conv1_b[i]);
  __syncthreads();

  for (int i = tid; i < kRows * F; i += kThreads) {
    const int row = i / F, n = i % F;
    const uint32_t m = tapmask[row];
    float acc = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      if (!((m >> tap) & 1u)) continue;
      const int src = row + (tap / 3 - 1) * kWidth + (tap % 3 - 1);
      for (int ci = 0; ci < cin0; ++ci)
        acc = fmaf(xin[src * cin0 + ci], w1[(tap * cin0 + ci) * F + n], acc);
    }
    X[row * L::kAS + n] = __float2bfloat16_rn(lrelu(acc + bias[n]));
  }

  // --- residual blocks: layer l reads X (even l) or Y (odd l) ------------
  constexpr int kVecPerRow = L::kK / 8;  // 16-byte vectors per weight row
  for (int l = 0; l < n_res_layers; ++l) {
    __syncthreads();  // previous layer done with W, bias and its output
    const uint4* wsrc = reinterpret_cast<const uint4*>(res_wt + size_t(l) * F * L::kK);
    for (int i = tid; i < F * kVecPerRow; i += kThreads) {
      const int n = i / kVecPerRow, v = i % kVecPerRow;
      *reinterpret_cast<uint4*>(W + n * L::kWS + v * 8) = wsrc[i];
    }
    for (int i = tid; i < F; i += kThreads) bias[i] = __bfloat162float(res_b[l * F + i]);
    __syncthreads();
    if (l % 2 == 0)
      conv3x3_mma<F, false>(X, Y, W, bias, tapmask);
    else
      conv3x3_mma<F, true>(Y, X, W, bias, tapmask);
  }
  __syncthreads();

  // --- store the tile's valid rows ----------------------------------------
  constexpr int kVecOut = F / 8;
  for (int i = tid; i < valid_rows * kVecOut; i += kThreads) {
    const int row = i / kVecOut, v = i % kVecOut;
    reinterpret_cast<uint4*>(out + (row_base + row) * F)[v] =
        *reinterpret_cast<const uint4*>(X + row * L::kAS + v * 8);
  }
}

template <int F>
int launch(const float* x, const __nv_bfloat16* conv1_w, const __nv_bfloat16* conv1_b,
           const __nv_bfloat16* res_wt, const __nv_bfloat16* res_b, __nv_bfloat16* out,
           int n_boards, int cin0, int n_res_layers, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tower_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Layout<F>::kSmem));
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int blocks = (n_boards + kTB - 1) / kTB;
  tower_kernel<F><<<blocks, kThreads, Layout<F>::kSmem, stream>>>(
      x, conv1_w, conv1_b, res_wt, res_b, out, n_boards, cin0, n_res_layers);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [n_boards*42, cin0] f32; conv1_w: [9*cin0, F] bf16, rows (dr, dc, cin);
// conv1_b: [F] bf16; res_wt: [n_res_layers, F, 9F] bf16 (each layer's
// im2col matrix transposed: row n = output channel n); res_b:
// [n_res_layers, F] bf16; out: [n_boards*42, F] bf16. Returns a cudaError_t
// (cudaErrorInvalidValue for a width or channel count it does not take).
int c4_tower_forward(const void* x, const void* conv1_w, const void* conv1_b,
                     const void* res_wt, const void* res_b, void* out, int n_boards,
                     int cin0, int filters, int n_res_layers, void* stream) {
  if (n_boards <= 0) return int(cudaSuccess);
  if (cin0 < 1 || cin0 > kMaxCin0 || n_res_layers < 0) return int(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* w1 = static_cast<const __nv_bfloat16*>(conv1_w);
  const auto* b1 = static_cast<const __nv_bfloat16*>(conv1_b);
  const auto* wr = static_cast<const __nv_bfloat16*>(res_wt);
  const auto* br = static_cast<const __nv_bfloat16*>(res_b);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (filters) {
    case 16: return launch<16>(xp, w1, b1, wr, br, o, n_boards, cin0, n_res_layers, s);
    case 32: return launch<32>(xp, w1, b1, wr, br, o, n_boards, cin0, n_res_layers, s);
    case 64: return launch<64>(xp, w1, b1, wr, br, o, n_boards, cin0, n_res_layers, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
