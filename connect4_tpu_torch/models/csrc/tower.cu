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
// Bound. At F=64, n_residuals=6 a board costs
// 12 x 42 x 2 x 576 x 64 + 42 x 2 x 27 x 64 = 37.3 MFLOP, so 4096 boards
// (one search iteration of the self-play bench: 512 slots x K=8) take at
// least 0.155 ms at the H100's 989 TFLOP/s dense bf16 rate, while the
// ~25 MB of input, weights and output take 7.5 us at 3.35 TB/s: the kernel
// is bound by operations, and only wgmma reaches the card's tensor-core rate.
//
// Design.
// - A layer is D[rows, F] = sum over the 9 taps of A_tap[rows, F] x W_tap[F, F]
//   on rows of (board, r, c). A block of two warpgroups (256 threads) keeps a
//   tile of 3 boards resident in shared memory across all layers, as two
//   [rows, F] bf16 buffers X (block input and output; the second conv of a
//   residual block adds into it in place, since each element is read and
//   written by the one thread that owns it in the accumulator layout) and Y.
//   Boards are taken in threes so that 64-row wgmma tiles waste little:
//   3 boards are 126 rows in 2 tiles, one per warpgroup; 98.4% of the
//   products are useful. Two blocks fit an SM (about 97 KB and 127 registers
//   a thread at F=64), so four warpgroups cover one another's waits.
// - Each warpgroup runs wgmma.mma_async m64nFk16 with B = W_tap read from
//   shared memory through a matrix descriptor and A in registers. A warp
//   fills its 16x16 A fragment with ldmatrix.x4, whose row addresses carry
//   the shift and the mask of the tap: row i of tap (dr, dc) points at
//   activation row i + (dr-1)*7 + (dc-1) when the tap lies on the board and
//   at a shared 128-byte zero row otherwise. No patch matrix, no padded
//   board. Activations are stored swizzled by 16-byte chunk (chunk index XOR
//   row bits) so that ldmatrix and the epilogue's stores are free of bank
//   conflicts.
// - Weights arrive by asynchronous bulk copy (cp.async.bulk, no tensor map),
//   one [F, F] tap at a time, into a ring of stages with full/empty
//   mbarriers. pack_weights (tower.py) lays every tap out as the exact
//   shared-memory image the descriptor reads: the no-swizzle layout of 8x8
//   core matrices, k contiguous inside a core-matrix row. Thread 0 starts the
//   copies while its warpgroup's products are in flight (a separate producer
//   warp would cap the consumers at 96 registers), stays kStages - kLag taps
//   ahead and runs across layer boundaries, since weights do not depend on
//   activations.
// - Accumulation. The tensor core does not round to nearest where it adds a
//   step's 16 products to a running sum: it aligns them to the largest
//   exponent, cuts them two bits below that exponent's float32 unit, and cuts
//   the sum toward zero. Against a reference rounded to nearest that moves
//   some bf16 roundings at the layer boundaries, the more the longer the
//   chain. The chain length (how many 16-deep products chain inside the
//   tensor core before an ordinary float32 add) is a template parameter so
//   that one step, a tap and a whole layer can be measured.
//   tower.py::tower_plain sums in the same order and either emulates the
//   tensor core's accumulate, which reproduces every chain bit for bit (the
//   version the kernel's tolerance is held against), or rounds to nearest
//   (the independent reference, see PERF.md). c4_tower_forward ships
//   kShippedChain = the whole layer, the longest chain and the fastest: the
//   9F/16 products of a layer chain from zero in one accumulator, with no
//   float32 add outside the tensor core.
// - The input conv (K = 9*cin <= 36, zero-padded to a multiple of 16) takes
//   the same wgmma path: the A fragment is built in registers straight from
//   the staged input planes under the tap mask, B is a packed image of the
//   conv1 weights copied into Y.
// - The tile. A block takes kTileBoards = 3 boards at every batch: B=4096 is
//   1366 blocks, B=512 is 171, and small batches spread over the card;
//   tower.py::tile_plan mirrors it. A tile of 6 boards (two tiles a
//   warpgroup) halves the weight traffic from L2, but its two accumulators a
//   thread leave no registers to unroll the taps; 3 boards with the 9 taps
//   unrolled (the compiler then moves a tap's waits and loads above the
//   previous tap's adds) measured faster or equal at every batch (the table
//   in PERF.md), so the 6-board variant was taken out.
// - What holds it back: at N = F = 64 a wgmma is short (32 clk of tensor
//   core) against the ~110 clk a dependent product takes in a chain and the
//   ~250 clk from a tap's first product to the end of its wait, and the
//   registers of an SM hold only about four taps in flight beside the tiles'
//   accumulators. The known alternative is the transposed product (N = rows,
//   up to 256 a wgmma, the activations as the descriptor operand on a
//   zero-padded board), see PERF.md.
//
// Interface: plain C, loaded with ctypes. The kernel runs on the caller's
// stream, allocates nothing, and the functions return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArea = 42;
constexpr int kWidth = 7;
constexpr int kHeight = 6;
constexpr int kMaxCin0 = 4;
constexpr int kMaxK0 = 48;        // 9 * kMaxCin0 rounded up to a multiple of 16
constexpr float kSlope = 0.01f;
constexpr int kWarpgroups = 2;
constexpr int kThreads = kWarpgroups * 128;
constexpr int kLag = 2;           // a ring stage is refilled kLag taps after its use
constexpr int kBlocksPerSM = 2;

// how many 16-deep products chain inside the tensor core before a float32 add
constexpr int kChainStep = 0;     // one
constexpr int kChainTap = 1;      // one tap: F/16
constexpr int kChainLayer = 2;    // the whole layer: 9F/16
constexpr int kShippedChain = kChainLayer;
// boards per block (see the header): two 64-row tiles, one per warpgroup
constexpr int kTileBoards = 3;

template <int F>
struct Cfg {
  static constexpr int kRows = kWarpgroups * 64;     // one 64-row tile per warpgroup
  static constexpr int kValidRows = kTileBoards * kArea;
  static_assert(kValidRows <= kRows, "the boards of a block must fit its tiles");
  static constexpr int kRB = 2 * F;                  // bytes per activation row
  static constexpr int kKS = F / 16;                 // wgmma steps per tap
  // weight ring depth in taps (a power of two): what fits beside the tile
  // with two blocks on an SM
  static constexpr int kStages = 8;
  static constexpr int kStageBytes = F * F * 2;
  static constexpr int kKStepBytes = 2 * F * 16;     // one 16-deep slab of a tap
  static constexpr int kActBytes = kRows * kRB;
  // offsets from a 128-byte aligned base
  static constexpr int kZeroOff = 0;
  static constexpr int kXOff = 128;
  static constexpr int kYOff = kXOff + kActBytes;
  static constexpr int kRingOff = kYOff + kActBytes;
  static constexpr int kBiasOff = kRingOff + kStages * kStageBytes;
  static constexpr int kMaskOff = kBiasOff + 2 * F * 4;
  static constexpr int kKtabOff = kMaskOff + kRows * 2;
  static constexpr int kBarOff = kKtabOff + kMaxK0 * 4;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8 + 128;  // + alignment slack
  // the input conv stages conv1's weight image and the input planes in Y
  static constexpr int kXinOff = kYOff + F * kMaxK0 * 2;
  static_assert(F * kMaxK0 * 2 + kRows * 8 <= kActBytes, "input staging must fit Y");
  static_assert(kBarOff % 8 == 0 && kKtabOff % 4 == 0, "alignment");
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// 16-byte chunk c of activation row `row` lives at chunk c ^ swz(row): any 8
// consecutive rows then touch 8 different 16-byte bank groups.
template <int F>
__device__ __forceinline__ uint32_t swz(int row) {
  if (F == 64) return uint32_t(row) & 7u;
  if (F == 32) return (uint32_t(row) >> 1) & 3u;
  return (uint32_t(row) >> 2) & 1u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instruction's start and wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a K-major B operand in the no-swizzle layout: 8x8 core
// matrices of 128 contiguous bytes; core matrices adjacent in n lie 128 bytes
// apart (stride offset), those adjacent in k lie F/8 * 128 bytes apart
// (leading offset). Fields are in 16-byte units.
template <int F>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t lbo = (F / 8) * 128 / 16;
  constexpr uint64_t sbo = 128 / 16;
  return uint64_t((addr & 0x3FFFFu) >> 4) | (lbo << 16) | (sbo << 32);
}

// wgmma m64nNk16, A from registers, B through a descriptor; `zero` starts a
// chain (scale-d = 0, the registers need not be initialised), `add`
// accumulates when scale_d is non-zero.
template <int N>
struct Mma;
template <>
struct Mma<16> {
  static __device__ __forceinline__ void zero(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0u));
  }
  static __device__ __forceinline__ void add(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <>
struct Mma<32> {
  static __device__ __forceinline__ void zero(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0u));
  }
  static __device__ __forceinline__ void add(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <>
struct Mma<64> {
  static __device__ __forceinline__ void zero(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0u));
  }
  static __device__ __forceinline__ void add(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// bias, residual, LeakyReLU, round to bf16, store one 64-row tile swizzled.
// Accumulator layout: d[4j + 2h + e] is row g + 8h, column 8j + 2t + e of the
// warp's 16 rows.
template <int F, bool kResidual>
__device__ __forceinline__ void epilogue(const float (&acc)[F / 2], unsigned char* dst,
                                         const float* bias, int row_g, int t) {
#pragma unroll
  for (int j = 0; j < F / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_g + 8 * h;
      __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
          dst + row * (2 * F) + ((uint32_t(j) ^ swz<F>(row)) << 4) + 4 * t);
      float y0 = acc[4 * j + 2 * h] + b.x;
      float y1 = acc[4 * j + 2 * h + 1] + b.y;
      if (kResidual) {
        const float2 x = __bfloat1622float2(*out);
        y0 += x.x;
        y1 += x.y;
      }
      *out = __floats2bfloat162_rn(lrelu(y0), lrelu(y1));
    }
  }
}

template <int F, int CHAIN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
tower_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ conv1_img,
             const __nv_bfloat16* __restrict__ conv1_b,
             const __nv_bfloat16* __restrict__ res_img,
             const __nv_bfloat16* __restrict__ res_b, __nv_bfloat16* __restrict__ out,
             int n_boards, int cin0, int n_res_layers) {
  using C = Cfg<F>;
  constexpr int ND = F / 2;  // accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  unsigned char* X = smem + C::kXOff;
  unsigned char* Y = smem + C::kYOff;
  float* bias = reinterpret_cast<float*>(smem + C::kBiasOff);       // [2][F]
  uint16_t* tapmask = reinterpret_cast<uint16_t*>(smem + C::kMaskOff);
  uint32_t* ktab = reinterpret_cast<uint32_t*>(smem + C::kKtabOff);
  uint16_t* xin = reinterpret_cast<uint16_t*>(smem + C::kXinOff);   // [rows][4] bf16 bits
  const uint32_t zero_s = smem_u32(smem + C::kZeroOff);
  const uint32_t x_s = smem_u32(X), y_s = smem_u32(Y);
  const uint32_t ring_s = smem_u32(smem + C::kRingOff);
  const uint32_t bar_s = smem_u32(smem + C::kBarOff);
  // barriers: full[s] at bar_s + 8s, empty[s] at bar_s + 8(C::kStages + s), conv1 last
  const uint32_t bar_c1 = bar_s + 16 * C::kStages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int w4 = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const long row_base = long(blockIdx.x) * C::kValidRows;
  const long total_rows = long(n_boards) * kArea;
  const int valid_rows =
      int(total_rows - row_base < C::kValidRows ? total_rows - row_base : C::kValidRows);
  const int k0 = 9 * cin0;              // depth of the input conv
  const int ksteps0 = (k0 + 15) / 16;
  const int total_steps = 9 * n_res_layers;
  const unsigned char* res_bytes = reinterpret_cast<const unsigned char*>(res_img);

  // --- barriers, first weight copies ---------------------------------------
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_s + 8 * s, 1);
      mbar_init(bar_s + 8 * (C::kStages + s), kWarpgroups * 4);  // lane 0 of each warp
    }
    mbar_init(bar_c1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t c1_bytes = uint32_t(F) * ksteps0 * 16 * 2;
    mbar_expect_tx(bar_c1, c1_bytes);
    bulk_copy(y_s, conv1_img, c1_bytes, bar_c1);
    for (int j = 0; j < C::kStages - kLag && j < total_steps; ++j) {
      mbar_expect_tx(bar_s + 8 * j, C::kStageBytes);
      bulk_copy(ring_s + j * C::kStageBytes, res_bytes + size_t(j) * C::kStageBytes,
                C::kStageBytes, bar_s + 8 * j);
    }
  }

  // --- tables and the input planes (rounded to bf16) -----------------------
  for (int i = tid; i < 32; i += kThreads) reinterpret_cast<uint32_t*>(smem + C::kZeroOff)[i] = 0u;
  for (int i = tid; i < C::kRows; i += kThreads) {
    uint32_t m = 0;
    if (i < C::kValidRows) {
      const int p = i % kArea, r = p / kWidth, c = p % kWidth;
      for (int tap = 0; tap < 9; ++tap) {
        const int rr = r + tap / 3 - 1, cc = c + tap % 3 - 1;
        if (rr >= 0 && rr < kHeight && cc >= 0 && cc < kWidth) m |= 1u << tap;
      }
    }
    tapmask[i] = uint16_t(m);
  }
  // ktab[k]: row offset (low byte), channel (second byte) and tap bit (high
  // half) of element k of the input conv's im2col row; padding has no bit
  for (int k = tid; k < kMaxK0; k += kThreads) {
    uint32_t e = 0;
    if (k < k0) {
      const int tap = k / cin0, ci = k % cin0;
      const int off = (tap / 3 - 1) * kWidth + (tap % 3 - 1);
      e = (uint32_t(off) & 0xFFu) | (uint32_t(ci) << 8) | (0x10000u << tap);
    }
    ktab[k] = e;
  }
  for (int i = tid; i < C::kRows * 4; i += kThreads) {
    const int row = i >> 2, ci = i & 3;
    const float v = (ci < cin0 && row < valid_rows) ? x[(row_base + row) * cin0 + ci] : 0.f;
    xin[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  if (tid < F) {
    bias[tid] = __bfloat162float(conv1_b[tid]);
    if (n_res_layers > 0) bias[F + tid] = __bfloat162float(res_b[tid]);
  }
  __syncthreads();

  // rows this thread addresses for ldmatrix (lane & 15) and owns in the
  // accumulator (g, g + 8) in its warpgroup's tile
  const int tile_row = wg * 64 + w4 * 16;
  const int row_l = tile_row + (lane & 15);
  const int row_g = tile_row + g;
  const uint32_t mask_l = tapmask[row_l];

  float acc[ND];

  // --- input conv: A built in registers from the staged planes -------------
  mbar_wait(bar_c1, 0);
  {
    const int r0 = row_g, r1 = r0 + 8;
    const uint32_t m0 = tapmask[r0], m1 = tapmask[r1];
    auto val = [&](int row, uint32_t m, int k) -> uint32_t {
      const uint32_t e = ktab[k];
      const int off = int(int8_t(e & 0xFFu));
      const int ci = int((e >> 8) & 0xFFu);
      return (m & (e >> 16)) ? uint32_t(xin[(row + off) * 4 + ci]) : 0u;
    };
    auto pair = [&](int row, uint32_t m, int k) -> uint32_t {
      return val(row, m, k) | (val(row, m, k + 1) << 16);
    };
    uint32_t a[kMaxK0 / 16][4];
#pragma unroll
    for (int s = 0; s < kMaxK0 / 16; ++s) {
      const int k = 16 * s + 2 * t;
      a[s][0] = pair(r0, m0, k);
      a[s][1] = pair(r1, m1, k);
      a[s][2] = pair(r0, m0, k + 8);
      a[s][3] = pair(r1, m1, k + 8);
    }
    wgmma_fence();
    Mma<F>::zero(acc, a[0], b_desc<F>(y_s));
#pragma unroll
    for (int s = 1; s < kMaxK0 / 16; ++s)
      if (s < ksteps0) Mma<F>::add(acc, a[s], b_desc<F>(y_s + s * C::kKStepBytes), 1u);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    epilogue<F, false>(acc, X, bias, row_g, t);
  }

  // --- residual blocks: layer l reads X (even l) or Y (odd l) --------------
  int step = 0;  // global tap counter: stage step % C::kStages, use step / C::kStages
  for (int l = 0; l < n_res_layers; ++l) {
    __syncthreads();  // the previous layer's output is complete
    if (tid < F && l + 1 < n_res_layers)
      bias[((l + 1) & 1 ? 0 : F) + tid] = __bfloat162float(res_b[(l + 1) * F + tid]);
    const bool odd = l & 1;
    const uint32_t src_s = odd ? y_s : x_s;
    unsigned char* dst = odd ? X : Y;
    const float* lbias = bias + (odd ? 0 : F);

#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;

    // shared-memory address this lane hands ldmatrix for tap `tap`
    auto a_addr = [&](int tap) -> uint32_t {
      const int src_row = row_l + (tap / 3 - 1) * kWidth + (tap % 3 - 1);
      const uint32_t a_off =
          uint32_t(src_row) * C::kRB + ((uint32_t(lane >> 4) ^ swz<F>(src_row)) << 4);
      return ((mask_l >> tap) & 1u) ? src_s + a_off : zero_s + (a_off & 127u);
    };
    // Thread 0 refills the stage that was used kLag taps before tap `at` with
    // the tap kStages - kLag ahead; called while products are in flight.
    auto refill = [&](int at) {
      const int nxt = at + C::kStages - kLag;
      if (tid == 0 && nxt < total_steps) {
        const int ns = nxt % C::kStages;
        const uint32_t nuse = uint32_t(nxt / C::kStages);
        if (nuse > 0) mbar_wait(bar_s + 8 * (C::kStages + ns), (nuse - 1) & 1u);
        mbar_expect_tx(bar_s + 8 * ns, C::kStageBytes);
        bulk_copy(ring_s + ns * C::kStageBytes, res_bytes + size_t(nxt) * C::kStageBytes,
                  C::kStageBytes, bar_s + 8 * ns);
      }
    };
    auto full_wait = [&](int at) -> uint32_t {  // returns the stage's address
      const int stage = at % C::kStages;
      mbar_wait(bar_s + 8 * stage, uint32_t(at / C::kStages) & 1u);
      return ring_s + stage * C::kStageBytes;
    };
    auto release = [&](int at) {  // this warp's share of the products has read the stage
      if (lane == 0) mbar_arrive(bar_s + 8 * (C::kStages + at % C::kStages));
    };

    // The 9 taps are unrolled (the compiler then moves a tap's waits and
    // loads above the previous tap's adds), except for the one-step chain,
    // whose loops stay rolled to fit the registers.
#pragma unroll(CHAIN != kChainStep ? 9 : 1)
    for (int tap = 0; tap < 9; ++tap, ++step) {
      const uint32_t w_s = full_wait(step);
      const uint32_t a_s = a_addr(tap);
      if constexpr (CHAIN == kChainStep) {
        // Every 16-deep product starts from zero and is added in float32.
        // The loop over the steps stays rolled, so that one partial sum
        // and one A fragment (plus the next, loaded while the product
        // runs) are all the registers it takes.
        float part[ND];
        uint32_t a[4], a_next[4] = {0u, 0u, 0u, 0u};
        ldmatrix_x4(a, a_s);
#pragma unroll 1
        for (int ks = 0; ks < C::kKS; ++ks) {
          wgmma_fence();
          Mma<F>::zero(part, a, b_desc<F>(w_s + ks * C::kKStepBytes));
          wgmma_commit();
          if (ks == 0) refill(step);
          if (ks + 1 < C::kKS) ldmatrix_x4(a_next, a_s ^ uint32_t((ks + 1) << 5));
          wgmma_wait<0>();
          reg_fence(part);
#pragma unroll
          for (int i = 0; i < ND; ++i) acc[i] += part[i];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = a_next[i];
        }
      } else {
        uint32_t a[C::kKS][4];
#pragma unroll
        for (int ks = 0; ks < C::kKS; ++ks) ldmatrix_x4(a[ks], a_s ^ uint32_t(ks << 5));
        if constexpr (CHAIN == kChainLayer) {
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < C::kKS; ++ks)
            Mma<F>::add(acc, a[ks], b_desc<F>(w_s + ks * C::kKStepBytes),
                        (tap > 0 || ks > 0) ? 1u : 0u);
          wgmma_commit();
          refill(step);
          wgmma_wait<0>();
          reg_fence(acc);
        } else {
          // The tap's F/16 steps chain inside the tensor core from zero,
          // and the tap's sum is added in float32.
          float part[ND];
          wgmma_fence();
          Mma<F>::zero(part, a[0], b_desc<F>(w_s));
#pragma unroll
          for (int ks = 1; ks < C::kKS; ++ks)
            Mma<F>::add(part, a[ks], b_desc<F>(w_s + ks * C::kKStepBytes), 1u);
          wgmma_commit();
          refill(step);
          wgmma_wait<0>();
          reg_fence(part);
#pragma unroll
          for (int i = 0; i < ND; ++i) acc[i] += part[i];
        }
      }
      release(step);
    }

    if (odd)
      epilogue<F, true>(acc, dst, lbias, row_g, t);
    else
      epilogue<F, false>(acc, dst, lbias, row_g, t);
  }
  __syncthreads();

  // --- store the tile's valid rows, un-swizzled ---------------------------
  constexpr int kVec = F / 8;
  for (int i = tid; i < valid_rows * kVec; i += kThreads) {
    const int row = i / kVec, c = i % kVec;
    reinterpret_cast<uint4*>(out + (row_base + row) * F)[c] =
        *reinterpret_cast<const uint4*>(X + row * C::kRB + ((uint32_t(c) ^ swz<F>(row)) << 4));
  }
}

template <int F, int CHAIN>
int launch(const float* x, const __nv_bfloat16* conv1_img, const __nv_bfloat16* conv1_b,
           const __nv_bfloat16* res_img, const __nv_bfloat16* res_b, __nv_bfloat16* out,
           int n_boards, int cin0, int n_res_layers, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tower_kernel<F, CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<F>::kSmem);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int blocks = (n_boards + kTileBoards - 1) / kTileBoards;
  tower_kernel<F, CHAIN><<<blocks, kThreads, Cfg<F>::kSmem, stream>>>(
      x, conv1_img, conv1_b, res_img, res_b, out, n_boards, cin0, n_res_layers);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [n_boards*42, cin0] f32; conv1_img: [F * 16*ceil(9*cin0/16)] bf16 and
// res_img: [n_res_layers, 9, F*F] bf16, the shared-memory images that
// tower.py::pack_weights makes (8x8 core matrices, element (n, k) of a tap at
// ((k/8 * F/8 + n/8) * 8 + n%8) * 8 + k%8); conv1_b: [F] bf16; res_b:
// [n_res_layers, F] bf16; out: [n_boards*42, F] bf16. chain is one of the
// kChain* values; the chains that are not shipped are built at F=64 only
// (they are there to be measured). Returns a cudaError_t
// (cudaErrorInvalidValue for a combination it does not take).
int c4_tower_forward_chain(const void* x, const void* conv1_img, const void* conv1_b,
                           const void* res_img, const void* res_b, void* out, int n_boards,
                           int cin0, int filters, int n_res_layers, int chain, void* stream) {
  if (n_boards <= 0) return int(cudaSuccess);
  if (cin0 < 1 || cin0 > kMaxCin0 || n_res_layers < 0) return int(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* w1 = static_cast<const __nv_bfloat16*>(conv1_img);
  const auto* b1 = static_cast<const __nv_bfloat16*>(conv1_b);
  const auto* wr = static_cast<const __nv_bfloat16*>(res_img);
  const auto* br = static_cast<const __nv_bfloat16*>(res_b);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define C4_LAUNCH(F_, CH_)                                                             \
  if (filters == F_ && chain == CH_)                                                   \
    return launch<F_, CH_>(xp, w1, b1, wr, br, o, n_boards, cin0, n_res_layers, s);
  C4_LAUNCH(16, kShippedChain)
  C4_LAUNCH(32, kShippedChain)
  C4_LAUNCH(64, kChainStep)
  C4_LAUNCH(64, kChainTap)
  C4_LAUNCH(64, kChainLayer)
#undef C4_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The shipped kernel: chain kShippedChain.
int c4_tower_forward(const void* x, const void* conv1_img, const void* conv1_b,
                     const void* res_img, const void* res_b, void* out, int n_boards,
                     int cin0, int filters, int n_res_layers, void* stream) {
  return c4_tower_forward_chain(x, conv1_img, conv1_b, res_img, res_b, out, n_boards, cin0,
                                filters, n_res_layers, kShippedChain, stream);
}

}  // extern "C"
