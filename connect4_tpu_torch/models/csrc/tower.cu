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
// Wide towers (F = 128 and 256; tower.py pads every other width up to 256 to
// the next of 16, 32, 64, 128, 256 with zero weights). The layout above does
// not grow: a ring of whole [F, F] taps is 256 KB at F=256 and the two
// [128, F] activation buffers alone are 128 KB, and an m64nF accumulator is
// F/2 registers a thread (128 at F=256).
// - Bound. At F=256 a board costs 12 x 42 x 2 x 2304 x 256 + 42 x 2 x 27 x 256
//   = 595 MFLOP (149 at F=128), so B=4096 takes at least 2.46 ms (0.62 ms)
//   at 989 TFLOP/s: bound by operations. A block multiplies each weight byte
//   into its 128 rows only, 128 FLOP a byte, so at the tensor cores' rate an
//   SM takes about 30 bytes of weights a clock from L2, some 7.7 TB/s for the
//   card: the weight stream is the nearer limit of a 3-board block. The
//   first design of this kernel copied one 16-deep slab (4 / 8 KB) a copy
//   from a consumer thread, whose whole warpgroup waited with it on each
//   empty barrier; with its products switched off its copies alone took
//   66-73% of its time (PERF.md section 6).
// - tower_kernel_wide<F>: one block an SM of three warpgroups. A producer
//   warpgroup (setmaxnreg 40; one thread issues every copy) and two consumer
//   warpgroups (setmaxnreg 232; ptxas compiles every thread to the launch
//   bound's 168 registers, which hold the m64nF accumulator and two sets of
//   A fragments), which never wait on an empty barrier. The consumers keep the
//   block's 3 boards resident across all 13 layers as X and Y (126 rows
//   each: the tiles' two rows past the boards have no taps and are not
//   stored), and run the input conv and the epilogue as above, the residual
//   added in place. Only the consumers meet at each layer's barrier.
// - A weight stage is 4 consecutive 16-deep slabs of one tap (64 input
//   channels: 16 KB at F=128, 32 KB at 256): one cp.async.bulk under one
//   full/empty barrier pair, one commit group of 4 products. res_img holds
//   the slabs in the order they are multiplied, so a stage is a contiguous
//   range, the whole layer still chains in one accumulator from zero in
//   (tap, channel) order, and the kernel equals its emulation bit for bit
//   (tower.wide_stages). A stage's A fragments are loaded before its full
//   barrier is waited on; with one stage in flight the next is issued
//   (wgmma.wait_group 1), then the one before it is released.
// - The ring takes as many stages as fit beside X and Y, at most 8: 8 of 16
//   KB at F=128, 3 of 32 KB at F=256. Budget at F=256 (232,448 B a block):
//   X and Y 129,024, the zero row 512, the biases 2,048 (float32, two
//   layers), the ring 98,304, 7 barriers 56, the slack that aligns the base
//   to a 512-byte row 512: 230,456 B. Six stages of 16 KB fit too and
//   measured no faster.
// - At F=256 the blocks run in clusters of two (kWideCluster256): ring slot
//   s is filled by block s % 2 with .multicast::cluster into both blocks,
//   every consumer warp of the cluster releases it on the filling block's
//   empty barrier (a remote arrive), and the other block expects the bytes
//   on its own full barrier; waits across the cluster trap if they outlast
//   2^33 clocks (mbar_wait_or_trap, see "Layer kernel"). The grid is
//   rounded up to whole clusters (tower.wide_grid); a pad block, with no
//   boards, takes part in every handshake and writes nothing. That halves
//   the L2 weight stream (19.3 GB at B=4096 without). At F=128 a cluster of
//   two measured 1% slower than one, so there a cluster is one block
//   (kWideCluster128).
// - F=128 runs one block an SM with 8 stages rather than two blocks with a
//   producer warp each: ptxas gives 2 x 288 threads 96 registers a thread,
//   the accumulator and the fragments spill, and that measured 1.70 ms at
//   B=4096 against 1.17 ms (two blocks with a producer warpgroup each get
//   80 and do not build).
// - Measured (PERF.md section 6): with the products switched off the copy
//   pipeline takes about 2.0 ms at F=256, B=4096 and 0.64 ms at F=128, and
//   with the copies switched off the products take 3.2-3.8 ms and 1.0 ms:
//   the copies are hidden at F=256, where the card then runs at its 700 W
//   power limit and the SM clock drops to 1.5-1.9 GHz; still exposed are
//   the 13 epilogues of one block an SM (the tensor cores idle while a
//   layer's outputs are written) and the rounds (B=4096 is 1366 blocks,
//   11 rounds on 132 SMs).
//
// Layer kernel (towers wider than 256 filters, at any width; tower.py pads F
// to the next multiple of 64 that a column tile N of 256, 224, 192 or 160
// divides: Fp = 320, 384, 448, 512, 576, 640, 768, ... 1024, ...). A block
// cannot hold such a tower: the two resident [128, Fp] tiles alone are 256
// KB at 512, an m64nFp accumulator would take Fp/2 registers a thread, and
// wgmma's N is at most 256.
// - tower_layer<N, kFirst> runs one conv a launch (13 for six residual
//   blocks), as XLA does at these widths: the activations go through device
//   memory between layers (tower.py's wrapper holds them in two [B*42, Fp]
//   bf16 buffers; the second conv of a block adds the skip from the block's
//   input in place). At Fp=512 and B=4096 that is about 5.5 GB over 13
//   launches, 1.6 ms at 3.35 TB/s, against the 9.85 ms the operations take
//   at 989 TFLOP/s (2.38 GFLOP a board): bound by operations.
// - Work: a unit is one column tile of N output channels (T = Fp/N of
//   them) of one row tile of 3 whole boards (126 rows in two 64-row tiles,
//   so a tap never reads past them). Blocks run in clusters of kCluster
//   (2, fixed at compile time); the blocks of a cluster take neighbouring row tiles
//   of the same column tile together, and each cluster walks its units in
//   turn (a persistent grid of as many clusters as fit, one block an SM),
//   so the next unit's first copies overlap the last one's epilogue.
// - A block is warp-specialised: one producer warpgroup (40 registers by
//   setmaxnreg; one thread issues every copy) and two consumer warpgroups
//   (232 registers), one m64nN accumulator each.
// - The input is staged in k-slabs, [128 rows, 64 channels] bf16 (16 KB),
//   through a ring of two: one TMA tensor copy each (a tensor map on the
//   [B*42, Fp] activations, made on the host with cuTensorMapEncodeTiled from
//   the runtime's driver entry point, since the library links no libcuda;
//   128-byte swizzle, rows past the batch read as 0). Chosen over a
//   slab-major activation layout because the activations, the skip, the
//   heads and the plain version keep one [rows, Fp] layout. Shared memory no
//   longer grows with Fp, so no width is too wide. The A operand comes from
//   the staged slab by ldmatrix at addresses that carry the tap's shift and
//   mask (off-board taps read a zero row): no patch matrix.
// - Weights: a stage is one tap of one k-slab, 64 x N (20-32 KB), copied by
//   one cp.async.bulk from tower.py::layer_image (per column tile, the
//   16-deep slabs in the order they are multiplied) through a ring of 6 (N
//   = 256, 224) or 8 stages. Stage s is filled by block s % kCluster with
//   .multicast::cluster into every block of the cluster; every consumer warp of the
//   cluster releases it on the filling block's empty barrier (a remote
//   arrive), and the other block expects the bytes on its own full barrier.
//   That halves the L2 weight stream (at Fp=512, B=4096: 77 GB without, as
//   every block reads its tile's weights for its 126 rows). A cluster of 1
//   (an edited copy) is 0.7-3.9% slower at B=4096, the batch of 73% of a
//   full generation's forwards (bench_gpu.py at 512 filters), and between
//   4% faster and 1% slower at B <= 512 (PERF.md section 6).
// - Summation order: the whole layer chains in one accumulator from zero in
//   (k-slab, tap, channel) order, 9Fp/16 steps; tower.py's layer_k_order is
//   that order and tower_plain sums in it, so the kernel and its emulation
//   agree bit for bit. A tap's 4 products are one commit group with its own
//   set of A fragments; three sets, two groups in flight (wait_group 2).
// - The input conv is the first launch (kFirst): its A fragments are built
//   in registers from the float32 planes, its weights one stage.
// - The epilogue adds the bias (and the skip, read whole into registers
//   before the last products end) in float32, applies the LeakyReLU, rounds
//   to bf16 and writes the valid rows straight to device memory.
// - Measured (PERF.md section 6): at Fp=512, B=4096 60% of the bf16 peak,
//   1.4x the earlier design that staged a block's whole [128, Fp] input
//   tile; with the tensor cores switched off the same pipeline
//   takes 47% of the time, so copies and barriers are not yet hidden behind
//   the products. The first version of this design copied one 16-deep slab
//   (8 KB) a stage and ran at 40%: one thread spends a few hundred clocks on
//   each copy's barrier wait, expect-tx and issue, which capped the weight
//   stream at about 16 bytes a clock an SM whatever the ring depth, commit
//   group or cluster size. Still exposed: the epilogue (the tensor cores
//   idle while a unit's outputs are written), and at small batches the few
//   units (B=64 at Fp=512: 22 units on 44 of 132 SMs).
// - A wait that outlasts 2^33 SM clocks (4.3 s at the card's top clock of
//   1980 MHz, longer below it) traps (mbar_wait_or_trap), so that a broken
//   handshake across a cluster ends in an error instead of holding the card.
//   A trap leaves a sticky error on the process's CUDA context: every later
//   CUDA call of that process fails, and only a new process recovers. A
//   wait of a sound run lasts microseconds (one copy from L2 or memory, or
//   the other block's products of one stage). The SM clock counts on while
//   another context's time slice runs, so on a time-sliced card a sound wait
//   traps only if other work holds this kernel off its SMs for over 4 s.
//
// Interface: plain C, loaded with ctypes. The kernel runs on the caller's
// stream, allocates nothing, and the functions return cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
// consecutive rows then touch 8 different 16-byte bank groups (at F >= 64 a
// row is 8, 16 or 32 chunks, and the low three bits of the chunk move).
template <int F>
__device__ __forceinline__ uint32_t swz(int row) {
  if (F >= 64) return uint32_t(row) & 7u;
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

// F = 128 and 256 start a chain with add(..., scale_d = 0)
template <>
struct Mma<128> {
  static __device__ __forceinline__ void add(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void add(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63, "
        " %64, %65, %66, %67, %68, %69, %70, %71, "
        " %72, %73, %74, %75, %76, %77, %78, %79, "
        " %80, %81, %82, %83, %84, %85, %86, %87, "
        " %88, %89, %90, %91, %92, %93, %94, %95, "
        " %96, %97, %98, %99, %100, %101, %102, %103, "
        " %104, %105, %106, %107, %108, %109, %110, %111, "
        " %112, %113, %114, %115, %116, %117, %118, %119, "
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
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

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// What the wide kernel and the layer kernel share: a producer warpgroup's
// and its consumers' registers, the block's shared-memory limit, cluster
// handshakes.

constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;                          // a block's shared memory

// the taps of row `row` of a 3-board tile that lie on its board (bit tap);
// none for the rows past the tile's boards
__device__ __forceinline__ uint32_t board_tap_mask(int row) {
  if (row >= kTileBoards * kArea) return 0u;
  const int p = row % kArea, r = p / kWidth, c = p % kWidth;
  uint32_t m = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int rr = r + tap / 3 - 1, cc = c + tap % 3 - 1;
    if (rr >= 0 && rr < kHeight && cc >= 0 && cc < kWidth) m |= 1u << tap;
  }
  return m;
}

__device__ __forceinline__ uint32_t special_reg(int which) {
  uint32_t v;
  switch (which) {
    case 0: asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v)); break;
    case 1: asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v)); break;
    default: asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v)); break;
  }
  return v;
}
// mbar_wait for barriers that span the blocks of a cluster: a wait that
// outlasts 2^33 clocks traps, which poisons the process's CUDA context (see
// "Layer kernel" in the header)
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (int i = 0;; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 33)) {
      asm volatile("trap;\n");
    }
  }
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// arrive on the barrier at `bar` (an offset in this block's shared memory) of
// block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
// the same bytes into `dst` and complete_tx on `bar` of every block in `mask`
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// F = 128 and 256 (see "Wide towers" in the header): a producer issues
// every weight copy, a weight stage is several slabs of one tap, multicast
// to the blocks of a cluster; the whole layer chained in one m64nF
// accumulator.

constexpr int kWideCluster128 = 1;  // blocks a weight stage is multicast to at F=128
constexpr int kWideCluster256 = 2;  // ... at F=256
constexpr int kWideStage128 = 4;    // 16-deep slabs a weight stage holds at F=128
constexpr int kWideStage256 = 4;    // ... at F=256

template <int F>
struct WideCfg {
  static constexpr int kConsumers = kWarpgroups * 128;  // two warpgroups, one 64-row tile each
  static constexpr int kThreads = kConsumers + 128;     // and a producer warpgroup
  static constexpr int kValidRows = kTileBoards * kArea;  // 126: X and Y hold these rows only
  static constexpr int kRB = 2 * F;                   // bytes per activation row
  static constexpr int kKS = F / 16;                  // slabs per tap
  static constexpr int kSlabBytes = 2 * F * 16;       // one 16-deep slab of a tap
  static constexpr int kCluster = F == 128 ? kWideCluster128 : kWideCluster256;
  // a stage: kStageSlabs consecutive slabs of one tap, one copy, one
  // full/empty barrier pair, one commit group
  static constexpr int kStageSlabs = F == 128 ? kWideStage128 : kWideStage256;
  static constexpr int kStageBytes = kStageSlabs * kSlabBytes;
  static constexpr int kBuffers = 2;                  // A fragment sets: one stage in flight while the next is issued
  static constexpr int kLayerStages = 9 * kKS / kStageSlabs;
  static constexpr int kActBytes = kValidRows * kRB;
  // offsets from a kRB-aligned base; X, Y and the zero row are aligned to
  // kRB, so a slab's ldmatrix address is the tap's XOR (ks << 5)
  static constexpr int kXOff = 0;
  static constexpr int kYOff = kActBytes;
  static constexpr int kZeroOff = 2 * kActBytes;      // one zero row
  static constexpr int kBiasOff = kZeroOff + kRB;     // float [2][F]
  static constexpr int kRingOff = kBiasOff + 2 * F * 4;
  // as many stages as fit (at most 8) beside the barriers (at most 17) and
  // the alignment slack
  static constexpr int kFit = (kSmemLimit - kRingOff - 17 * 8 - kRB) / kStageBytes;
  static constexpr int kWStages = kFit > 8 ? 8 : kFit;
  static constexpr int kBarOff = kRingOff + kWStages * kStageBytes;
  static constexpr int kSmem = kBarOff + (2 * kWStages + 1) * 8 + kRB;  // + alignment slack
  // the input conv stages conv1's weight image and the input planes in Y
  static constexpr int kXinOff = kYOff + F * kMaxK0 * 2;
  static_assert(F * kMaxK0 * 2 + 128 * 8 <= kActBytes, "input staging must fit Y");
  static_assert(kKS % kStageSlabs == 0 && kLayerStages % kBuffers == 0, "stages tile a tap, pairs a layer");
  static_assert(kWStages >= 3, "the ring holds the stage in use, the one in flight and one ahead");
  static_assert(kRingOff % 128 == 0 && kBarOff % 8 == 0, "alignment");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// bias, residual, LeakyReLU, round to bf16, store the valid rows of one
// 64-row tile swizzled (the rows past the tile's boards are not kept).
// Accumulator layout: d[4j + 2h + e] is row g + 8h, column 8j + 2t + e of the
// warp's 16 rows.
template <int F, bool kResidual>
__device__ __forceinline__ void wide_epilogue(const float (&acc)[F / 2], unsigned char* dst,
                                              const float* bias, int row_g, int t) {
#pragma unroll
  for (int j = 0; j < F / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_g + 8 * h;
      if (row < kTileBoards * kArea) {
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
}

// the consumer warpgroups' own barrier (the producer does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarpgroups * 128) : "memory");
}

template <int F>
__global__ void __launch_bounds__(WideCfg<F>::kThreads, 1)
tower_kernel_wide(const float* __restrict__ x, const __nv_bfloat16* __restrict__ conv1_img,
                  const __nv_bfloat16* __restrict__ conv1_b,
                  const __nv_bfloat16* __restrict__ res_img,
                  const __nv_bfloat16* __restrict__ res_b, __nv_bfloat16* __restrict__ out,
                  int n_boards, int cin0, int n_res_layers) {
  using C = WideCfg<F>;
  constexpr int ND = F / 2;  // accumulator registers per thread
  constexpr int W = C::kWStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((uint32_t(C::kRB) - (smem_u32(smem_raw) & uint32_t(C::kRB - 1))) & uint32_t(C::kRB - 1));
  unsigned char* X = smem + C::kXOff;
  unsigned char* Y = smem + C::kYOff;
  float* bias = reinterpret_cast<float*>(smem + C::kBiasOff);       // [2][F]
  uint16_t* xin = reinterpret_cast<uint16_t*>(smem + C::kXinOff);   // [rows][4] bf16 bits
  const uint32_t zero_s = smem_u32(smem + C::kZeroOff);
  const uint32_t x_s = smem_u32(X), y_s = smem_u32(Y);
  const uint32_t ring_s = smem_u32(smem + C::kRingOff);
  const uint32_t bar_s = smem_u32(smem + C::kBarOff);
  // barriers: full[s] at bar_s + 8s, empty[s] at bar_s + 8(W + s), conv1 last
  const auto w_full = [&](int s) { return bar_s + 8 * s; };
  const auto w_empty = [&](int s) { return bar_s + 8 * (W + s); };
  const uint32_t bar_c1 = bar_s + 16 * W;

  const int tid = threadIdx.x;
  const uint32_t rank = special_reg(0);
  const long row_base = long(blockIdx.x) * C::kValidRows;
  const long total_rows = long(n_boards) * kArea;
  // <= 0 in the pad block that rounds the grid up to whole clusters: it
  // takes part in every handshake and writes nothing
  const int valid_rows =
      int(total_rows - row_base < C::kValidRows ? total_rows - row_base : C::kValidRows);
  const int k0 = 9 * cin0;              // depth of the input conv
  const int ksteps0 = (k0 + 15) / 16;

  // --- barriers, tables and the input planes (rounded to bf16) -------------
  if (tid == 0) {
    for (int s = 0; s < W; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), C::kCluster * kWarpgroups * 4);  // lane 0 of each consumer warp of the cluster
    }
    mbar_init(bar_c1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < C::kRB / 4; i += C::kThreads)
    reinterpret_cast<uint32_t*>(smem + C::kZeroOff)[i] = 0u;
  for (int i = tid; i < 128 * 4; i += C::kThreads) {
    const int row = i >> 2, ci = i & 3;
    const float v = (ci < cin0 && row < valid_rows) ? x[(row_base + row) * cin0 + ci] : 0.f;
    xin[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  for (int i = tid; i < F; i += C::kThreads) {
    bias[i] = __bfloat162float(conv1_b[i]);
    if (n_res_layers > 0) bias[F + i] = __bfloat162float(res_b[i]);
  }
  __syncthreads();
  cluster_sync();  // every block's barriers are set before a multicast or a remote arrive

  if (tid >= C::kConsumers) {
    // --- the producer: one thread issues every copy in the order they are used
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == C::kConsumers) {
      const uint32_t c1_bytes = uint32_t(F) * ksteps0 * 16 * 2;
      mbar_expect_tx(bar_c1, c1_bytes);
      bulk_copy(y_s, conv1_img, c1_bytes, bar_c1);
      // Stage n holds slabs n*kStageSlabs ... of the residual image (one tap's
      // kStageSlabs consecutive slabs, in the order they are multiplied).
      // Ring slot s is filled by block s % kCluster, multicast to all: it
      // waits until every consumer warp of the cluster has released the
      // slot; the others expect the bytes once the slot's previous use has
      // landed here.
      const unsigned char* res_bytes = reinterpret_cast<const unsigned char*>(res_img);
      constexpr uint16_t kMask = uint16_t((1u << C::kCluster) - 1u);
      const int total = n_res_layers * C::kLayerStages;
      for (int n = 0; n < total; ++n) {
        const int s = n % W;
        const uint32_t use = uint32_t(n / W);
        if (uint32_t(s % C::kCluster) == rank) {
          if (use > 0) mbar_wait_or_trap(w_empty(s), (use - 1) & 1u);
          mbar_expect_tx(w_full(s), C::kStageBytes);
          const unsigned char* src = res_bytes + size_t(n) * C::kStageBytes;
          if constexpr (C::kCluster > 1)
            bulk_copy_multicast(ring_s + s * C::kStageBytes, src, C::kStageBytes, w_full(s), kMask);
          else
            bulk_copy(ring_s + s * C::kStageBytes, src, C::kStageBytes, w_full(s));
        } else {
          if (use > 0) mbar_wait_or_trap(w_full(s), (use - 1) & 1u);
          mbar_expect_tx(w_full(s), C::kStageBytes);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while another may still arrive on its barriers
    return;
  }

  // --- the consumers: two warpgroups of 64 rows, one m64nF accumulator each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int w4 = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // rows this thread addresses for ldmatrix (lane & 15) and owns in the
  // accumulator (g, g + 8) in its warpgroup's tile
  const int tile_row = wg * 64 + w4 * 16;
  const int row_l = tile_row + (lane & 15);
  const int row_g = tile_row + g;
  const uint32_t mask_l = board_tap_mask(row_l);

  float acc[ND];

  // --- input conv: A built in registers from the staged planes -------------
  mbar_wait(bar_c1, 0);
  {
    const int r0 = row_g, r1 = r0 + 8;
    const uint32_t m0 = board_tap_mask(r0), m1 = board_tap_mask(r1);
    // element k of the row's im2col row: tap k / cin0, channel k % cin0
    auto val = [&](int row, uint32_t m, int k) -> uint32_t {
      if (k >= k0) return 0u;
      const int tap = k / cin0, ci = k - tap * cin0;
      if (!((m >> tap) & 1u)) return 0u;
      return uint32_t(xin[(row + (tap / 3 - 1) * kWidth + (tap % 3 - 1)) * 4 + ci]);
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
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kMaxK0 / 16; ++s)
      if (s < ksteps0) Mma<F>::add(acc, a[s], b_desc<F>(y_s + s * C::kSlabBytes), s > 0 ? 1u : 0u);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    wide_epilogue<F, false>(acc, X, bias, row_g, t);
  }

  // --- residual blocks: layer l reads X (even l) or Y (odd l) --------------
  constexpr int S = C::kStageSlabs;
  constexpr int NB = C::kBuffers;
  // this warp's share of the products has read stage `at`
  auto release = [&](int at) {
    if (lane == 0) {
      const int s = at % W;
      mbar_arrive_cluster(w_empty(s), uint32_t(s % C::kCluster));
    }
  };
  int n0 = 0;  // the layer's first stage, counted over the whole tower
  for (int l = 0; l < n_res_layers; ++l, n0 += C::kLayerStages) {
    consumer_sync();  // the previous layer's output is complete
    for (int i = tid; i < F && l + 1 < n_res_layers; i += C::kConsumers)
      bias[((l + 1) & 1 ? 0 : F) + i] = __bfloat162float(res_b[(l + 1) * F + i]);
    const bool odd = l & 1;
    const uint32_t src_s = odd ? y_s : x_s;
    unsigned char* dst = odd ? X : Y;
    const float* lbias = bias + (odd ? 0 : F);

    // Stage j of the layer (slabs jS ... jS + S - 1, of one tap) is one
    // commit group with its A fragments in set j % NB. Once it is issued,
    // the stage before it has been multiplied and is released.
    uint32_t a[NB][S][4];
#pragma unroll 1
    for (int j0 = 0; j0 < C::kLayerStages; j0 += NB) {
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int j = j0 + u;
        const int tap = j * S / C::kKS;
        const int kk = j * S % C::kKS;
        const int src_row = row_l + (tap / 3 - 1) * kWidth + (tap % 3 - 1);
        const uint32_t a_off =
            uint32_t(src_row) * C::kRB + ((uint32_t(lane >> 4) ^ swz<F>(src_row)) << 4);
        const uint32_t a_s = ((mask_l >> tap) & 1u) ? src_s + a_off : zero_s + (a_off & uint32_t(C::kRB - 1));
#pragma unroll
        for (int i = 0; i < S; ++i) ldmatrix_x4(a[u][i], a_s ^ uint32_t((kk + i) << 5));
        const int at = n0 + j;
        mbar_wait_or_trap(w_full(at % W), uint32_t(at / W) & 1u);
        const uint32_t w_s = ring_s + (at % W) * C::kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < S; ++i)
          Mma<F>::add(acc, a[u][i], b_desc<F>(w_s + i * C::kSlabBytes), (j > 0 || i > 0) ? 1u : 0u);
        wgmma_commit();
        // unconditional, so that the compiler sees every fragment set free
        // before it is loaded again (a wait in a branch makes it serialise
        // the products)
        wgmma_wait<NB - 1>();
        if (j >= NB - 1) release(at - (NB - 1));
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    for (int i = NB - 1; i > 0; --i) release(n0 + C::kLayerStages - i);

    if (odd)
      wide_epilogue<F, true>(acc, dst, lbias, row_g, t);
    else
      wide_epilogue<F, false>(acc, dst, lbias, row_g, t);
  }
  consumer_sync();

  // --- store the tile's valid rows, un-swizzled ---------------------------
  constexpr int kVec = F / 8;
  for (int i = tid; i < valid_rows * kVec; i += C::kConsumers) {
    const int row = i / kVec, c = i % kVec;
    reinterpret_cast<uint4*>(out + (row_base + row) * F)[c] =
        *reinterpret_cast<const uint4*>(X + row * C::kRB + ((uint32_t(c) ^ swz<F>(row)) << 4));
  }
  cluster_sync();
}

template <int F>
int launch_wide(const float* x, const __nv_bfloat16* conv1_img, const __nv_bfloat16* conv1_b,
                const __nv_bfloat16* res_img, const __nv_bfloat16* res_b, __nv_bfloat16* out,
                int n_boards, int cin0, int n_res_layers, cudaStream_t stream) {
  using C = WideCfg<F>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(tower_kernel_wide<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  // one block a 3-board tile, rounded up to whole clusters (tower.wide_grid)
  const int blocks = (n_boards + kTileBoards - 1) / kTileBoards;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(C::kCluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned((blocks + C::kCluster - 1) / C::kCluster * C::kCluster));
  cfg.blockDim = dim3(unsigned(C::kThreads));
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, tower_kernel_wide<F>, x, conv1_img, conv1_b, res_img, res_b, out,
                                       n_boards, cin0, n_res_layers);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// Towers wider than 256 filters (see "Layer kernel" in the header): one conv
// layer a launch at a packed width Fp = T x N, N = 160, 192, 224 or 256
// columns a unit of work.

// wgmma m64nNk16 at the layer kernel's column tiles (N = 256 is above): the
// accumulator's register names and operands 16 at a time
#define C4_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define C4_R1 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define C4_R2 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define C4_R3 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define C4_R4 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define C4_R5 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define C4_R6 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define C4_D16(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]),    \
      "+f"(d[i + 6]), "+f"(d[i + 7]), "+f"(d[i + 8]), "+f"(d[i + 9]), "+f"(d[i + 10]),          \
      "+f"(d[i + 11]), "+f"(d[i + 12]), "+f"(d[i + 13]), "+f"(d[i + 14]), "+f"(d[i + 15])
// N, the accumulator's register names, then the operand numbers of the A
// fragment, the descriptor and scale-d, then the accumulator's operands
#define C4_MMA(N_, REGS, A, DESC, SCALE, ...)                                                   \
  template <>                                                                                   \
  struct Mma<N_> {                                                                              \
    static __device__ __forceinline__ void add(float (&d)[N_ / 2], const uint32_t (&a)[4],      \
                                               uint64_t desc, uint32_t scale_d) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SCALE ", 0;\n"                         \
                   "wgmma.mma_async.sync.aligned.m64n" #N_ "k16.f32.bf16.bf16 {" REGS "}, " A  \
                   ", %" #DESC ", p, 1, 1, 0;\n}\n"                                             \
                   : __VA_ARGS__                                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));      \
    }                                                                                           \
  };
C4_MMA(160, C4_R0 C4_R1 C4_R2 C4_R3 C4_R4, "{%80, %81, %82, %83}", 84, 85,
       C4_D16(0), C4_D16(16), C4_D16(32), C4_D16(48), C4_D16(64))
C4_MMA(192, C4_R0 C4_R1 C4_R2 C4_R3 C4_R4 C4_R5, "{%96, %97, %98, %99}", 100, 101,
       C4_D16(0), C4_D16(16), C4_D16(32), C4_D16(48), C4_D16(64), C4_D16(80))
C4_MMA(224, C4_R0 C4_R1 C4_R2 C4_R3 C4_R4 C4_R5 C4_R6, "{%112, %113, %114, %115}", 116, 117,
       C4_D16(0), C4_D16(16), C4_D16(32), C4_D16(48), C4_D16(64), C4_D16(80), C4_D16(96))
#undef C4_MMA
#undef C4_D16
#undef C4_R0
#undef C4_R1
#undef C4_R2
#undef C4_R3
#undef C4_R4
#undef C4_R5
#undef C4_R6

constexpr int kLayerConsumers = 2;                         // warpgroups multiplying, 64 rows each
constexpr int kLayerThreads = (kLayerConsumers + 1) * 128;  // and one producer warpgroup
constexpr int kProducer = kLayerConsumers * 128;            // the thread that issues every copy
constexpr int kSlabChannels = 64;                           // input channels a staged k-slab holds
constexpr int kInStages = 2;                                // the input ring: 2 k-slabs of 16 KB
constexpr int kInSlabBytes = 128 * kSlabChannels * 2;       // [128 rows][64 channels] bf16
constexpr int kCluster = 2;                                 // blocks a weight stage is multicast to

template <int N>
struct LayerCfg {
  static constexpr int kValidRows = kTileBoards * kArea;        // 126 of the 128 rows
  static constexpr int kSlabBytes = 2 * 16 * N;                 // one 16-deep weight slab of a column tile
  // A weight stage is one tap of an input k-slab: 4 slabs, 64 x N, one copy
  // and one commit group (4 products). Copies this large keep the single
  // issuing thread's few hundred clocks a copy off the critical path.
  static constexpr int kStageBytes = 4 * kSlabBytes;
  static constexpr int kBuffers = 3;                            // A fragment sets: 2 groups in flight
  // offsets from a 1024-byte aligned base (the 128-byte swizzle of a tensor
  // copy repeats every 1024 bytes)
  static constexpr int kInOff = 0;
  static constexpr int kZeroOff = kInStages * kInSlabBytes;     // one zero row of 128 bytes
  static constexpr int kRingOff = kZeroOff + 1024;
  // as many stages as fit, at most 8, an even number (stage s is filled by
  // block s % kCluster)
  static constexpr int kFit = (kSmemLimit - kRingOff - 2048) / kStageBytes;
  static constexpr int kWStages = (kFit > 8 ? 8 : kFit) & ~1;
  static constexpr int kBarOff = kRingOff + kWStages * kStageBytes;
  // in_full[kInStages], in_empty[kInStages], w_full[kWStages], w_empty[kWStages]
  static constexpr int kSmem = kBarOff + 2 * (kInStages + kWStages) * 8 + 1024;  // + alignment slack
  static_assert(kStageBytes % 1024 == 0 && kBarOff % 8 == 0, "alignment");
  static_assert(9 % kBuffers == 0, "a k-slab's 9 groups cycle through the fragment sets");
  static_assert(kWStages >= 4 && kWStages % kCluster == 0, "ring");
  static_assert(kMaxK0 / 16 <= 4, "the input conv's slabs fit one stage");
  static_assert(kSmem <= kSmemLimit, "a block's shared memory");
};

// the box at (x = channel, y = row) of a tensor map, swizzled as the map says
__device__ __forceinline__ void tensor_copy_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// One conv of the tower: out[rows, :] = lrelu(sum over taps and channels of
// in x W + b (+ skip)), rounded to bf16, at a packed width fp = T * N (T
// column tiles of N). kFirst: the input conv on float32 planes [rows, cin];
// otherwise the previous layer's bf16 output [rows, fp], read through
// `in_map` in [128 rows, 64 channels] k-slabs. `skip` (or null) is added in
// float32 before the LeakyReLU; it may be `out` itself, since each element
// is read and then written by one thread. A unit of work is one column tile
// of the row tiles of a cluster's blocks (3 boards each); each cluster walks
// its units in turn (see "Layer kernel" in the header).
template <int N, bool kFirst>
__global__ void __launch_bounds__(kLayerThreads, 1)
tower_layer(const __grid_constant__ CUtensorMap in_map, const float* __restrict__ planes,
            const __nv_bfloat16* __restrict__ w_img, const __nv_bfloat16* __restrict__ bias_g,
            const __nv_bfloat16* skip, __nv_bfloat16* out, int n_boards, int cin, int fp) {
  using C = LayerCfg<N>;
  constexpr int ND = N / 2;  // accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t in_s = smem_u32(smem + C::kInOff), zero_s = smem_u32(smem + C::kZeroOff);
  const uint32_t ring_s = smem_u32(smem + C::kRingOff), bar_s = smem_u32(smem + C::kBarOff);
  const auto in_full = [&](int s) { return bar_s + 8 * s; };
  const auto in_empty = [&](int s) { return bar_s + 8 * (kInStages + s); };
  const auto w_full = [&](int s) { return bar_s + 8 * (2 * kInStages + s); };
  const auto w_empty = [&](int s) { return bar_s + 8 * (2 * kInStages + C::kWStages + s); };

  const int tid = threadIdx.x;
  const uint32_t rank = special_reg(0);
  const int cluster = int(special_reg(1)), n_clusters = int(special_reg(2));
  const int tiles = fp / N;
  const int row_tiles = (n_boards + kTileBoards - 1) / kTileBoards;
  const int n_units = (row_tiles + kCluster - 1) / kCluster * tiles;
  const int in_slabs = kFirst ? 0 : fp / kSlabChannels;
  const int ksteps0 = (9 * cin + 15) / 16;
  // weight slabs of a unit, in the order the image holds them, a column tile
  // after another (tower.layer_image); a stage takes one tap of a k-slab
  // (the input conv: all its slabs)
  const int unit_slabs = kFirst ? ksteps0 : in_slabs * 36;
  const uint32_t stage_bytes = kFirst ? uint32_t(ksteps0) * C::kSlabBytes : C::kStageBytes;
  const long total_rows = long(n_boards) * kArea;
  const unsigned char* w_bytes = reinterpret_cast<const unsigned char*>(w_img);

  if (tid == 0) {
    for (int s = 0; s < kInStages; ++s) {
      mbar_init(in_full(s), 1);
      mbar_init(in_empty(s), kLayerConsumers * 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < C::kWStages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), kCluster * kLayerConsumers * 4);  // ... of every block of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 32; i += kLayerThreads) reinterpret_cast<uint32_t*>(smem + C::kZeroOff)[i] = 0u;
  __syncthreads();
  cluster_sync();  // every block's barriers are set before a multicast or a remote arrive

  if (tid >= kProducer) {
    // --- the producer: one thread issues every copy in the order they are used
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kProducer) {
      constexpr uint16_t kMask = uint16_t((1u << kCluster) - 1u);
      int in_n = 0, w_n = 0;  // k-slabs and weight stages issued so far
      for (int unit = cluster; unit < n_units; unit += n_clusters) {
        const int tile_n = unit % tiles;
        const int row_tile = (unit / tiles) * kCluster + int(rank);
        const unsigned char* w_tile = w_bytes + size_t(tile_n) * unit_slabs * C::kSlabBytes;
        // Weight stage s is filled by block s % kCluster, multicast to all: it
        // waits until every consumer warp of the cluster has released the
        // stage; the others expect the bytes once the stage's previous use
        // has landed here.
        auto load_w = [&](const unsigned char* src) {
          const int s = w_n % C::kWStages;
          const uint32_t use = uint32_t(w_n / C::kWStages);
          if (uint32_t(s % kCluster) == rank) {
            if (use > 0) mbar_wait_or_trap(w_empty(s), (use - 1) & 1u);
            mbar_expect_tx(w_full(s), stage_bytes);
            bulk_copy_multicast(ring_s + s * C::kStageBytes, src, stage_bytes, w_full(s), kMask);
          } else {
            if (use > 0) mbar_wait_or_trap(w_full(s), (use - 1) & 1u);
            mbar_expect_tx(w_full(s), stage_bytes);
          }
          ++w_n;
        };
        if constexpr (kFirst) {
          load_w(w_tile);
        } else {
          for (int k = 0; k < in_slabs; ++k) {
            const int s = in_n % kInStages;
            const uint32_t use = uint32_t(in_n / kInStages);
            if (use > 0) mbar_wait_or_trap(in_empty(s), (use - 1) & 1u);
            mbar_expect_tx(in_full(s), kInSlabBytes);
            tensor_copy_2d(in_s + s * kInSlabBytes, &in_map, k * kSlabChannels, row_tile * C::kValidRows,
                           in_full(s));
            ++in_n;
            for (int tap = 0; tap < 9; ++tap) load_w(w_tile + size_t(k * 9 + tap) * C::kStageBytes);
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while another may still arrive on its barriers
  } else {
    // --- the consumers: two warpgroups of 64 rows, one m64nN accumulator each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid & 31;
    const int wg = tid >> 7;
    const int w4 = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    // rows this thread addresses for ldmatrix (lane & 15) and owns in the
    // accumulator (g, g + 8) in its warpgroup's tile
    const int tile_row = wg * 64 + w4 * 16;
    const int row_l = tile_row + (lane & 15);
    const int row_g = tile_row + g;
    const uint32_t mask_l = board_tap_mask(row_l);
    int in_n = 0, w_n = 0;  // k-slabs and weight stages taken so far

    // this warp's share of the products has read weight stage `at`
    auto release_w = [&](int at) {
      if (lane == 0) {
        const uint32_t s = uint32_t(at) % C::kWStages;
        mbar_arrive_cluster(w_empty(int(s)), s % kCluster);
      }
    };
    auto wait_w = [&](int at) -> uint32_t {  // returns the stage's address
      const int s = at % C::kWStages;
      mbar_wait_or_trap(w_full(s), uint32_t(at / C::kWStages) & 1u);
      return ring_s + s * C::kStageBytes;
    };

    float acc[ND];  // a unit's chain starts from zero (scale-d 0); set once for the compiler
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.f;
    for (int unit = cluster; unit < n_units; unit += n_clusters) {
      const int tile_n = unit % tiles;
      const long row_base = long((unit / tiles) * kCluster + int(rank)) * C::kValidRows;
      const long left = total_rows - row_base;
      const int valid_rows = int(left < 0 ? 0 : (left < C::kValidRows ? left : C::kValidRows));

      if constexpr (kFirst) {
        // --- the input conv: A built in registers from the float32 planes --
        const int r0 = row_g, r1 = r0 + 8;
        const uint32_t m0 = r0 < valid_rows ? board_tap_mask(r0) : 0u;
        const uint32_t m1 = r1 < valid_rows ? board_tap_mask(r1) : 0u;
        auto val = [&](int row, uint32_t m, int k) -> uint32_t {
          if (k >= 9 * cin) return 0u;
          const int tap = k / cin, ci = k - tap * cin;
          if (!((m >> tap) & 1u)) return 0u;
          const long src = row_base + row + (tap / 3 - 1) * kWidth + (tap % 3 - 1);
          return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(planes[src * cin + ci])));
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
        const uint32_t w_s = wait_w(w_n);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kMaxK0 / 16; ++s)
          if (s < ksteps0) Mma<N>::add(acc, a[s], b_desc<N>(w_s + s * C::kSlabBytes), s > 0 ? 1u : 0u);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        release_w(w_n);
        ++w_n;
      } else {
        // --- a residual conv: k-slab by k-slab, 9 taps x 4 steps each, one
        // chain from zero in (k-slab, tap, channel) order ------------------
        // Commit group j of a k-slab: the 4 products of tap j (one weight
        // stage), their A fragments in set j % NB. Up to NB - 1 groups stay
        // in flight; the stage of the group that has just completed is
        // released.
        constexpr int NB = C::kBuffers;
        uint32_t a[NB][4][4];
        int issued = 0;  // groups of this unit
        auto step = [&](uint32_t (&frag)[4][4], uint32_t slab_s, int tap, bool first) {
          // row src_row of the slab: 128 bytes, 16-byte chunk c at c ^ (src_row & 7);
          // an off-board tap reads the zero row
          const int src_row = row_l + (tap / 3 - 1) * kWidth + (tap % 3 - 1);
          const uint32_t row_s = ((mask_l >> tap) & 1u) ? slab_s + uint32_t(src_row) * 128u : zero_s;
          const uint32_t swz = uint32_t(src_row) & 7u;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(frag[kk], row_s + ((uint32_t(2 * kk + (lane >> 4)) ^ swz) << 4));
          const uint32_t w_s = wait_w(w_n);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<N>::add(acc, frag[kk], b_desc<N>(w_s + kk * C::kSlabBytes), (first && kk == 0) ? 0u : 1u);
          wgmma_commit();
          // unconditional, so that the compiler sees every fragment set free
          // before it is loaded again (a wait in a branch makes it
          // serialise the products)
          wgmma_wait<NB - 1>();
          if (issued >= NB - 1) release_w(w_n - (NB - 1));
          ++issued;
          ++w_n;
        };
#pragma unroll 1
        for (int k = 0; k < in_slabs; ++k) {
          const int s = in_n % kInStages;
          mbar_wait_or_trap(in_full(s), uint32_t(in_n / kInStages) & 1u);
          const uint32_t slab_s = in_s + s * kInSlabBytes;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) step(a[tap % NB], slab_s, tap, k == 0 && tap == 0);
          // the k-slab's fragments are in registers: its stage is free
          if (lane == 0) mbar_arrive(in_empty(s));
          ++in_n;
        }
      }

      // --- bias, skip, LeakyReLU, round to bf16, store the valid rows -------
      // Accumulator layout: acc[4j + 2h + e] is row g + 8h, column 8j + 2t + e
      // of the warp's 16 rows and the unit's column tile. The skip (which may
      // be `out`) is read whole before the last products end and before any
      // store, so that its loads overlap instead of queueing behind stores.
      const int n0 = tile_n * N;
      __nv_bfloat162 sk[N / 4];  // the skip's pairs, index 2j + h
      if (skip != nullptr) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row_g + 8 * h;
            if (row < valid_rows)
              sk[2 * j + h] = *reinterpret_cast<const __nv_bfloat162*>(
                  skip + size_t(row_base + row) * fp + n0 + 8 * j + 2 * t);
          }
      }
      if constexpr (!kFirst) {
        wgmma_wait<0>();
        reg_fence(acc);
        for (int i = C::kBuffers - 1; i > 0; --i) release_w(w_n - i);
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_g + n0 + 8 * j + 2 * t));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_g + 8 * h;
          if (row < valid_rows) {
            const size_t at = size_t(row_base + row) * fp + n0 + 8 * j + 2 * t;
            float y0 = acc[4 * j + 2 * h] + b.x;
            float y1 = acc[4 * j + 2 * h + 1] + b.y;
            if (skip != nullptr) {
              const float2 x = __bfloat1622float2(sk[2 * j + h]);
              y0 += x.x;
              y1 += x.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(lrelu(y0), lrelu(y1));
          }
        }
      }
    }
    cluster_sync();
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no libcuda); null if the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int N, bool kFirst>
int launch_layer(const void* in, const __nv_bfloat16* w_img, const __nv_bfloat16* bias,
                 const __nv_bfloat16* skip, __nv_bfloat16* out, int n_boards, int cin, int fp,
                 cudaStream_t stream) {
  static bool configured = false;
  static int max_clusters = 0;  // clusters resident at once
  const auto kernel = tower_layer<N, kFirst>;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LayerCfg<N>::kSmem);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (!kFirst) {
    // the input [rows, fp] bf16 in boxes of [128 rows, 64 channels], 128-byte
    // swizzled; rows past the end read as 0
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return int(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {cuuint64_t(fp), cuuint64_t(n_boards) * kArea};
    const cuuint64_t strides[1] = {cuuint64_t(fp) * 2};
    const cuuint32_t box[2] = {kSlabChannels, 128};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(in), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return int(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(kCluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kLayerThreads);
  cfg.dynamicSmemBytes = LayerCfg<N>::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters == 0) {
    cfg.gridDim = dim3(unsigned(kCluster));
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return int(err);
    if (n < 1) return int(cudaErrorInvalidConfiguration);
    max_clusters = n;
  }
  const int row_tiles = (n_boards + kTileBoards - 1) / kTileBoards;
  const int units = (row_tiles + kCluster - 1) / kCluster * (fp / N);
  const int clusters = units < max_clusters ? units : max_clusters;
  cfg.gridDim = dim3(unsigned(clusters * kCluster));
  const float* planes = kFirst ? static_cast<const float*>(in) : nullptr;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map, planes, w_img, bias, skip, out, n_boards, cin, fp);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// the column tile of a packed layer width: the widest of 256, 224, 192, 160
// that divides it (tower.layer_tile), 0 for a width the layer kernel does not take
int layer_tile(int fp) {
  if (fp <= 256 || fp % kSlabChannels != 0) return 0;
  const int widths[4] = {256, 224, 192, 160};
  for (int n : widths)
    if (fp % n == 0) return n;
  return 0;
}

}  // namespace

extern "C" {

// x: [n_boards*42, cin0] f32; conv1_img: [F * 16*ceil(9*cin0/16)] bf16 and
// res_img: [n_res_layers, 9, F*F] bf16, the shared-memory images that
// tower.py::pack_weights makes (8x8 core matrices, element (n, k) of a tap at
// ((k/8 * F/8 + n/8) * 8 + n%8) * 8 + k%8); conv1_b: [F] bf16; res_b:
// [n_res_layers, F] bf16; out: [n_boards*42, F] bf16; F one of 16, 32, 64,
// 128, 256. chain is one of the kChain* values; the chains that are not
// shipped are built at F=64 only (they are there to be measured). Returns a
// cudaError_t (cudaErrorInvalidValue for a combination it does not take).
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
  if (filters == 128 && chain == kShippedChain)
    return launch_wide<128>(xp, w1, b1, wr, br, o, n_boards, cin0, n_res_layers, s);
  if (filters == 256 && chain == kShippedChain)
    return launch_wide<256>(xp, w1, b1, wr, br, o, n_boards, cin0, n_res_layers, s);
  return int(cudaErrorInvalidValue);
}

// The shipped kernel: chain kShippedChain.
int c4_tower_forward(const void* x, const void* conv1_img, const void* conv1_b,
                     const void* res_img, const void* res_b, void* out, int n_boards,
                     int cin0, int filters, int n_res_layers, void* stream) {
  return c4_tower_forward_chain(x, conv1_img, conv1_b, res_img, res_b, out, n_boards, cin0,
                                filters, n_res_layers, kShippedChain, stream);
}

// One conv of a tower wider than 256 filters (the layer kernel), at a packed
// width `filters` (tower.kernel_width: a multiple of 64 above 256 that one of
// 256, 224, 192, 160 divides; the column tile N is the widest that does, and
// T = filters / N). first != 0: the input conv, `in` float32 [n_boards*42,
// cin] with cin <= 4, `w_img` conv1's image [T, 16*ceil(9*cin/16) * N] and
// `skip` null. Otherwise a residual conv, `in` bf16 [n_boards*42, filters],
// cin == filters, `w_img` the layer's image [T, 9*filters * N]
// (tower.layer_image: per column tile, its 16-deep slabs in (k-slab of 64
// channels, tap, channel) order, each as smem_image lays it out) and `skip`
// null or bf16 [n_boards*42, filters], which may be `out`. bias: [filters]
// bf16; out: bf16 [n_boards*42, filters]. Returns a cudaError_t
// (cudaErrorInvalidValue for a combination it does not take).
int c4_tower_layer(const void* in, const void* w_img, const void* bias, const void* skip, void* out,
                   int n_boards, int cin, int filters, int first, void* stream) {
  if (n_boards <= 0) return int(cudaSuccess);
  const int n = layer_tile(filters);
  if (n == 0 || (first ? (cin < 1 || cin > kMaxCin0 || skip != nullptr) : cin != filters))
    return int(cudaErrorInvalidValue);
  const auto* w = static_cast<const __nv_bfloat16*>(w_img);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  const auto* k = static_cast<const __nv_bfloat16*>(skip);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
#define C4_LAYER(N_)                                                                        \
  if (n == N_)                                                                              \
    return first ? launch_layer<N_, true>(in, w, b, k, o, n_boards, cin, filters, s) \
                 : launch_layer<N_, false>(in, w, b, k, o, n_boards, cin, filters, s);
  C4_LAYER(160)
  C4_LAYER(192)
  C4_LAYER(224)
  C4_LAYER(256)
#undef C4_LAYER
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
