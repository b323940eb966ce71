// 3x3 stride-1 SAME convolution + bias (+ ReLU) on NHWC bf16, for Hopper.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * unetseg_tpu/ops/pallas_conv.py::conv3x3_bias_act  (kernel _kernel,
//     pallas_call at :189) for C >= 128, and
//   * unetseg_tpu/ops/pallas_conv.py::_conv3x3_small_c  (kernel
//     _kernel_small_c, pallas_call at :123) for C < 128.
// Both are one implicit-GEMM kernel built on TMA, mbarriers and wgmma.
//
// Numerics follow the Pallas kernel (pallas_conv.py:72-77): products in
// bf16, sums in f32 over all 9 taps x C, then bias in f32, optional ReLU and
// one rounding to bf16.
//
// GEMM view: M = output pixels, N = D output channels, K = 9*C in the order
// (tap, channel), tap = dy*3 + dx.  Each block computes one tile of 128
// pixels x BN channels.  The 128 pixels are Rt rows x Wt columns of one image
// (Wt = min(128, next power of two >= W), Rt = 128 / Wt), so a tile never
// crosses an image; the tile plan is computed in Python (ops/conv.py
// tile_plan) and passed in.
//
// What bounds each layer class on the H100 (989 TFLOP/s bf16, 3.35 TB/s
// from device memory):
//   * C >= 128 (K1; the flagship's deep layers reach C = 1024, K = 9216):
//     the tensor cores, fed from shared memory by wgmma, and in practice the
//     bytes each block pulls from L2 for its products (every tile re-reads
//     its input boxes and the whole weight slice).  So the tiles are as
//     large as the registers allow: 128 x 256 at D >= 256 (one block per
//     SM), else 128 x 128 (two blocks per SM), and the dx fold below cuts
//     the input boxes to a third.
//   * C < 128 (K2: C = 16 and 64): device-memory bytes and each tile's fixed
//     cost (the first TMA round trip, a short K loop of 9 or 18 slices, the
//     epilogue).  Three blocks per SM at BN = 64 and two at BN = 128 overlap
//     one block's fixed cost with another's loads; deep rings of small
//     slices keep many loads in flight.
//
// Operands:
//   * A by 4-D TMA over x seen as (C, W, H, B): one box (BKc, Wt, Rt, 1) per
//     (tap, channel chunk) at (c0, w0+dx-1, h0+dy-1, b).  TMA fills zeros
//     outside the tensor, so SAME padding and ragged edges cost no
//     instruction and no pad pass.  BKc (64, 32 or 16, the largest dividing
//     C) is one swizzle row (128-, 64- or 32-byte swizzle), so the landed box
//     is the K-major A tile wgmma reads, and no K tail occurs.
//   * The dx fold (Wt >= 64, BN <= 128): one box (BKc, Wt + 2, Rt, 1) per
//     (dy, chunk) at (c0, w0-1, h0+dy-1, b); the three dx taps read it as
//     views that start dx pixel rows further in.  Each 64-pixel warpgroup
//     half then lies in one image row, so its view is 64 consecutive rows.
//     It is the TPU small-C kernel's dx fold, done with descriptors instead
//     of a folded copy of the input.
//   * B by 2-D TMA over the HWIO weight seen as (9C, D), as it is: boxes of
//     BKc rows x 64 channels with the 128-byte swizzle, read by wgmma as an
//     MN-major operand (transpose bit set).  That keeps the model's one
//     weight tensor, with no K-major copy to build or keep beside it.
//
// Pipeline: one producer warp (one elected thread issues every TMA) and two
// consumer warpgroups, each running wgmma m64nBNk16 on one 64-row half of
// the tile with f32 accumulators in registers.  A boxes and B slices have
// rings of their own, each slot with a full barrier that carries the TMA
// byte count and an empty barrier on which every consumer warp arrives once
// its wgmmas on the slot have retired.  With one producer warp (288
// threads) the registers at launch already cover the consumers'
// accumulators (at most 168 a thread at BN = 256), so no setmaxnreg is
// needed.  The epilogue adds the bias, applies the ReLU, rounds once,
// stages the tile in the ring's shared memory and writes 16 bytes per
// thread, masking pixels past H or W and channels past D.

#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                     // output pixels per tile
constexpr int CONSUMERS = 2;                // warpgroups, 64 pixel rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int MAX_STAGES = 12;
constexpr int EPAD = 8;                     // bf16 row padding, epilogue tile

template <int BKC, int BN, bool FOLD>
struct Cfg {
  // Several blocks per SM, so one block's prologue and epilogue overlap
  // another's main loop: three at BN = 64 (32 accumulators a thread), two
  // at BN = 128; BN = 256 (128 accumulators a thread) runs one.
  static constexpr int BLOCKS_PER_SM = BN == 256 ? 1 : BN == 128 ? 2 : 3;
  static constexpr int RING_BUDGET =
      BN == 256 ? 200 * 1024 : BN == 128 ? 108 * 1024 : 66 * 1024;
  // Taps per A box: 3 when the box spans the tile's Wt + 2 columns and each
  // dx is a view one row further into it (the dx fold), else 1.
  static constexpr int TAPS = FOLD ? 3 : 1;
  // A slot: 128 pixel rows, or up to (Wt + 2) * Rt <= 132 rows when folded;
  // a multiple of 1024 bytes, so every box and the B ring after the A
  // slots start on a 128-byte swizzle repeat.
  static constexpr int A_SLOT =
      ((FOLD ? 132 : BM) * BKC * 2 + 1023) / 1024 * 1024;
  static constexpr int B_BOX = BKC * 128;  // BKc rows x 64 channels
  static constexpr int B_SLOT = (BN / 64) * B_BOX;
  static constexpr int cap(int n) { return n < MAX_STAGES ? n : MAX_STAGES; }
  // Unfolded, A and B advance together; folded, two A slots and as many
  // B slots as the rest of the budget holds.
  static constexpr int A_STAGES =
      FOLD ? 2 : cap(RING_BUDGET / (A_SLOT + B_SLOT));
  static constexpr int B_STAGES =
      FOLD ? cap((RING_BUDGET - 2 * A_SLOT) / B_SLOT) : A_STAGES;
  static constexpr int RING = A_STAGES * A_SLOT + B_STAGES * B_SLOT;
  static constexpr int EPI = BM * (BN + EPAD) * 2;
  static constexpr int DATA = RING > EPI ? RING : EPI;
  // 1024 bytes of slack to align the ring, then the full and empty
  // barriers of the A slots and of the B slots.
  static constexpr int SMEM = 1024 + DATA + 16 * (A_STAGES + B_STAGES);
  // wgmma layout type of A: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle.
  static constexpr uint64_t A_LAYOUT = BKC == 64 ? 1 : BKC == 32 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle layout type.  The base
// offset field (bits 49-51) stays 0: wgmma applies the swizzle to absolute
// shared-memory address bits, as TMA does, so a view that starts some rows
// into a swizzled box (the dx fold) needs only its start address.  (Setting
// the field to the start row's phase in the pattern gave wrong products on
// the H100.)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, K-major) * B (16 x N, MN-major): the
// trailing immediates are scale-a, scale-b, transpose-a (0: K-major) and
// transpose-b (1: MN-major).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, da, db);
  else if constexpr (BN == 128)
    wgmma_m64n128k16(d, da, db);
  else
    wgmma_m64n64k16(d, da, db);
}

__device__ __forceinline__ void bar_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

template <int BKC, int BN, bool FOLD>
__global__ void __launch_bounds__(THREADS, Cfg<BKC, BN, FOLD>::BLOCKS_PER_SM)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int W, int C,
                     int D, int wt, int rt, int tiles_w, int tiles_h,
                     int tiles_n, int relu) {
  using K = Cfg<BKC, BN, FOLD>;
  extern __shared__ uint8_t smem_raw[];
  // The ring starts on a 1024-byte boundary: the 128-byte swizzle repeats
  // every 1024 bytes, and TMA and wgmma must see the same phase of it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t a_ring = ring, b_ring = ring + K::A_STAGES * K::A_SLOT;
  const uint32_t a_full = ring + K::DATA, a_empty = a_full + 8 * K::A_STAGES;
  const uint32_t b_full = a_empty + 8 * K::A_STAGES;
  const uint32_t b_empty = b_full + 8 * K::B_STAGES;

  // Tile coordinates; the channel tile varies fastest, so neighbouring
  // blocks share their input boxes in L2.
  int t = blockIdx.x;
  const int tn = t % tiles_n;
  t /= tiles_n;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  const int b = t / tiles_h;
  const int n0 = tn * BN, w0 = tw * wt, h0 = th * rt;
  const int chunks = C / BKC;
  // A boxes: (tap, chunk), or (dy, chunk) when folded; each feeds TAPS B
  // slices of BKc weight rows.  Tap-outer, channel chunk inner.
  const int a_iters = 9 / K::TAPS * chunks;

  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::A_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    for (int s = 0; s < K::B_STAGES; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // Producer: one thread keeps both rings full.
    if (threadIdx.x % 32 == 0) {
      const int a_bytes = FOLD ? (wt + 2) * rt * BKC * 2 : K::A_SLOT;
      int ib = 0;
      for (int ia = 0; ia < a_iters; ++ia) {
        const int sa = ia % K::A_STAGES;
        if (ia >= K::A_STAGES)  // round ia/A_STAGES - 1 released
          mbar_wait(a_empty + 8 * sa, (ia / K::A_STAGES - 1) & 1);
        const int tap0 = FOLD ? ia / chunks * 3 : ia / chunks;
        const int c0 = ia % chunks * BKC;
        mbar_expect_tx(a_full + 8 * sa, a_bytes);
        tma_load_4d(a_ring + sa * K::A_SLOT, &xmap, a_full + 8 * sa, c0,
                    w0 - 1 + (FOLD ? 0 : tap0 % 3), h0 + tap0 / 3 - 1, b);
        for (int tap = tap0; tap < tap0 + K::TAPS; ++tap, ++ib) {
          const int sb = ib % K::B_STAGES;
          if (ib >= K::B_STAGES)
            mbar_wait(b_empty + 8 * sb, (ib / K::B_STAGES - 1) & 1);
          mbar_expect_tx(b_full + 8 * sb, K::B_SLOT);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b_ring + sb * K::B_SLOT + j * K::B_BOX, &wmap,
                        b_full + 8 * sb, n0 + 64 * j, tap * C + c0);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup g owns pixel rows 64g .. 64g+63 of the tile.  When
  // folded (Wt >= 64, so they lie in one image row) they start at that
  // row's place in the (Wt + 2)-wide box.
  const int g = warp / 4;
  const int row0 = FOLD ? 64 * g / wt * (wt + 2) + 64 * g % wt : 64 * g;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int ib = 0;
  for (int ia = 0; ia < a_iters; ++ia) {
    const int sa = ia % K::A_STAGES;
    mbar_wait(a_full + 8 * sa, (ia / K::A_STAGES) & 1);
    for (int dx = 0; dx < K::TAPS; ++dx, ++ib) {
      const int sb = ib % K::B_STAGES;
      mbar_wait(b_full + 8 * sb, (ib / K::B_STAGES) & 1);
      const uint32_t a = a_ring + sa * K::A_SLOT + (row0 + dx) * BKC * 2;
      const uint32_t bb = b_ring + sb * K::B_SLOT;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKC / 16; ++k) {
        // A: K-major, 8-row groups BKc*2*8 bytes apart, k16 steps of 32
        // bytes inside the swizzle row.  B: MN-major, 8-row K groups 1024
        // bytes apart, 64-channel boxes B_BOX apart, k16 steps of 16 rows.
        const uint64_t da = smem_desc(a + 32 * k, 16, BKC * 16, K::A_LAYOUT);
        const uint64_t db = smem_desc(bb + 2048 * k, K::B_BOX, 1024, 1);
        wgmma_tile<BN>(acc, da, db);
      }
      wgmma_commit();
      // Release what the retired wgmmas read: this B slice, and the A box
      // after its last tap.  (Leaving one wgmma group in flight across the
      // release measured slower on the H100, at BN = 128 and 256 alike.)
      wgmma_wait();
      fence_regs(acc);
      if (threadIdx.x % 32 == 0) {
        mbar_arrive(b_empty + 8 * sb);
        if (dx == K::TAPS - 1) mbar_arrive(a_empty + 8 * sa);
      }
    }
  }

  // Epilogue.  Both warpgroups are done with the ring (every load landed and
  // was consumed), so it holds the output tile now.
  bar_sync_consumers();
  constexpr int LD = BN + EPAD;
  __nv_bfloat16* ctile = reinterpret_cast<__nv_bfloat16*>(ring_ptr);
  const int lane = threadIdx.x % 32;
  // wgmma's accumulator layout: thread (warp w of the group, lane l) holds
  // rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1) in d[4j .. 4j+3].
  const int row = g * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const int n = n0 + col;
    const float b0 = n < D ? __bfloat162float(bias[n]) : 0.0f;
    const float b1 = n + 1 < D ? __bfloat162float(bias[n + 1]) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[4 * j + 2 * i] + b0;
      float v1 = acc[4 * j + 2 * i + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(ctile + (row + 8 * i) * LD + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  bar_sync_consumers();
  for (int q = threadIdx.x; q < BM * BN / 8; q += 128 * CONSUMERS) {
    const int r = q / (BN / 8);
    const int cc = (q % (BN / 8)) * 8;
    const int h = h0 + r / wt, w = w0 + r % wt, n = n0 + cc;
    if (h >= H || w >= W || n >= D) continue;
    *reinterpret_cast<uint4*>(
        out + ((static_cast<long long>(b) * H + h) * W + w) * D + n) =
        *reinterpret_cast<const uint4*>(ctile + r * LD + cc);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes of the entry point besides CUDA's own.
constexpr int ERR_PLAN = -1;     // tile plan the kernel does not take
constexpr int ERR_ENCODER = -2;  // no cuTensorMapEncodeTiled
constexpr int ERR_MAP = -3;      // a tensor map was refused

template <int BKC, int BN, bool FOLD>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int W, int C, int D, int relu, int wt, int rt,
           cudaStream_t stream) {
  using K = Cfg<BKC, BN, FOLD>;
  const EncodeTiled encode = encoder();
  if (!encode) return ERR_ENCODER;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t xbox[4] = {BKC, static_cast<cuuint32_t>(wt + (FOLD ? 2 : 0)),
                              static_cast<cuuint32_t>(rt), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle xswz = BKC == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : BKC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             xdim, xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, xswz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_MAP;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(9) * C};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t wbox[2] = {64, BKC};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_MAP;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BKC, BN, FOLD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + wt - 1) / wt, tiles_h = (H + rt - 1) / rt;
  const int tiles_n = (D + BN - 1) / BN;
  const long long grid =
      static_cast<long long>(B) * tiles_h * tiles_w * tiles_n;
  if (grid > 0x7fffffffLL) return ERR_PLAN;
  conv3x3_wgmma_kernel<BKC, BN, FOLD>
      <<<static_cast<unsigned>(grid), THREADS, K::SMEM, stream>>>(
          xmap, wmap, static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(out), H, W, C, D, wt, rt, tiles_w,
          tiles_h, tiles_n, relu);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, int, int, int, cudaStream_t);

struct Variant {
  int bkc, bn, fold;
  Launcher launch;
  int smem;
};

template <int BKC, int BN, bool FOLD>
constexpr Variant variant() {
  return {BKC, BN, FOLD, launch<BKC, BN, FOLD>, Cfg<BKC, BN, FOLD>::SMEM};
}

// The instantiations a tile plan can ask for: BN = 256 only with 64-channel
// boxes and unfolded, the dx fold only up to BN = 128.
constexpr Variant VARIANTS[] = {
    variant<16, 64, false>(),  variant<32, 64, false>(),
    variant<64, 64, false>(),  variant<16, 128, false>(),
    variant<32, 128, false>(), variant<64, 128, false>(),
    variant<64, 256, false>(), variant<16, 64, true>(),
    variant<32, 64, true>(),   variant<64, 64, true>(),
    variant<16, 128, true>(),  variant<32, 128, true>(),
    variant<64, 128, true>()};

const Variant* find_variant(int bkc, int bn, int fold) {
  for (const Variant& v : VARIANTS)
    if (v.bkc == bkc && v.bn == bn && v.fold == (fold != 0)) return &v;
  return nullptr;
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B,H,W,C), w: (3,3,C,D),
// bias: (D,), out: (B,H,W,D), all bf16, contiguous, 16-byte aligned, with C
// and D multiples of 16 (checked by the Python wrapper).  (wt, rt, bn, bkc,
// fold) is the tile plan of ops/conv.py::tile_plan.  Launches on `stream`
// and returns cudaGetLastError(), or a negative code: -1 a plan the kernel
// does not take, -2 no tensor-map encoder in the driver, -3 a tensor map
// refused.
extern "C" int utconv3x3_bf16(const void* x, const void* w, const void* bias,
                              void* out, int B, int H, int W, int C, int D,
                              int relu, int wt, int rt, int bn, int bkc,
                              int fold, void* stream) {
  const Variant* v = find_variant(bkc, bn, fold);
  if (!v || wt * rt != BM || wt < 1 || rt < 1 || wt > 254 || rt > 256 ||
      C % bkc || D % 16 || (fold && wt < 64))
    return ERR_PLAN;
  return v->launch(x, w, bias, out, B, H, W, C, D, relu, wt, rt,
                   static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the (bkc, bn, fold) instantiation, in bytes, or
// -1 if there is none.
extern "C" int utconv3x3_smem_bytes(int bkc, int bn, int fold) {
  const Variant* v = find_variant(bkc, bn, fold);
  return v ? v->smem : ERR_PLAN;
}
