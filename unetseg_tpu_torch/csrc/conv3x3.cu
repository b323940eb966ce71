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

#include "hopper.cuh"

namespace {

using namespace hopper;

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
        wgmma<BN>(acc, da, db);
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
  bar_sync(1, 128 * CONSUMERS);
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
  bar_sync(1, 128 * CONSUMERS);
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

template <int BKC, int BN, bool FOLD>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int W, int C, int D, int relu, int wt, int rt,
           cudaStream_t stream) {
  using K = Cfg<BKC, BN, FOLD>;
  if (!encoder()) return ERR_ENCODER;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint32_t xbox[4] = {BKC, static_cast<cuuint32_t>(wt + (FOLD ? 2 : 0)),
                              static_cast<cuuint32_t>(rt), 1};
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(9) * C};
  const cuuint32_t wbox[2] = {64, BKC};
  if (!encode_map(&xmap, x, 4, xdim, xbox, 2 * BKC) ||
      !encode_map(&wmap, w, 2, wdim, wbox, 128))
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
