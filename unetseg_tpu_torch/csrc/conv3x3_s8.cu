// 3x3 stride-1 SAME convolution of int8 NHWC activations with int8 weights,
// int32 sums, then the w8a8 dequantize + bias (+ ReLU) in f32, written as
// f32 or quantized again to int8 for the next site, for Hopper: TMA +
// mbarrier + wgmma (s8 x s8 -> s32).
//
// K7 of the port.  It has no Pallas counterpart: the JAX package computes
// each w8a8 conv with lax.conv_general_dilated(..., preferred_element_type=
// int32) outside any kernel (unetseg_tpu/quantize.py::_conv_w8a8, :223-232),
// and PyTorch has no int8 convolution on CUDA (F.conv2d refuses int8).
//
//   y[p, d] = relu(float(sum_{tap, c} x[p + tap, c] * wk[tap, d, c])
//                  * scale[d] + bias[d])
//
// with scale[d] = act_scale * w_scale[d] computed once by the caller (one
// f32 rounding, as JAX's act_scale * w_scale).  The epilogue rounds exactly
// as JAX's order does: float(acc) (round to nearest), then the product, then
// the bias add, each by __int2float_rn / __fmul_rn / __fadd_rn so nvcc
// cannot contract them into an FMA.  The int32 sums are exact in any order
// (|acc| <= 9 * C * 127^2 < 2^31 for C <= 14,000), so the output is
// bit-equal to the plain version.
//
// Two epilogues, chosen at compile time (QOUT):
//   * f32: y itself, (B, H, W, D) float32;
//   * int8: for each of one or two 0-d scales s (device pointers, so no
//     host sync), q = clip(rint(y / s), -127, 127) as int8, the next site's
//     quant_act: y / s rounded as a true IEEE division rounds it (as
//     PyTorch's division by a 0-d CUDA tensor and JAX's x / s; by a
//     reciprocal and two FMA residual steps, see div_rn), then to an
//     integer half to even (__float2int_rn, as torch.round and
//     jnp.round).  Every K7 output of the w8a8 UNet feeds exactly such a
//     quantize (an encoder stage's last conv feeds two: the pooled path
//     and the skip, each with its consumer's scale; q is non-decreasing,
//     so max-pooling the int8 tensor equals quantizing the pooled f32
//     one).
//
// What bounds it on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s): with f32
// out, bytes on eight of slim4's ten shapes (the output is 4 bytes a
// value, 79% of the kernel's bytes over a forward); with int8 out (1 byte
// a value a scale, as the model serves it), the int8 operations on seven
// of the ten.  The
// design follows K1 (csrc/conv3x3.cu) and K8 (csrc/conv3x3_f32.cu):
//
// GEMM view: M = output pixels, N = D output channels, K = 9 * C in the
// order (tap, channel), tap = dy * 3 + dx.  A block computes 128 pixels x BN
// channels (BN = 64, 128 or 256); the 128 pixels are Rt rows x Wt columns of
// one image (ops/conv_s8.py tile_plan_s8 computes the plan and passes it in).
//   * A by 4-D TMA over x seen as (C, W, H, B): one box (BKc, Wt, Rt, 1) per
//     (tap, chunk), zero-filled outside the tensor, so the SAME padding and
//     the ragged edges cost no instruction.  BKc (128, 64 or 32 int8
//     channels, the largest dividing C) is one 128-, 64- or 32-byte swizzle
//     row.  C is a multiple of 32, one k32 slice: the wrapper zero-pads a
//     C = 16 stem (a box half past C, zero-filled by TMA, measured 2.3x
//     slower than the padded input's).  The dx fold (Wt >=
//     64, BN <= 128): one box (BKc, Wt + 2, Rt, 1) per (dy, chunk), read by
//     the three dx taps as views that start dx pixel rows further in (base
//     offset 0: the swizzle is on absolute address bits, K1's finding).
//   * B K-major: the weights (3, 3, D, C) as they are kept, read by a 3-D
//     TMA over (C, D, 9): one box (BKc, BN, 1) per (tap, chunk), rows past
//     D zero-filled.  8-bit wgmma reads both operands
//     K-major only.
// Pipeline: one producer warp (one elected thread issues every TMA) and two
// consumer warpgroups, each running wgmma m64nBNk32 s8 on one 64-row half of
// the tile with int32 accumulators in registers.  A boxes and B slices have
// rings of their own, each slot with a full barrier carrying the TMA byte
// count and an empty barrier on which every consumer warp arrives once its
// wgmmas on the slot have retired.  The epilogue dequantizes (and
// quantizes), stages the tile in the ring's shared memory and writes 16
// bytes per thread, masking pixels past H or W and channels past D.
//
// Entry point: utconv3x3_s8(x, wk, scale, bias, qscale0, qscale1, out0,
// out1, B, H, W, C, D, relu, nq, wt, rt, bn, bkc, fold, stream): nq = 0
// writes f32 to out0; nq = 1 or 2 writes int8 quantized by *qscale0 to
// out0 (and by *qscale1 to out1).  -> 0, or -1 a plan the kernel does not
// take, -2 no cuTensorMapEncodeTiled entry point, -3 a tensor map refused, or
// the CUDA error of the launch.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                        // output pixels per tile
constexpr int CONSUMERS = 2;                   // warpgroups, 64 pixel rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int MAX_STAGES = 12;

template <int BKC, int BN, bool FOLD, bool QOUT>
struct Cfg {
  // Several blocks per SM, so one block's prologue and epilogue overlap
  // another's main loop (K1's choice): three at BN = 64, two at BN = 128,
  // one at BN = 256 (128 accumulators a thread).
  static constexpr int BLOCKS_PER_SM = BN == 256 ? 1 : BN == 128 ? 2 : 3;
  static constexpr int RING_BUDGET =
      BN == 256 ? 200 * 1024 : BN == 128 ? 108 * 1024 : 66 * 1024;
  static constexpr int TAPS = FOLD ? 3 : 1;  // taps per A box
  // A slot: 128 pixel rows of BKc bytes, or up to (Wt + 2) * Rt <= 132 rows
  // when folded; a multiple of 1024 bytes, so every box and the B ring
  // after the A slots start on a swizzle repeat.
  static constexpr int A_SLOT = ((FOLD ? 132 : BM) * BKC + 1023) / 1024 * 1024;
  static constexpr int B_SLOT = BN * BKC;  // BN weight rows of BKc
  static constexpr int cap(int n) { return n < MAX_STAGES ? n : MAX_STAGES; }
  // Unfolded, A and B advance together; folded, two A slots and as many
  // B slots as the rest of the budget holds.
  static constexpr int A_STAGES =
      FOLD ? 2 : cap(RING_BUDGET / (A_SLOT + B_SLOT));
  static constexpr int B_STAGES =
      FOLD ? cap((RING_BUDGET - 2 * A_SLOT) / B_SLOT) : A_STAGES;
  static_assert(A_STAGES >= 2 && B_STAGES >= 2, "ring too small");
  static constexpr int RING = A_STAGES * A_SLOT + B_STAGES * B_SLOT;
  // Epilogue tile: two int8 tiles with rows of BN + 16 bytes (16-byte
  // aligned, and the 8 rows a warp writes at once land in distinct banks),
  // or one float tile with rows of BN + 8 floats.
  static constexpr int LD = QOUT ? BN + 16 : BN + 8;
  static constexpr int EPI = QOUT ? 2 * BM * LD : BM * LD * 4;
  static constexpr int DATA = RING > EPI ? RING : EPI;
  // 1024 bytes of slack to align the ring, then the full and empty
  // barriers of the A slots and of the B slots.
  static constexpr int SMEM = 1024 + DATA + 16 * (A_STAGES + B_STAGES);
  // wgmma layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle.
  static constexpr uint64_t LAYOUT = BKC == 128 ? 1 : BKC == 64 ? 2 : 3;
};

__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

// Channels n and n + 1 of a per-channel f32 vector (n even; 8-byte
// aligned, checked by the wrapper), zeros past D (a multiple of 16, so both
// or neither lie inside).
__device__ __forceinline__ float2 channel_pair(const float* v, int n, int D) {
  return n < D ? *reinterpret_cast<const float2*>(v + n)
               : make_float2(0.0f, 0.0f);
}

// Keeps the epilogue's per-column loads in their column's iteration:
// hoisted all together ahead of the unrolled loop they held registers
// enough to spill (BN 128 and 256, f32 out).
__device__ __forceinline__ void keep_order() {
  asm volatile("" ::: "memory");
}

// y / s rounded to nearest even, given r = RN(1 / s): q0 = y r is within
// two ulps of y / s, one FMA residual step makes it faithful, and the
// second is Markstein's: with r the correctly rounded reciprocal and q1
// faithful, RN(q1 + (y - s q1) r) = RN(y / s).  Five operations: with
// __fdiv_rn (range checks, a slow-path call) the int8 mode took longer
// than writing f32, 5.12 against 3.08 ms per slim4 forward at batch 128
// on an H100.
// It holds while y, s, the quotient and the residuals are normal floats,
// which covers every quotient whose int8 rounding it can change (|y / s|
// >= 0.5, with s >= 1e-20; the w8a8 scales are >= 1e-12 / 127); smaller
// quotients round to 0 either way.
__device__ __forceinline__ float div_rn(float y, float s, float r) {
  const float q0 = __fmul_rn(y, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, y), r, q0);
  return __fmaf_rn(__fmaf_rn(-s, q1, y), r, q1);
}

// quant_act of one value: clip(rint(y / s), -127, 127), y / s as IEEE
// division rounds it (r = RN(1 / s)).
__device__ __forceinline__ uint32_t quant(float y, float s, float r) {
  const int q = __float2int_rn(div_rn(y, s, r));
  return static_cast<uint8_t>(static_cast<int8_t>(min(127, max(-127, q))));
}

template <int BKC, int BN, bool FOLD, bool QOUT>
__global__ void __launch_bounds__(THREADS,
                                  Cfg<BKC, BN, FOLD, QOUT>::BLOCKS_PER_SM)
conv3x3_s8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ qscale0,
                        const float* __restrict__ qscale1,
                        void* __restrict__ out0, void* __restrict__ out1,
                        int H, int W, int C, int D, int wt, int rt,
                        int tiles_w, int tiles_h, int tiles_n, int relu,
                        int nq) {
  using K = Cfg<BKC, BN, FOLD, QOUT>;
  extern __shared__ uint8_t smem_raw[];
  // The ring starts on a 1024-byte boundary: the swizzle repeats every
  // 1024 bytes, and TMA and wgmma must see the same phase of it.
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
  // slices.  Tap-outer, channel chunk inner.
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
    // Producer: one thread keeps both rings full.  A box lands whole,
    // zero-filled parts included, so its byte count is fixed.
    if (threadIdx.x % 32 == 0) {
      const int a_bytes = FOLD ? (wt + 2) * rt * BKC : BM * BKC;
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
          tma_load_3d(b_ring + sb * K::B_SLOT, &wmap, b_full + 8 * sb, c0,
                      n0, tap);
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
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int ib = 0;
  for (int ia = 0; ia < a_iters; ++ia) {
    const int sa = ia % K::A_STAGES;
    mbar_wait(a_full + 8 * sa, (ia / K::A_STAGES) & 1);
    for (int dx = 0; dx < K::TAPS; ++dx, ++ib) {
      const int sb = ib % K::B_STAGES;
      mbar_wait(b_full + 8 * sb, (ib / K::B_STAGES) & 1);
      const uint32_t a = a_ring + sa * K::A_SLOT + (row0 + dx) * BKC;
      const uint32_t bb = b_ring + sb * K::B_SLOT;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKC / 32; ++k) {
        // Both operands K-major: rows of BKc bytes (one swizzle row), 8-row
        // groups 8 * BKc bytes apart, k32 steps of 32 bytes.
        const uint64_t da = smem_desc(a + 32 * k, 16, 8 * BKC, K::LAYOUT);
        const uint64_t db = smem_desc(bb + 32 * k, 16, 8 * BKC, K::LAYOUT);
        wgmma_s8<BN>(acc, da, db, 1);
      }
      wgmma_commit();
      // Release what the retired wgmmas read: this B slice, and the A box
      // after its last tap.
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
  const int ct = threadIdx.x;  // 0 .. 255
  const int lane = threadIdx.x % 32;
  // wgmma's accumulator layout: thread (warp w of the group, lane l) holds
  // rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1) in d[4j .. 4j+3].
  const int row = g * 64 + (warp % 4) * 16 + lane / 4;
  if constexpr (QOUT) {
    uint8_t* const tile0 = ring_ptr;
    uint8_t* const tile1 = ring_ptr + BM * K::LD;
    const float s0 = *qscale0;
    const float s1 = nq > 1 ? *qscale1 : 1.0f;
    const float r0 = __frcp_rn(s0), r1 = __frcp_rn(s1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 c = channel_pair(scale, n0 + col, D);
      const float2 o = channel_pair(bias, n0 + col, D);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float y0 = dequant(acc[4 * j + 2 * i], c.x, o.x, relu);
        const float y1 = dequant(acc[4 * j + 2 * i + 1], c.y, o.y, relu);
        const int at = (row + 8 * i) * K::LD + col;
        *reinterpret_cast<uint16_t*>(tile0 + at) = static_cast<uint16_t>(
            quant(y0, s0, r0) | quant(y1, s0, r0) << 8);
        if (nq > 1)
          *reinterpret_cast<uint16_t*>(tile1 + at) = static_cast<uint16_t>(
              quant(y0, s1, r1) | quant(y1, s1, r1) << 8);
      }
      keep_order();
    }
    bar_sync(1, 128 * CONSUMERS);
    constexpr int UNITS = BM * BN / 16;  // 16 channels a unit
    for (int q = ct; q < nq * UNITS; q += 128 * CONSUMERS) {
      const int o = q / UNITS, u = q % UNITS;
      const int r = u / (BN / 16);
      const int cc = (u % (BN / 16)) * 16;
      const int h = h0 + r / wt, w = w0 + r % wt, n = n0 + cc;
      if (h >= H || w >= W || n >= D) continue;
      int8_t* const dst = static_cast<int8_t*>(o ? out1 : out0);
      *reinterpret_cast<uint4*>(
          dst + ((static_cast<long long>(b) * H + h) * W + w) * D + n) =
          *reinterpret_cast<const uint4*>((o ? tile1 : tile0) + r * K::LD +
                                          cc);
    }
  } else {
    float* const ctile = reinterpret_cast<float*>(ring_ptr);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 c = channel_pair(scale, n0 + col, D);
      const float2 o = channel_pair(bias, n0 + col, D);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(ctile + (row + 8 * i) * K::LD + col) =
            make_float2(dequant(acc[4 * j + 2 * i], c.x, o.x, relu),
                        dequant(acc[4 * j + 2 * i + 1], c.y, o.y, relu));
      keep_order();
    }
    bar_sync(1, 128 * CONSUMERS);
    float* const out = static_cast<float*>(out0);
    for (int q = ct; q < BM * BN / 4; q += 128 * CONSUMERS) {
      const int r = q / (BN / 4);
      const int cc = (q % (BN / 4)) * 4;
      const int h = h0 + r / wt, w = w0 + r % wt, n = n0 + cc;
      if (h >= H || w >= W || n >= D) continue;
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(b) * H + h) * W + w) * D + n) =
          *reinterpret_cast<const float4*>(ctile + r * K::LD + cc);
    }
  }
}

struct Args {
  const void *x, *wk, *scale, *bias, *qscale0, *qscale1;
  void *out0, *out1;
  int B, H, W, C, D, relu, nq, wt, rt;
};

template <int BKC, int BN, bool FOLD, bool QOUT>
int launch(const Args& a, cudaStream_t stream) {
  using K = Cfg<BKC, BN, FOLD, QOUT>;
  if (!encoder()) return ERR_ENCODER;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(a.C),
                              static_cast<cuuint64_t>(a.W),
                              static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(a.B)};
  const cuuint32_t xbox[4] = {BKC,
                              static_cast<cuuint32_t>(a.wt + (FOLD ? 2 : 0)),
                              static_cast<cuuint32_t>(a.rt), 1};
  // The K-major weights (3, 3, D, C) as (C, D, 9).
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(a.C),
                              static_cast<cuuint64_t>(a.D), 9};
  const cuuint32_t wbox[3] = {BKC, BN, 1};
  if (!encode_map(&xmap, a.x, 4, xdim, xbox, BKC,
                  CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !encode_map(&wmap, a.wk, 3, wdim, wbox, BKC,
                  CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return ERR_MAP;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_s8_wgmma_kernel<BKC, BN, FOLD, QOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (a.W + a.wt - 1) / a.wt;
  const int tiles_h = (a.H + a.rt - 1) / a.rt;
  const int tiles_n = (a.D + BN - 1) / BN;
  const long long grid =
      static_cast<long long>(a.B) * tiles_h * tiles_w * tiles_n;
  if (grid > 0x7fffffffLL) return ERR_PLAN;
  conv3x3_s8_wgmma_kernel<BKC, BN, FOLD, QOUT>
      <<<static_cast<unsigned>(grid), THREADS, K::SMEM, stream>>>(
          xmap, wmap, static_cast<const float*>(a.scale),
          static_cast<const float*>(a.bias),
          static_cast<const float*>(a.qscale0),
          static_cast<const float*>(a.qscale1), a.out0, a.out1, a.H, a.W,
          a.C, a.D, a.wt, a.rt, tiles_w, tiles_h, tiles_n, a.relu, a.nq);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = int (*)(const Args&, cudaStream_t);

struct Variant {
  int bkc, bn, fold, quant;
  Launcher launch;
  int smem;
};

template <int BKC, int BN, bool FOLD, bool QOUT>
constexpr Variant variant() {
  return {BKC, BN, FOLD, QOUT, launch<BKC, BN, FOLD, QOUT>,
          Cfg<BKC, BN, FOLD, QOUT>::SMEM};
}

// Each plan in both epilogues.
#define PLAN(BKC, BN, FOLD) \
  variant<BKC, BN, FOLD, false>(), variant<BKC, BN, FOLD, true>()

// The plans ops/conv_s8.py::tile_plan_s8 can ask for (S8_INSTANTIATIONS):
// BN = 256 only with 128-channel boxes and unfolded, the dx fold only up to
// BN = 128.
constexpr Variant VARIANTS[] = {
    PLAN(32, 64, false),  PLAN(64, 64, false),  PLAN(128, 64, false),
    PLAN(32, 128, false), PLAN(64, 128, false), PLAN(128, 128, false),
    PLAN(128, 256, false), PLAN(32, 64, true),  PLAN(64, 64, true),
    PLAN(128, 64, true),  PLAN(32, 128, true),  PLAN(64, 128, true),
    PLAN(128, 128, true)};

#undef PLAN

const Variant* find_variant(int bkc, int bn, int fold, int quant) {
  for (const Variant& v : VARIANTS)
    if (v.bkc == bkc && v.bn == bn && v.fold == (fold != 0) &&
        v.quant == (quant != 0))
      return &v;
  return nullptr;
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B,H,W,C) int8, wk:
// (3,3,D,C) int8, scale and bias: (D,) f32; nq = 0: out0 (B,H,W,D) f32;
// nq = 1 or 2: out0 (and out1) (B,H,W,D) int8, quantized by the f32 scalar
// at qscale0 (and qscale1), both on the device.  All contiguous, x and wk
// 16-byte aligned, scale and bias 8-byte aligned, with C a multiple of 32
// and D of 16 (checked by the Python wrapper).
// (wt, rt, bn, bkc, fold) is the tile plan of ops/conv_s8.py::tile_plan_s8.
// Launches on `stream`.
extern "C" int utconv3x3_s8(const void* x, const void* wk, const void* scale,
                            const void* bias, const void* qscale0,
                            const void* qscale1, void* out0, void* out1,
                            int B, int H, int W, int C, int D, int relu,
                            int nq, int wt, int rt, int bn, int bkc,
                            int fold, void* stream) {
  const Variant* v = find_variant(bkc, bn, fold, nq > 0);
  if (!v || wt * rt != BM || wt < 1 || rt < 1 || wt > 254 || rt > 256 ||
      B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || C % bkc || D % 16 ||
      nq < 0 || nq > 2 || (nq > 0 && !qscale0) || (nq > 1 && !qscale1) ||
      (fold != 0) != (wt >= 64 && bn <= 128))
    return ERR_PLAN;
  const Args a{x,    wk,   scale, bias, qscale0, qscale1, out0, out1, B,
               H,    W,    C,     D,    relu,    nq,      wt,   rt};
  return v->launch(a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the (bkc, bn, fold, quant) instantiation, in
// bytes, or -1 if there is none.
extern "C" int utconv3x3_s8_smem_bytes(int bkc, int bn, int fold, int quant) {
  const Variant* v = find_variant(bkc, bn, fold, quant);
  return v ? v->smem : ERR_PLAN;
}
