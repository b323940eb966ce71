// 3x3 stride-1 SAME convolution + bias (+ ReLU) in float32, NHWC x HWIO ->
// NHWC, for Hopper: split-TF32 (3xTF32) products on the tensor cores.
//
// K8 of the port: the float32 instance of the Pallas kernels
// unetseg_tpu/ops/pallas_conv.py::conv3x3_bias_act (:150-224, C >= 128) and
// _conv3x3_small_c (:123, C < 128), which take any float dtype and sum in
// float32.  The bf16 instance is csrc/conv3x3.cu (K1/K2); this one serves
// every float32 model and the float32 data gradient of training.
//
//   out[p, d] = relu(sum_{tap, c} x[p + tap, c] * w[tap, c, d] + b[d])
//
// Accuracy.  One TF32 product keeps 10 of float32's 23 mantissa bits, too
// few for a float32 model.  Split TF32 keeps about 22: each operand is
// split as v = big + small, big = v rounded to TF32 (nearest, ties away
// from zero, on the float32 bits: low 13 bits zero) and small = v - big
// (exact in float32) rounded to TF32 likewise, and each k-slice sums
//   small_x * big_w + big_x * small_w + big_x * big_w
// in three tf32 wgmmas into one float32 accumulator (the small terms
// first, as CUTLASS's 3xTF32 does).  Every tf32 product is exact in
// float32; the dropped small * small term is below 2^-22 of a product.
// Both halves are rounded here, so the tensor cores, which read the top 19
// bits of an operand, never truncate one.  The sums run in two levels: the
// products of one A box (one tap, or with the dx fold three, by BKc
// channels) into a partial (the box's first wgmma starts it with
// scale-d = 0), then the partials into a float32 total, so an output's
// rounding error grows with the box's 3 * BKc products plus the 9 * C / BKc
// partials, not with all 9 * C products.
//
// What bounds it on the H100: the tensor cores at 495 TFLOP/s dense tf32,
// so three products give 165 TFLOP/s of float32 work (2.5x the CUDA cores'
// 67); bytes are far below that on every served shape.  In practice the
// shared-memory reads of the wgmmas (both operands from shared memory,
// three products per k-slice) and the split pass limit it.
//
// GEMM view and tiles, as K1's (csrc/conv3x3.cu): M = output pixels, N = D
// output channels, K = 9 * C in the order (tap, channel), tap = dy * 3 + dx.
// A block computes 128 pixels x BN channels (BN = 64 for D <= 64, else 128;
// larger tiles do not fit the accumulator and the partial in registers);
// the 128 pixels are Rt rows x Wt columns of one image (ops/conv.py
// tile_plan_f32 computes the plan and passes it in).
//   * A by 4-D TMA over x seen as (C, W, H, B): one box (BKc, Wt, Rt, 1) per
//     (tap, chunk), zero-filled outside the tensor (the SAME padding and
//     ragged edges cost nothing).  BKc = 32 floats (a 128-byte swizzle row)
//     when 32 divides C, else 16 (64-byte rows).  The dx fold (Wt >= 64):
//     one box (BKc, Wt + 2, Rt, 1) per (dy, chunk), read by the three dx
//     taps as views that start dx pixel rows further in (base offset 0: the
//     swizzle is on absolute address bits, K1's finding).
//   * The split of A: when a box has landed, the 256 consumer threads read
//     it once, write big in place and small into a second tile of the same
//     layout (same swizzle, both 1024-byte aligned, so element i sits at the
//     same offset in both and the pass need not know the swizzle), fence
//     the generic-proxy stores for the async proxy, and meet at a named
//     barrier.  The split of the next box runs while the current box's last
//     wgmmas are in flight.
//   * B K-major: the weights as (2, 3, 3, D, C), big then small, each
//     w.permute(0, 1, 3, 2) (for the data gradient simply w.flip((0, 1))),
//     made once per call by the weight stage (split_weights_kernel, its own
//     launch just before the conv's, through utconv3x3_f32_split): one
//     elementwise pass that reads the HWIO weights through their strides
//     and pads C and D with zeros.  A 3-D TMA over (C, D, 18) loads one box
//     (BKc, BN, 1) of big and one of small per (tap, chunk); rows past D
//     are zero-filled.
// Pipeline: one producer warp (one elected thread issues every TMA) and two
// consumer warpgroups, each running wgmma m64nBNk8 on one 64-row half of
// the tile.  A boxes and B slices have rings of their own, each slot with
// a full barrier carrying the TMA byte count and an empty barrier on which
// every consumer warp arrives once its wgmmas on the slot have retired.
// A tap's B slot is released as soon as the next tap's wgmmas are issued
// and it has retired (wait_group 1).  One block per SM (the accumulator and
// the partial take 128 registers a thread at BN = 128).  The epilogue adds
// the bias in float32, applies the ReLU, stages the tile in the ring's
// shared memory and writes 16 bytes per thread, masking pixels past H or W
// and channels past D.
//
// Entry points: utconv3x3_f32_split(w, strides, cw, dw, C, D, w_split,
// stream), the weight stage, then utconv3x3_f32(x, w_split, b, out, B, H, W,
// C, D, relu, wt, rt, bn, bkc, fold, stream); each -> 0, or -1 a plan the
// kernel does not take, -2 no tensor-map encoder in the driver, -3 a tensor
// map refused, or the CUDA error of the launch.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                        // output pixels per tile
constexpr int CONSUMERS = 2;                   // warpgroups, 64 pixel rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int MAX_STAGES = 12;
constexpr int EPAD = 8;  // float row padding of the epilogue tile
constexpr int RING_BUDGET = 200 * 1024;

template <int BKC, int BN, bool FOLD>
struct Cfg {
  static constexpr int TAPS = FOLD ? 3 : 1;  // taps per A box
  static constexpr int ROW = BKC * 4;        // bytes of one pixel's slice
  // One A tile (x, rounded in place to big; or small): 128 pixel rows, or
  // up to (Wt + 2) * Rt <= 132 rows when folded; a multiple of 1024 bytes,
  // so every tile starts on a swizzle repeat.
  static constexpr int A_TILE = ((FOLD ? 132 : BM) * ROW + 1023) / 1024 * 1024;
  static constexpr int A_SLOT = 2 * A_TILE;  // big, small
  static constexpr int B_TILE = BN * ROW;    // BN weight rows of BKc
  static constexpr int B_SLOT = 2 * B_TILE;  // big, small
  static constexpr int cap(int n) { return n < MAX_STAGES ? n : MAX_STAGES; }
  // Unfolded, A and B advance together; folded, two A slots (the one in
  // use and the next, split ahead) and as many B slots as the rest holds.
  static constexpr int A_STAGES =
      FOLD ? 2 : cap(RING_BUDGET / (A_SLOT + B_SLOT));
  static constexpr int B_STAGES =
      FOLD ? cap((RING_BUDGET - 2 * A_SLOT) / B_SLOT) : A_STAGES;
  static_assert(A_STAGES >= 2 && B_STAGES >= 2, "ring too small");
  static constexpr int RING = A_STAGES * A_SLOT + B_STAGES * B_SLOT;
  static constexpr int EPI = BM * (BN + EPAD) * 4;
  static constexpr int DATA = RING > EPI ? RING : EPI;
  // 1024 bytes of slack to align the ring, then the full and empty
  // barriers of the A slots and of the B slots.
  static constexpr int SMEM = 1024 + DATA + 16 * (A_STAGES + B_STAGES);
  // wgmma layout type: 1 = 128-byte swizzle, 2 = 64-byte.
  static constexpr uint64_t LAYOUT = BKC == 32 ? 1 : 2;
};

// v rounded to TF32, nearest with ties away from zero, on its float32
// bits: the 13 low bits become zero.
__device__ __forceinline__ uint32_t round_tf32(uint32_t v) {
  return (v + 0x1000u) & 0xffffe000u;
}

// big (in place) and small of four floats.
__device__ __forceinline__ void split4(uint4& v, uint4& small) {
  uint32_t* x = reinterpret_cast<uint32_t*>(&v);
  uint32_t* s = reinterpret_cast<uint32_t*>(&small);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t big = round_tf32(x[i]);
    s[i] = round_tf32(
        __float_as_uint(__uint_as_float(x[i]) - __uint_as_float(big)));
    x[i] = big;
  }
}

// The weight stage: the split K-major weights (2, 3, 3, D, C), big then
// small, of HWIO weights w (3, 3, cw, dw) read through any element strides
// s (so the data gradient's rotated, transposed view needs no copy), with
// zeros past cw and dw.  One thread an element, as the Python wrapper's
// plain version (ops/conv.py split_tf32 of kmajor) computes it, bit for
// bit.
__global__ void split_weights_kernel(const float* __restrict__ w,
                                     long long s0, long long s1,
                                     long long s2, long long s3, int cw,
                                     int dw, int C, int D,
                                     float* __restrict__ out) {
  const long long n = 9LL * D * C;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const int d = static_cast<int>(i / C % D);
    const int tap = static_cast<int>(i / C / D);
    const float v = c < cw && d < dw
        ? w[tap / 3 * s0 + tap % 3 * s1 + c * s2 + d * s3] : 0.0f;
    const uint32_t big = round_tf32(__float_as_uint(v));
    out[i] = __uint_as_float(big);
    out[n + i] = __uint_as_float(
        round_tf32(__float_as_uint(v - __uint_as_float(big))));
  }
}

template <int BKC, int BN, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int H, int W, int C, int D, int wt, int rt, int tiles_w,
                      int tiles_h, int tiles_n, int relu) {
  using K = Cfg<BKC, BN, FOLD>;
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
  const int a_bytes = FOLD ? (wt + 2) * rt * K::ROW : BM * K::ROW;

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
          const uint32_t dst = b_ring + sb * K::B_SLOT;
          mbar_expect_tx(b_full + 8 * sb, K::B_SLOT);
          tma_load_3d(dst, &wmap, b_full + 8 * sb, c0, n0, tap);
          tma_load_3d(dst + K::B_TILE, &wmap, b_full + 8 * sb, c0, n0,
                      9 + tap);
        }
      }
    }
    return;
  }

  // Consumers.  The split pass of box ia: every consumer thread takes every
  // 256th 16-byte unit of the landed box.
  const int ct = threadIdx.x;  // 0 .. 255
  auto split = [&](int ia) {
    const int sa = ia % K::A_STAGES;
    mbar_wait(a_full + 8 * sa, (ia / K::A_STAGES) & 1);
    uint4* xs = reinterpret_cast<uint4*>(ring_ptr + sa * K::A_SLOT);
    uint4* ss = reinterpret_cast<uint4*>(ring_ptr + sa * K::A_SLOT +
                                         K::A_TILE);
    for (int i = ct; i < a_bytes / 16; i += 128 * CONSUMERS) {
      uint4 v = xs[i], small;
      split4(v, small);
      xs[i] = v;
      ss[i] = small;
    }
    fence_proxy_async();  // the stores above, before wgmma reads them
  };

  // Warpgroup g owns pixel rows 64g .. 64g+63 of the tile.  When folded
  // (Wt >= 64, so they lie in one image row) they start at that row's
  // place in the (Wt + 2)-wide box.
  const int g = warp / 4;
  const int row0 = FOLD ? 64 * g / wt * (wt + 2) + 64 * g % wt : 64 * g;
  float acc[BN / 2], total[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.0f;

  split(0);
  bar_sync(1, 128 * CONSUMERS);
  int ib = 0;
  for (int ia = 0; ia < a_iters; ++ia) {
    const int sa = ia % K::A_STAGES;
    const uint32_t a_big = a_ring + sa * K::A_SLOT + row0 * K::ROW;
#pragma unroll
    for (int dx = 0; dx < K::TAPS; ++dx, ++ib) {
      const int sb = ib % K::B_STAGES;
      mbar_wait(b_full + 8 * sb, (ib / K::B_STAGES) & 1);
      const uint32_t ab = a_big + dx * K::ROW, as = ab + K::A_TILE;
      const uint32_t bb = b_ring + sb * K::B_SLOT, bs = bb + K::B_TILE;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKC / 8; ++k) {
        // Both operands K-major: rows of BKc floats (one swizzle row),
        // 8-row groups 8 * ROW bytes apart, k8 steps of 32 bytes.
        const uint64_t dab = smem_desc(ab + 32 * k, 16, 8 * K::ROW, K::LAYOUT);
        const uint64_t das = smem_desc(as + 32 * k, 16, 8 * K::ROW, K::LAYOUT);
        const uint64_t dbb = smem_desc(bb + 32 * k, 16, 8 * K::ROW, K::LAYOUT);
        const uint64_t dbs = smem_desc(bs + 32 * k, 16, 8 * K::ROW, K::LAYOUT);
        wgmma_tf32<BN>(acc, das, dbb, dx > 0 || k > 0);  // box's first: D = 0
        wgmma_tf32<BN>(acc, dab, dbs, 1);
        wgmma_tf32<BN>(acc, dab, dbb, 1);
      }
      wgmma_commit();
      if (dx > 0) {
        // The previous tap's wgmmas have retired: release its B slice.
        wgmma_wait<1>();
        if (threadIdx.x % 32 == 0)
          mbar_arrive(b_empty + 8 * ((ib - 1) % K::B_STAGES));
      }
    }
    // Split the next box while this one's last wgmmas run.
    if (ia + 1 < a_iters) split(ia + 1);
    wgmma_wait<0>();
    fence_regs(acc);
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(b_empty + 8 * ((ib - 1) % K::B_STAGES));
      mbar_arrive(a_empty + 8 * sa);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] += acc[i];
    bar_sync(1, 128 * CONSUMERS);  // the next box split by both warpgroups
  }

  // Epilogue.  Both warpgroups are done with the ring (every load landed
  // and was consumed), so it holds the output tile now.
  constexpr int LD = BN + EPAD;
  float* ctile = reinterpret_cast<float*>(ring_ptr);
  const int lane = threadIdx.x % 32;
  // wgmma's accumulator layout: thread (warp w of the group, lane l) holds
  // rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1) in d[4j .. 4j+3].
  const int row = g * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const int n = n0 + col;
    const float b0 = n < D ? bias[n] : 0.0f;
    const float b1 = n + 1 < D ? bias[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = total[4 * j + 2 * i] + b0;
      float v1 = total[4 * j + 2 * i + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<float2*>(ctile + (row + 8 * i) * LD + col) =
          make_float2(v0, v1);
    }
  }
  bar_sync(1, 128 * CONSUMERS);
  for (int q = ct; q < BM * BN / 4; q += 128 * CONSUMERS) {
    const int r = q / (BN / 4);
    const int cc = (q % (BN / 4)) * 4;
    const int h = h0 + r / wt, w = w0 + r % wt, n = n0 + cc;
    if (h >= H || w >= W || n >= D) continue;
    *reinterpret_cast<float4*>(
        out + ((static_cast<long long>(b) * H + h) * W + w) * D + n) =
        *reinterpret_cast<const float4*>(ctile + r * LD + cc);
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
  // The split weights (2, 3, 3, D, C) as (C, D, 18): big taps 0..8, then
  // small.
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(D), 18};
  const cuuint32_t wbox[3] = {BKC, BN, 1};
  if (!encode_map(&xmap, x, 4, xdim, xbox, K::ROW,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !encode_map(&wmap, w, 3, wdim, wbox, K::ROW,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return ERR_MAP;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_tf32x3_kernel<BKC, BN, FOLD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + wt - 1) / wt, tiles_h = (H + rt - 1) / rt;
  const int tiles_n = (D + BN - 1) / BN;
  const long long grid =
      static_cast<long long>(B) * tiles_h * tiles_w * tiles_n;
  if (grid > 0x7fffffffLL) return ERR_PLAN;
  conv3x3_tf32x3_kernel<BKC, BN, FOLD>
      <<<static_cast<unsigned>(grid), THREADS, K::SMEM, stream>>>(
          xmap, wmap, static_cast<const float*>(bias),
          static_cast<float*>(out), H, W, C, D, wt, rt, tiles_w, tiles_h,
          tiles_n, relu);
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

// Every plan of ops/conv.py::tile_plan_f32: BKc 16 or 32, BN 64 or 128,
// with and without the dx fold.
constexpr Variant VARIANTS[] = {
    variant<16, 64, false>(),  variant<32, 64, false>(),
    variant<16, 128, false>(), variant<32, 128, false>(),
    variant<16, 64, true>(),   variant<32, 64, true>(),
    variant<16, 128, true>(),  variant<32, 128, true>()};

const Variant* find_variant(int bkc, int bn, int fold) {
  for (const Variant& v : VARIANTS)
    if (v.bkc == bkc && v.bn == bn && v.fold == (fold != 0)) return &v;
  return nullptr;
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B,H,W,C), w: the split
// K-major weights (2,3,3,D,C), bias: (D,), out: (B,H,W,D), all float32,
// contiguous, 16-byte aligned, with C and D multiples of 16 (checked by the
// Python wrapper).  (wt, rt, bn, bkc, fold) is the tile plan of
// ops/conv.py::tile_plan_f32.  Launches on `stream`.
extern "C" int utconv3x3_f32(const void* x, const void* w, const void* bias,
                             void* out, int B, int H, int W, int C, int D,
                             int relu, int wt, int rt, int bn, int bkc,
                             int fold, void* stream) {
  const Variant* v = find_variant(bkc, bn, fold);
  if (!v || wt * rt != BM || wt < 1 || rt < 1 || wt > 254 || rt > 256 ||
      B < 1 || H < 1 || W < 1 || C % bkc || D % 16 || D < 1 ||
      (fold != 0) != (wt >= 64))
    return ERR_PLAN;
  return v->launch(x, w, bias, out, B, H, W, C, D, relu, wt, rt,
                   static_cast<cudaStream_t>(stream));
}

// The weight stage's entry point: w_split (2,3,3,D,C) from w (3,3,cw,dw),
// float32 with element strides s0..s3, cw <= C, dw <= D.  Launches on
// `stream`; returns 0 or the CUDA error of the launch.
extern "C" int utconv3x3_f32_split(const void* w, long long s0, long long s1,
                                   long long s2, long long s3, int cw,
                                   int dw, int C, int D, void* w_split,
                                   void* stream) {
  if (cw < 1 || dw < 1 || cw > C || dw > D) return ERR_PLAN;
  const long long n = 9LL * D * C;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096
                                          ? (n + 255) / 256 : 4096);
  split_weights_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), s0, s1, s2, s3, cw, dw, C, D,
      static_cast<float*>(w_split));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the (bkc, bn, fold) instantiation, in bytes, or
// -1 if there is none.
extern "C" int utconv3x3_f32_smem_bytes(int bkc, int bn, int fold) {
  const Variant* v = find_variant(bkc, bn, fold);
  return v ? v->smem : ERR_PLAN;
}
