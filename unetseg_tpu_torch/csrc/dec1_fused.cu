// The last decoder level of a stem-1 UNet, its 1x1 head and the argmax, in
// one kernel, on NHWC bf16, for Hopper: TMA + mbarriers + wgmma.
//
// Replaces the Pallas TPU kernel of the JAX package
//   benchmarks/exp_dec1_ablate.py::make  (kernel :47-146, pallas_call :150),
// the fused decoder level 1: 2x2 up-GEMM, [skip, up], conv3x3+ReLU twice,
// 1x1 head and a first-max argmax.  The TPU kernel folds two pixels into
// each 128-lane row and pads its inputs in HBM; this one keeps the port's
// NHWC layouts as they are and lets TMA's zero fill do the SAME padding.
//
// Function, per image (C = output channels of the level, x has 2C):
//   up = round(x . Wu + bu), 0 outside the image  2x2 stride-2 transposed conv
//   c1 = round(relu(conv3x3([skip, up]) + b1)), 0 outside the image
//   c2 = round(relu(conv3x3(c1) + b2))
//   class = first argmax over k of (c2 . Wh + bh)[k]  (f32 logits)
// with products in bf16, sums in f32, and round = to bf16 (K6's rounding
// points, exp_dec1_ablate.py:59-69,101-111,138-146, plus the biases).
//
// What bounds it: at B=32, 512^2, C=64 the level is 1.996 TFLOP (conv1
// 1.237, conv2 0.618, up 0.137, head 0.003), 2.02 ms at 989 TFLOP/s,
// against 1.6 GB of input (0.48 ms at 3.35 TB/s): operations.  So every
// product is a wgmma reading both operands from shared memory, and the
// design keeps the executed work near the useful work.
//
// Design: one block per TH x TW output tile (12 x 28 at C = 64; the table
// TILES below, which ops/dec1.py tile_plan computes and passes in), one
// producer warp and two consumer warpgroups.  Every operand lives in shared
// memory as the K-major, swizzled planes wgmma reads, one pixel per swizzle
// row (BKc channels, 128-, 64- or 32-byte rows), each IN_W = TW + 4 pixels
// wide:
//   * skip: (TH + 4) x IN_W pixels by 4-D TMA over skip seen as (C, W, H, B)
//     at (h0 - 2, w0 - 2): zero fill outside the tensor is SAME padding;
//   * x: the (TH/2 + 2) x (IN_W/2) x pixels under it, by 4-D TMA;
//   * up: written by the up-GEMM's epilogue, which scatters each x pixel's
//     four sub-pixels into the plane beside skip (zero outside the image);
//   * c1: (TH + 2) x IN_W pixels, written by conv1's epilogue (zero outside
//     the image: conv2's padding); it overlays x, which is dead by then;
//   * c2: conv2's output, for the head, over the skip plane (dead by then).
// The products are transposed, D[cout][pixel] = W^T . P: the weights are
// wgmma's A operand (64 output channels, M-major, straight from the model's
// tensor by 2-D TMA: w1 as (18C, C), w2 as (9C, C), up_w as (2C, 4C)), and
// the pixels its B operand, N = 192-256 wide, so each wgmma reads far fewer
// shared-memory bytes per product than 64 x 64 tiles would (at N = 64 the
// operand bytes alone match the SM's shared-memory rate).  The convs run on
// the flat IN_W-wide grid of the tile, the columns that wrap into the next
// row included (their results are dropped): tap (dy, dx) is the same plane
// read through a descriptor that starts dy * IN_W + dx pixel rows in, and
// each warpgroup owns one half of the grid.  A descriptor starting some rows
// into a swizzled plane keeps base offset 0 (the swizzle is on absolute
// address bits, as for the conv's dx fold); each plane has two rows of slack
// past its end for the wrap.
//
// Weights stream through a ring of slots with full and empty mbarriers: the
// up weight by (x channel chunk, 64-column piece), then conv1's 9 taps x
// 2C / BKc channel chunks, then conv2's 9 x C / BKc; both warpgroups wait
// for and release every slot.  Output channels are padded to 64 (TMA
// zero-fills the missing weight columns); each consumer thread holds at most
// 128 accumulators.  Only named barriers separate the stages of a tile (up
// written -> conv1 reads; c1 written -> conv2 reads; c2 written -> head).
// The epilogues add the bias, apply the ReLU and the image mask, round, and
// write the next plane with stmatrix.trans (the accumulator fragment,
// transposed, is 16 channels of a pixel row).  The head reads c2 a pixel per
// thread, sums its f32 logits and writes the first-max class: one byte.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CONSUMERS = 2;                   // warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int MAX_CLASSES = 8;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;             // a block's shared memory

// (C, TH, TW, ring stages): the tile of each C, as ops/dec1.py tile_plan
// chooses it; the entry point refuses any other plan.
constexpr int TILES[6][4] = {{16, 14, 28, 8}, {32, 14, 28, 8},
                             {48, 12, 28, 8}, {64, 12, 28, 4},
                             {80, 6, 28, 8},  {96, 6, 28, 5}};

constexpr int tile(int c, int field) {
  for (const auto& t : TILES)
    if (t[0] == c) return t[field];
  return 0;
}

// Channels per swizzle row for a plane of c channels: 64, 32 or 16.
constexpr int chunk_of(int c) {
  return c % 64 == 0 ? 64 : c % 32 == 0 ? 32 : 16;
}
constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int round1024(int n) { return (n + 1023) / 1024 * 1024; }

// Shared-memory layout of a tile (bytes from the 1024-aligned base): skip
// chunk planes, up chunk planes, c1 (or x) chunk planes, the ring, the f32
// params, the barriers.  ops/dec1.py geometry computes the same.
struct Geo {
  int plane_in, plane_c1, plane_x, off_c1, off_ring, off_params, off_bars,
      smem;
};

constexpr Geo geometry(int c, int th, int tw, int stages) {
  const int bkc = chunk_of(c), bkx = chunk_of(2 * c), np = (c + 63) / 64 * 64;
  const int in_w = tw + 4, in_h = th + 4;
  const int m1 = (th + 2) * in_w, mx = (in_w / 2) * (in_h / 2);
  Geo g{};
  g.plane_in = round1024((in_h * in_w + 2) * 2 * bkc);
  g.plane_c1 = round1024((m1 + 2) * 2 * bkc);
  g.plane_x = round1024(mx * 2 * bkx);
  g.off_c1 = 2 * (c / bkc) * g.plane_in;
  g.off_ring = g.off_c1 + imax(c / bkc * g.plane_c1, 2 * c / bkx * g.plane_x);
  g.off_params = g.off_ring + stages * imax(bkc * np, bkx * 64) * 2;
  g.off_bars = g.off_params +
               4 * (c + 2 * np + MAX_CLASSES * np + MAX_CLASSES);
  g.smem = 1024 + g.off_bars + 8 * (2 + 2 * stages);
  return g;
}

template <int C>
struct Cfg {
  static constexpr int TH = tile(C, 1), TW = tile(C, 2), STAGES = tile(C, 3);
  static constexpr int IN_W = TW + 4, IN_H = TH + 4;
  static constexpr int X_W = IN_W / 2, X_H = IN_H / 2;
  static constexpr int M1 = (TH + 2) * IN_W, M2 = TH * IN_W, MX = X_W * X_H;
  static constexpr int N1 = M1 / 2, N2 = M2 / 2;  // per warpgroup
  static constexpr int BKC = chunk_of(C);      // skip, up, c1, c2 planes
  static constexpr int BKX = chunk_of(2 * C);  // the x plane
  static constexpr int NCH = C / BKC, NCX = 2 * C / BKX;
  static constexpr int SW = 2 * BKC, SWX = 2 * BKX;  // bytes per pixel row
  // wgmma layout types: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle.
  static constexpr uint64_t LAYOUT = BKC == 64 ? 1 : BKC == 32 ? 2 : 3;
  static constexpr uint64_t LAYOUT_X = BKX == 64 ? 1 : BKX == 32 ? 2 : 3;
  static constexpr int NP = (C + 63) / 64 * 64;  // output channels, padded
  static constexpr int MB = NP / 64;             // conv wgmma M blocks
  static constexpr int PIECES = 4 * C / 64;      // up-GEMM M blocks
  static constexpr int UPW = (PIECES + CONSUMERS - 1) / CONSUMERS;
  static constexpr int BOX = BKC * 128;  // one conv weight box: BKc x 64
  static constexpr int UP_SLICES = NCX * PIECES;
  static constexpr int C1_SLICES = 9 * 2 * NCH;
  static constexpr int SLICES = UP_SLICES + C1_SLICES + 9 * NCH;
  static constexpr int SLOT = imax(BKC * NP, BKX * 64) * 2;
  // The layout as scalars: device code reads no constexpr struct.
  static constexpr Geo G = geometry(C, TH, TW, STAGES);
  static constexpr int PLANE_IN = G.plane_in, PLANE_C1 = G.plane_c1,
                       PLANE_X = G.plane_x, OFF_C1 = G.off_c1,
                       OFF_RING = G.off_ring, OFF_PARAMS = G.off_params,
                       OFF_BARS = G.off_bars, SMEM = G.smem;
  static_assert(TH % 2 == 0 && TW % 2 == 0 && N1 % 8 == 0 && N2 % 8 == 0 &&
                    MX % 8 == 0 && N1 <= 256 && MX <= 256 &&
                    MB * N1 / 2 <= 128 && UPW * MX / 2 <= 128 &&
                    SMEM <= SMEM_LIMIT && STAGES >= 2 &&
                    STAGES <= MAX_STAGES,
                "tile does not fit");
};

// Phase stamps, compiled in only with -DDEC1_PHASES (the probe
// unetseg_tpu_torch/benchmarks/dec1_phases.py): clock64() at the phase
// boundaries of each tile, by the first thread of each consumer warpgroup,
// and the block's SM and start time, into dec1_phase_buf[block][group][16].
#ifdef DEC1_PHASES
__device__ long long* dec1_phase_buf;
#define PHASE(i)                                                          \
  if (threadIdx.x % 128 == 0)                                             \
    dec1_phase_buf[(blockIdx.x * 2ll + threadIdx.x / 128) * 16 + (i)] =   \
        clock64();
#else
#define PHASE(i)
#endif

template <int N, int S>
__device__ __forceinline__ void zero(float (&acc)[S][N]) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.0f;
}

template <int N, int S>
__device__ __forceinline__ void fence_all(float (&acc)[S][N]) {
#pragma unroll
  for (int i = 0; i < S; ++i) fence_regs(acc[i]);
}

// The ring: wait until weight slice `ib` has landed; return its slot.
__device__ __forceinline__ uint32_t acquire(uint32_t ring, uint32_t full,
                                            int ib, int stages, int slot) {
  const int s = ib % stages;
  mbar_wait(full + 8 * s, (ib / stages) & 1);
  return ring + s * slot;
}

// ... and hand its slot back, once this warp's wgmmas on it have retired.
__device__ __forceinline__ void release(uint32_t empty, int ib, int stages) {
  if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * (ib % stages));
}

// The conv products of one weight slice: D[mb] (64 channels x N pixels) +=
// W slot box mb (M-major) x the plane from `b` on (N pixel rows, K-major).
template <int C, int N>
__device__ __forceinline__ void conv_slice(float (&acc)[Cfg<C>::MB][N / 2],
                                           uint32_t slot, uint32_t b) {
  using K = Cfg<C>;
  fence_all(acc);
  wgmma_fence();
#pragma unroll
  for (int mb = 0; mb < K::MB; ++mb)
#pragma unroll
    for (int k = 0; k < K::BKC / 16; ++k)
      wgmma<N, 1, 0>(acc[mb],
                     smem_desc(slot + mb * K::BOX + 2048 * k, K::BOX, 1024, 1),
                     smem_desc(b + 32 * k, 16, 8 * K::SW, K::LAYOUT));
  wgmma_commit();
  wgmma_wait();
  fence_all(acc);
}

// Stores accumulator block acc (64 channels x N pixels, channels ch0 +
// 16 * (warp % 4) + ... of this warp) transposed into a plane, pixel rows
// from n0: value(v, channel, pixel) gives what is stored; addr(pixel,
// channel) the swizzled address of the 16-byte unit of 8 channels.
template <int N, typename Value, typename Addr>
__device__ __forceinline__ void store_block(const float (&acc)[N / 2], int n0,
                                            int ch0, Value value, Addr addr) {
  const int lane = threadIdx.x % 32, tq = lane % 4;
  const int cw = ch0 + 16 * ((threadIdx.x / 32) % 4);  // this warp's channels
  const int c_lane = cw + lane / 4;                   // this thread's row
  const int c_unit = cw + 8 * ((lane / 8) % 2);       // this lane's unit
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    uint32_t r[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int jj = j + m / 2, ii = m % 2;
      const int px = n0 + 8 * jj + 2 * tq;
      r[m] = pack_bf16(value(acc[4 * jj + 2 * ii], c_lane + 8 * ii, px),
                       value(acc[4 * jj + 2 * ii + 1], c_lane + 8 * ii, px + 1));
    }
    stmatrix_x4_trans(addr(n0 + 8 * (j + lane / 16) + lane % 8, c_unit), r[0],
                      r[1], r[2], r[3]);
  }
}

// The f32 head over c2 (rows of the flat TH x IN_W grid in the c2 planes),
// first-max argmax, one byte per pixel; KP >= n_classes logits a thread.
template <int C, int KP>
__device__ __forceinline__ void head(const uint8_t* smem_raw, uint32_t raw,
                                     uint32_t c2_pl, const float* f_wh,
                                     const float* f_bh, uint8_t* out, int b,
                                     int h0, int w0, int H, int W,
                                     int n_classes) {
  using K = Cfg<C>;
  for (int p = threadIdx.x; p < K::TH * K::TW; p += 128 * CONSUMERS) {
    const int r = h0 + p / K::TW, c = w0 + p % K::TW;
    if (r >= H || c >= W) continue;
    const int q = p / K::TW * K::IN_W + p % K::TW;
    float lg[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) lg[k] = f_bh[k];
#pragma unroll
    for (int n = 0; n < C; n += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          smem_raw + (swizzled(c2_pl + n / K::BKC * K::PLANE_IN, q,
                               n % K::BKC * 2, K::SW) - raw));
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float* w = f_wh + (n + 2 * e) * MAX_CLASSES;
#pragma unroll
        for (int k = 0; k < KP; ++k)
          lg[k] = fmaf(f.y, w[MAX_CLASSES + k], fmaf(f.x, w[k], lg[k]));
      }
    }
    int best = 0;
    float top = lg[0];
#pragma unroll
    for (int k = 1; k < KP; ++k)
      if (k < n_classes && lg[k] > top) {  // strict: ties go to the lower class
        top = lg[k];
        best = k;
      }
    out[(static_cast<long long>(b) * H + r) * W + c] =
        static_cast<uint8_t>(best);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
dec1_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap smap,
                  const __grid_constant__ CUtensorMap umap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map,
                  const __nv_bfloat16* __restrict__ up_b,
                  const __nv_bfloat16* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ wh,
                  const __nv_bfloat16* __restrict__ bh,
                  uint8_t* __restrict__ out, int H, int W, int n_classes,
                  int tiles_w, int tiles_h) {
  using K = Cfg<C>;
  extern __shared__ uint8_t smem_raw[];
  // Planes start on 1024-byte boundaries: the 128-byte swizzle repeats
  // every 1024 bytes, and TMA, wgmma and the epilogues must agree on it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t skip_pl = base;  // NCH chunk planes; c2 after conv1
  const uint32_t up_pl = base + K::NCH * K::PLANE_IN;
  const uint32_t c1_pl = base + K::OFF_C1;  // x until conv1's epilogue
  const uint32_t ring = base + K::OFF_RING;
  float* const f_bu =
      reinterpret_cast<float*>(smem_raw + (base - raw) + K::OFF_PARAMS);
  float* const f_b1 = f_bu + C;
  float* const f_b2 = f_b1 + K::NP;
  float* const f_wh = f_b2 + K::NP;  // (NP, MAX_CLASSES)
  float* const f_bh = f_wh + MAX_CLASSES * K::NP;
  const uint32_t x_full = base + K::OFF_BARS, skip_full = x_full + 8;
  const uint32_t full = skip_full + 8, empty = full + 8 * K::STAGES;

  int t = blockIdx.x;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  const int b = t / tiles_h;
  const int h0 = th * K::TH, w0 = tw * K::TW;
  // A tile whose planes lie inside the image needs no masks.
  const bool interior = h0 >= 2 && w0 >= 2 && h0 + K::TH + 2 <= H &&
                        w0 + K::TW + 2 <= W;

  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    mbar_init(skip_full, 1);
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // Producer: one thread issues every load, x first (the up-GEMM needs
    // it first), then skip, then the weight slices in the consumers' order.
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(x_full, K::NCX * K::SWX * K::MX);
      for (int k = 0; k < K::NCX; ++k)
        tma_load_4d(c1_pl + k * K::PLANE_X, &xmap, x_full, k * K::BKX,
                    w0 / 2 - 1, h0 / 2 - 1, b);
      mbar_expect_tx(skip_full, K::NCH * K::SW * K::IN_W * K::IN_H);
      for (int k = 0; k < K::NCH; ++k)
        tma_load_4d(skip_pl + k * K::PLANE_IN, &smap, skip_full, k * K::BKC,
                    w0 - 2, h0 - 2, b);
      for (int i = 0; i < K::SLICES; ++i) {
        const int s = i % K::STAGES;
        if (i >= K::STAGES)
          mbar_wait(empty + 8 * s, (i / K::STAGES - 1) & 1);
        const uint32_t slot = ring + s * K::SLOT, bar = full + 8 * s;
        if (i < K::UP_SLICES) {  // up_w rows of x chunk i / PIECES, piece i % PIECES
          mbar_expect_tx(bar, K::BKX * 128);
          tma_load_2d(slot, &umap, bar, i % K::PIECES * 64,
                      i / K::PIECES * K::BKX);
        } else {  // conv slice j: weight rows j * BKc.. (tap j / chunks)
          const bool conv1 = i < K::UP_SLICES + K::C1_SLICES;
          const int row =
              (i - K::UP_SLICES - (conv1 ? 0 : K::C1_SLICES)) * K::BKC;
          mbar_expect_tx(bar, K::MB * K::BOX);
          for (int mb = 0; mb < K::MB; ++mb)
            tma_load_2d(slot + mb * K::BOX, conv1 ? &w1map : &w2map, bar,
                        64 * mb, row);
        }
      }
    }
    return;
  }

  // Consumers: 256 threads, warpgroup g.
  const int tid = threadIdx.x;
  const int g = warp / 4;
#ifdef DEC1_PHASES
  if (tid % 128 == 0) {
    long long* rec = dec1_phase_buf + (blockIdx.x * 2ll + tid / 128) * 16;
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(rec[14]));
    rec[15] = sm;
  }
#endif
  PHASE(0)
  for (int i = tid; i < C; i += 128 * CONSUMERS)
    f_bu[i] = __bfloat162float(up_b[i]);
  for (int i = tid; i < K::NP; i += 128 * CONSUMERS) {
    f_b1[i] = i < C ? __bfloat162float(b1[i]) : 0.0f;
    f_b2[i] = i < C ? __bfloat162float(b2[i]) : 0.0f;
  }
  for (int i = tid; i < MAX_CLASSES * K::NP; i += 128 * CONSUMERS) {
    const int n = i / MAX_CLASSES, k = i % MAX_CLASSES;
    f_wh[i] = n < C && k < n_classes
                  ? __bfloat162float(wh[n * n_classes + k]) : 0.0f;
  }
  if (tid < MAX_CLASSES)
    f_bh[tid] = tid < n_classes ? __bfloat162float(bh[tid]) : 0.0f;
  bar_sync(1, 128 * CONSUMERS);
  PHASE(1)
  int ib = 0;  // weight slices consumed
  // -- up-GEMM: D[4C up columns][x pixels] = up_w^T . x; warpgroup g owns
  // the 64-column pieces g, g + 2, ... ------------------------------------
  {
    float acc[K::UPW][K::MX / 2];
    zero(acc);
    mbar_wait(x_full, 0);
    PHASE(2)
    for (int kc = 0; kc < K::NCX; ++kc) {
#pragma unroll
      for (int p = 0; p < K::PIECES; ++p, ++ib) {
        const uint32_t slot = acquire(ring, full, ib, K::STAGES, K::SLOT);
        if (p % CONSUMERS == g) {
          float (&a)[K::MX / 2] = acc[p / CONSUMERS];
          fence_regs(a);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < K::BKX / 16; ++k)
            wgmma<K::MX, 1, 0>(
                a, smem_desc(slot + 2048 * k, K::BKX * 128, 1024, 1),
                smem_desc(c1_pl + kc * K::PLANE_X + 32 * k, 16, 8 * K::SWX,
                          K::LAYOUT_X));
          wgmma_commit();
          wgmma_wait();
          fence_regs(a);
        }
        release(empty, ib, K::STAGES);
      }
    }
    PHASE(3)
    // Up column u is sub-pixel q = u / C = 2a + bb, channel o = u % C: x
    // pixel (xi, xj) lands at input pixel (2xi + a, 2xj + bb), 0 outside
    // the image.
#pragma unroll
    for (int pp = 0; pp < K::UPW; ++pp) {
      const int p = g + CONSUMERS * pp;
      if (p >= K::PIECES) continue;
      const auto pixel = [&](int xm, int u) {
        const int q = u / C;
        return (2 * (xm / K::X_W) + (q >> 1)) * K::IN_W +
               2 * (xm % K::X_W) + (q & 1);
      };
      const auto addr = [&](int xm, int u) {
        const int o = u % C;
        return swizzled(up_pl + o / K::BKC * K::PLANE_IN, pixel(xm, u),
                        o % K::BKC * 2, K::SW);
      };
      if (interior)
        store_block<K::MX>(
            acc[pp], 0, p * 64,
            [&](float v, int u, int) { return v + f_bu[u % C]; }, addr);
      else
        store_block<K::MX>(
            acc[pp], 0, p * 64,
            [&](float v, int u, int xm) {
              const int px = pixel(xm, u);
              const int r = h0 - 2 + px / K::IN_W, c = w0 - 2 + px % K::IN_W;
              return r >= 0 && r < H && c >= 0 && c < W ? v + f_bu[u % C]
                                                         : 0.0f;
            },
            addr);
    }
  }
  fence_proxy_async();
  bar_sync(1, 128 * CONSUMERS);  // the up plane is whole; x is dead
  PHASE(4)

  // -- conv1 over [skip, up] on the flat (TH + 2) x IN_W grid ------------
  {
    float acc[K::MB][K::N1 / 2];
    zero(acc);
    const int n0 = g * K::N1;
    mbar_wait(skip_full, 0);
    PHASE(5)
    for (int tap = 0; tap < 9; ++tap)
      for (int ch = 0; ch < 2 * K::NCH; ++ch, ++ib) {  // skip, then up
        const uint32_t slot = acquire(ring, full, ib, K::STAGES, K::SLOT);
        conv_slice<C, K::N1>(acc, slot,
                             skip_pl + ch * K::PLANE_IN +
                                 (n0 + tap / 3 * K::IN_W + tap % 3) * K::SW);
        release(empty, ib, K::STAGES);
      }
    PHASE(6)
    // c1 = round(relu(acc + b1)), zero outside the image; grid row q is
    // image pixel (h0 - 1 + q / IN_W, w0 - 1 + q % IN_W).
#pragma unroll
    for (int mb = 0; mb < K::MB; ++mb) {
      if (mb * 64 + 16 * (warp % 4) >= C) continue;  // padded channels
      const auto addr = [&](int q, int n) {
        return swizzled(c1_pl + n / K::BKC * K::PLANE_C1, q, n % K::BKC * 2,
                        K::SW);
      };
      // The wrap columns (q % IN_W >= TW + 2) feed only dropped outputs.
      if (interior)
        store_block<K::N1>(
            acc[mb], n0, mb * 64,
            [&](float v, int n, int) { return fmaxf(v + f_b1[n], 0.0f); },
            addr);
      else
        store_block<K::N1>(
            acc[mb], n0, mb * 64,
            [&](float v, int n, int q) {
              const int r = h0 - 1 + q / K::IN_W, c = w0 - 1 + q % K::IN_W;
              return r >= 0 && r < H && c >= 0 && c < W
                         ? fmaxf(v + f_b1[n], 0.0f) : 0.0f;
            },
            addr);
    }
  }
  fence_proxy_async();
  bar_sync(1, 128 * CONSUMERS);  // c1 is whole; skip is dead
  PHASE(7)

  // -- conv2 over c1 on the flat TH x IN_W grid; c2 over the skip plane --
  {
    float acc[K::MB][K::N2 / 2];
    zero(acc);
    const int n0 = g * K::N2;
    for (int tap = 0; tap < 9; ++tap)
      for (int ch = 0; ch < K::NCH; ++ch, ++ib) {
        const uint32_t slot = acquire(ring, full, ib, K::STAGES, K::SLOT);
        conv_slice<C, K::N2>(acc, slot,
                             c1_pl + ch * K::PLANE_C1 +
                                 (n0 + tap / 3 * K::IN_W + tap % 3) * K::SW);
        release(empty, ib, K::STAGES);
      }
#pragma unroll
    for (int mb = 0; mb < K::MB; ++mb) {
      if (mb * 64 + 16 * (warp % 4) >= C) continue;
      store_block<K::N2>(
          acc[mb], n0, mb * 64,
          [&](float v, int n, int) { return fmaxf(v + f_b2[n], 0.0f); },
          [&](int q, int n) {
            return swizzled(skip_pl + n / K::BKC * K::PLANE_IN, q,
                            n % K::BKC * 2, K::SW);
          });
    }
  }
  PHASE(8)
  bar_sync(1, 128 * CONSUMERS);  // c2 is whole

  // -- the f32 head and the first-max argmax -------------------------------
  if (n_classes <= 4)
    head<C, 4>(smem_raw, raw, skip_pl, f_wh, f_bh, out, b, h0, w0, H, W,
               n_classes);
  else
    head<C, MAX_CLASSES>(smem_raw, raw, skip_pl, f_wh, f_bh, out, b, h0, w0,
                         H, W, n_classes);
  PHASE(9)
}

template <int C>
int launch(const void* x, const void* skip, const void* up_w, const void* up_b,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* wh, const void* bh, void* out, int B, int H, int W,
           int n_classes, int th, int tw, int stages, cudaStream_t stream) {
  using K = Cfg<C>;
  if (th != K::TH || tw != K::TW || stages != K::STAGES) return ERR_PLAN;
  if (!encoder()) return ERR_ENCODER;
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  CUtensorMap xmap, smap, umap, w1map, w2map;
  const u64 xdim[4] = {2 * C, static_cast<u64>(W / 2), static_cast<u64>(H / 2),
                       static_cast<u64>(B)};
  const u32 xbox[4] = {K::BKX, K::X_W, K::X_H, 1};
  const u64 sdim[4] = {C, static_cast<u64>(W), static_cast<u64>(H),
                       static_cast<u64>(B)};
  const u32 sbox[4] = {K::BKC, K::IN_W, K::IN_H, 1};
  const u64 udim[2] = {4 * C, 2 * C}, w1dim[2] = {C, 18 * C},
            w2dim[2] = {C, 9 * C};
  const u32 ubox[2] = {64, K::BKX}, wbox[2] = {64, K::BKC};
  if (!encode_map(&xmap, x, 4, xdim, xbox, K::SWX) ||
      !encode_map(&smap, skip, 4, sdim, sbox, K::SW) ||
      !encode_map(&umap, up_w, 2, udim, ubox, 128) ||
      !encode_map(&w1map, w1, 2, w1dim, wbox, 128) ||
      !encode_map(&w2map, w2, 2, w2dim, wbox, 128))
    return ERR_MAP;
  const cudaError_t e = cudaFuncSetAttribute(
      dec1_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W + K::TW - 1) / K::TW;
  const int tiles_h = (H + K::TH - 1) / K::TH;
  const long long grid = static_cast<long long>(B) * tiles_h * tiles_w;
  if (grid > 0x7fffffffLL) return ERR_PLAN;
  using bf = __nv_bfloat16;
  dec1_wgmma_kernel<C><<<static_cast<unsigned>(grid), THREADS, K::SMEM,
                         stream>>>(
      xmap, smap, umap, w1map, w2map, static_cast<const bf*>(up_b),
      static_cast<const bf*>(b1), static_cast<const bf*>(b2),
      static_cast<const bf*>(wh), static_cast<const bf*>(bh),
      static_cast<uint8_t*>(out), H, W, n_classes, tiles_w, tiles_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B, H/2, W/2, 2C);
// skip: (B, H, W, C); up_w: (2C, 4C) laid out (c, a, b, o); up_b: (C,);
// w1: (3, 3, 2C, C); b1: (C,); w2: (3, 3, C, C); b2: (C,); wh: (C, K);
// bh: (K,); out: (B, H, W) uint8.  All bf16 but out, contiguous, 16-byte
// aligned; C in {16, 32, ..., 96}, H and W even, 1 <= K <= 8 (checked by
// the Python wrapper).  (th, tw, stages) is the tile plan of
// ops/dec1.py::tile_plan.  Launches on `stream` and returns
// cudaGetLastError(), or a negative code: -1 a plan the kernel does not
// take, -2 no tensor-map encoder in the driver, -3 a tensor map refused.
extern "C" int utdec1_fused_bf16(const void* x, const void* skip,
                                 const void* up_w, const void* up_b,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* wh, const void* bh, void* out,
                                 int B, int H, int W, int C, int n_classes,
                                 int th, int tw, int stages, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define UT_DEC1_CASE(CC)                                                    \
  case CC:                                                                  \
    return launch<CC>(x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh, out, B, \
                      H, W, n_classes, th, tw, stages, s);
    UT_DEC1_CASE(16)
    UT_DEC1_CASE(32)
    UT_DEC1_CASE(48)
    UT_DEC1_CASE(64)
    UT_DEC1_CASE(80)
    UT_DEC1_CASE(96)
#undef UT_DEC1_CASE
    default:
      return ERR_PLAN;
  }
}

#ifdef DEC1_PHASES
// Where the phase stamps go: int64 (blocks, 2, 16) on the card.
extern "C" int utdec1_set_phase_buffer(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(dec1_phase_buf, &p, sizeof p));
}
#endif

// Dynamic shared memory of the plan (C, th, tw, stages), in bytes, or -1
// for a C the kernel is not built for.
extern "C" int utdec1_smem_bytes(int C, int th, int tw, int stages) {
  return tile(C, 1) ? geometry(C, th, tw, stages).smem : ERR_PLAN;
}
