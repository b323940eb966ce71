// The last decoder level of a stem-1 UNet, its 1x1 head and the argmax, in
// one kernel, on NHWC bf16, for Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package
//   benchmarks/exp_dec1_ablate.py::make  (kernel :47-146, pallas_call :150),
// the fused decoder level 1: 2x2 up-GEMM, [skip, up], conv3x3+ReLU twice,
// 1x1 head and a first-max argmax.  The TPU kernel folds two pixels into
// each 128-lane row and pads its inputs in HBM; this one keeps the port's
// NHWC layouts as they are and does the SAME padding itself.
//
// Function, per image (C = output channels of the level, x has 2C):
//   up = round(x . Wu + bu)                 2x2 stride-2 transposed conv
//   c1 = round(relu(conv3x3([skip, up]) + b1))
//   c2 = round(relu(conv3x3(c1) + b2))
//   class = first argmax over k of (c2 . Wh + bh)[k]  (f32 logits)
// with products in bf16, sums in f32, and round = to bf16 (K6's rounding
// points, exp_dec1_ablate.py:59-69,101-111,138-146, plus the biases).
//
// Design: one block of 8 warps per TH x TW = 8 x 16 output tile.  The
// conv1 input, 12 x 20 pixels x 2C channels ([skip, up] with a two-pixel
// halo), lives in shared memory: skip arrives by cp.async (zero-filled
// outside the image), up is computed in place from the 6 x 10 x tile by a
// GEMM.  conv1 runs on the 10 x 18 halo of the tile into a second shared
// tile (zero outside the image: conv2's padding), conv2 on the 8 x 16
// tile, and its result goes through the head and the argmax in registers;
// only one byte per pixel is written.  Weights stream through a ring of
// two shared slabs, each (<= 2C) x C: the up-GEMM's four sub-pixel column
// blocks, then conv1's 9 taps, then conv2's 9, so the next slab loads
// while this one multiplies.  All products are mma.sync m16n8k16 bf16 with
// f32 accumulators; ldmatrix takes one row address per lane, which gathers
// each tap's im2col rows straight out of the pixel tiles.
//
// What bounds it: at B=32, 512^2, C=64 the level is 1.996 TFLOP (conv1
// 1.237, conv2 0.618, up 0.137, head 0.003), 2.02 ms at 989 TFLOP/s,
// against 1.6 GB of input (0.48 ms at 3.35 TB/s): operations.  The halo
// recompute costs conv1 180/128 = 1.41x its work and the up-GEMM
// 240/128 = 1.88x; wgmma, TMA and larger tiles are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;            // output rows per block
constexpr int TW = 16;           // output columns per block
constexpr int THREADS = 256;     // 8 warps
constexpr int IN_H = TH + 4;     // conv1 input tile: 2-pixel halo
constexpr int IN_W = TW + 4;
constexpr int C1_H = TH + 2;     // conv1 output tile: 1-pixel halo
constexpr int C1_W = TW + 2;
constexpr int X_H = IN_H / 2;    // x pixels under the input tile
constexpr int X_W = IN_W / 2;
constexpr int IN_PX = IN_H * IN_W;   // 240
constexpr int C1_PX = C1_H * C1_W;   // 180
constexpr int X_PX = X_H * X_W;      // 60
constexpr int MAX_CLASSES = 8;
constexpr int PAD = 8;               // bf16 row padding: ldmatrix rows hit
                                     // distinct banks

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // src-size 0: write 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[t] += A(16 rows, gathered: row r at a_row[r]) x B(K x 8t..8t+7) over
// K = ksteps * 16.  `a_lane` is this lane's ldmatrix row pointer into the
// A tile (its row and k-half chosen by the caller), `b` the weight slab
// (row stride ldb) at this warp's first column.
template <int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const __nv_bfloat16* a_lane,
                                         const __nv_bfloat16* b, int ldb,
                                         int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    unsigned a[4];
    ldmatrix_x4(a, a_lane + ks * 16);
    const __nv_bfloat16* b_lane = b + (ks * 16 + (lane & 15)) * ldb;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      unsigned bf[2];
      ldmatrix_x2_trans(bf, b_lane + t * 8);
      mma_bf16(acc[t], a, bf);
    }
  }
}

template <int C>
struct Smem {
  static constexpr int LDI = 2 * C + PAD;  // input tile / x tile row stride
  static constexpr int LDC = C + PAD;      // c1 tile / weight slab stride
  static constexpr int IN = IN_PX * LDI;
  static constexpr int C1 = (C1_PX * LDC > X_PX * LDI) ? C1_PX * LDC
                                                       : X_PX * LDI;
  static constexpr int SLAB = 2 * C * LDC;
  static constexpr int BF16_ELEMS = IN + C1 + 2 * SLAB;
  static constexpr int F32_ELEMS = 3 * C + C * MAX_CLASSES + MAX_CLASSES;
  static constexpr int BYTES = BF16_ELEMS * 2 + F32_ELEMS * 4;
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
dec1_fused_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ skip,
                  const __nv_bfloat16* __restrict__ up_w,
                  const __nv_bfloat16* __restrict__ up_b,
                  const __nv_bfloat16* __restrict__ w1,
                  const __nv_bfloat16* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2,
                  const __nv_bfloat16* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ wh,
                  const __nv_bfloat16* __restrict__ bh,
                  uint8_t* __restrict__ out, int H, int W, int n_classes) {
  using S = Smem<C>;
  constexpr int LDI = S::LDI;
  constexpr int LDC = S::LDC;
  constexpr int NH = C / 16;  // n8 tiles per warp in the up-GEMM and conv1
  constexpr int NF = C / 8;   // n8 tiles per warp in conv2 (all of N)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* in_t = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* c1_t = in_t + S::IN;   // also the x tile, before conv1
  __nv_bfloat16* x_t = c1_t;
  __nv_bfloat16* slab0 = c1_t + S::C1;
  float* f_bu = reinterpret_cast<float*>(slab0 + 2 * S::SLAB);
  float* f_b1 = f_bu + C;
  float* f_b2 = f_b1 + C;
  float* f_wh = f_b2 + C;               // (C, MAX_CLASSES)
  float* f_bh = f_wh + C * MAX_CLASSES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;     // mma row group
  const int tq = lane & 3;     // thread in group
  const int c0 = blockIdx.x * TW;
  const int r0 = blockIdx.y * TH;
  const long long b = blockIdx.z;
  const int Hx = H / 2, Wx = W / 2;

  // -- small operands, as f32 --------------------------------------------
  for (int i = tid; i < C; i += THREADS) {
    f_bu[i] = __bfloat162float(up_b[i]);
    f_b1[i] = __bfloat162float(b1[i]);
    f_b2[i] = __bfloat162float(b2[i]);
  }
  for (int i = tid; i < C * MAX_CLASSES; i += THREADS) {
    const int n = i / MAX_CLASSES, k = i % MAX_CLASSES;
    f_wh[i] = k < n_classes ? __bfloat162float(wh[n * n_classes + k]) : 0.f;
  }
  if (tid < MAX_CLASSES)
    f_bh[tid] = tid < n_classes ? __bfloat162float(bh[tid]) : 0.f;

  // -- weight slabs: 22 steps, each (rows x C) into ring slot step & 1 ----
  // 0-3: up_w columns q*C..q*C+C-1 (sub-pixel (q/2, q%2)), 2C rows;
  // 4-12: w1 tap t, 2C rows; 13-21: w2 tap t, C rows.
  constexpr int N_STEPS = 4 + 9 + 9;
  auto load_slab = [&](int step) {
    __nv_bfloat16* dst = slab0 + (step & 1) * S::SLAB;
    const __nv_bfloat16* src;
    int rows, ld;
    if (step < 4) {
      src = up_w + step * C; rows = 2 * C; ld = 4 * C;
    } else if (step < 13) {
      src = w1 + static_cast<long long>(step - 4) * 2 * C * C;
      rows = 2 * C; ld = C;
    } else {
      src = w2 + static_cast<long long>(step - 13) * C * C;
      rows = C; ld = C;
    }
    constexpr int CPR = C / 8;  // 16-byte chunks per row
    for (int q = tid; q < rows * CPR; q += THREADS) {
      const int r = q / CPR, cc = (q % CPR) * 8;
      cp_async16(dst + r * LDC + cc, src + static_cast<long long>(r) * ld + cc,
                 true);
    }
  };

  // -- pixel tiles: x (6 x 10 x 2C) and skip (12 x 20 x C) ---------------
  {
    constexpr int CPX = 2 * C / 8;
    for (int q = tid; q < X_PX * CPX; q += THREADS) {
      const int p = q / CPX, cc = (q % CPX) * 8;
      const int xr = r0 / 2 - 1 + p / X_W, xc = c0 / 2 - 1 + p % X_W;
      const bool ok = xr >= 0 && xr < Hx && xc >= 0 && xc < Wx;
      const __nv_bfloat16* src =
          ok ? x + (((b * Hx + xr) * Wx + xc) * (2 * C) + cc) : x;
      cp_async16(x_t + p * LDI + cc, src, ok);
    }
    constexpr int CPS = C / 8;
    for (int q = tid; q < IN_PX * CPS; q += THREADS) {
      const int p = q / CPS, cc = (q % CPS) * 8;
      const int r = r0 - 2 + p / IN_W, c = c0 - 2 + p % IN_W;
      const bool ok = r >= 0 && r < H && c >= 0 && c < W;
      const __nv_bfloat16* src =
          ok ? skip + (((b * H + r) * W + c) * C + cc) : skip;
      cp_async16(in_t + p * LDI + cc, src, ok);
    }
  }
  load_slab(0);
  cp_async_commit();
  load_slab(1);
  cp_async_commit();

  // ldmatrix A row of this lane within a 16-row m-tile, and its k offset.
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 8;
  const int nh = warp >> 2;  // which half of N this warp owns (up, conv1)
  const int mq = warp & 3;   // its m-tile residue (up, conv1)

  float acc1[3][NH][4];
  float acc2[NF][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int t = 0; t < NH; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][t][e] = 0.f;
#pragma unroll
  for (int t = 0; t < NF; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[t][e] = 0.f;

  for (int step = 0; step < N_STEPS; ++step) {
    cp_async_wait1();  // this thread's copies up to slab `step` landed
    __syncthreads();   // ... and everyone's; earlier epilogues are visible
    const __nv_bfloat16* slab = slab0 + (step & 1) * S::SLAB;

    if (step < 4) {
      // Up-GEMM, sub-pixel (a, bb): M = 60 x pixels (4 m-tiles), N = C.
      const int a = step >> 1, bb = step & 1;
      float acc[NH][4];
#pragma unroll
      for (int t = 0; t < NH; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      const int m = mq * 16 + a_r;
      const __nv_bfloat16* a_lane = x_t + (m < X_PX ? m : 0) * LDI + a_k;
      mma_rows<NH>(acc, a_lane, slab + nh * NH * 8, LDC, 2 * C / 16, lane);
#pragma unroll
      for (int t = 0; t < NH; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mm = mq * 16 + g + h * 8;
          if (mm >= X_PX) continue;
          const int ui = 2 * (mm / X_W) + a, uj = 2 * (mm % X_W) + bb;
          const int r = r0 - 2 + ui, c = c0 - 2 + uj;
          const bool in_img = r >= 0 && r < H && c >= 0 && c < W;
          const int n = nh * NH * 8 + t * 8 + tq * 2;
          const float v0 = in_img ? acc[t][2 * h] + f_bu[n] : 0.f;
          const float v1 = in_img ? acc[t][2 * h + 1] + f_bu[n + 1] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(
              in_t + (ui * IN_W + uj) * LDI + C + n) =
              __floats2bfloat162_rn(v0, v1);
        }
    } else if (step < 13) {
      // conv1 tap (dy, dx): M = 180 halo pixels (12 m-tiles, 3 per warp).
      const int tap = step - 4, dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int m = (mq + 4 * i) * 16 + a_r;
        const int mc = m < C1_PX ? m : 0;
        const int p = (mc / C1_W + dy) * IN_W + mc % C1_W + dx;
        mma_rows<NH>(acc1[i], in_t + p * LDI + a_k, slab + nh * NH * 8, LDC,
                     2 * C / 16, lane);
      }
      if (step == 12) {
        // c1 = round(relu(acc + b1)), zero outside the image.  The c1 tile
        // overlays the x tile, which no warp has read since step 3.
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int t = 0; t < NH; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int mm = (mq + 4 * i) * 16 + g + h * 8;
              if (mm >= C1_PX) continue;
              const int r = r0 - 1 + mm / C1_W, c = c0 - 1 + mm % C1_W;
              const bool in_img = r >= 0 && r < H && c >= 0 && c < W;
              const int n = nh * NH * 8 + t * 8 + tq * 2;
              const float v0 = in_img ? fmaxf(acc1[i][t][2 * h] + f_b1[n], 0.f)
                                      : 0.f;
              const float v1 =
                  in_img ? fmaxf(acc1[i][t][2 * h + 1] + f_b1[n + 1], 0.f)
                         : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(c1_t + mm * LDC + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
      }
    } else {
      // conv2 tap (dy, dx): warp w owns output row w (one m-tile), all N.
      const int tap = step - 13, dy = tap / 3, dx = tap % 3;
      const int p = (warp + dy) * C1_W + a_r + dx;
      mma_rows<NF>(acc2, c1_t + p * LDC + a_k, slab, LDC, C / 16, lane);
    }

    __syncthreads();  // slot step & 1 is consumed; refill it
    if (step + 2 < N_STEPS) load_slab(step + 2);
    cp_async_commit();
  }

  // -- conv2 epilogue, head, argmax ----------------------------------------
  // This thread holds output pixels (row warp, columns g and g + 8), each
  // at the 2 * NF channels n = t * 8 + tq * 2 + {0, 1}.
  float part[2][MAX_CLASSES];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < MAX_CLASSES; ++k) part[h][k] = 0.f;
#pragma unroll
  for (int t = 0; t < NF; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = t * 8 + tq * 2 + e;
        const float v = __bfloat162float(
            __float2bfloat16(fmaxf(acc2[t][2 * h + e] + f_b2[n], 0.f)));
#pragma unroll
        for (int k = 0; k < MAX_CLASSES; ++k)
          part[h][k] = fmaf(v, f_wh[n * MAX_CLASSES + k], part[h][k]);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < MAX_CLASSES; ++k) {
      part[h][k] += __shfl_xor_sync(0xffffffffu, part[h][k], 1);
      part[h][k] += __shfl_xor_sync(0xffffffffu, part[h][k], 2);
    }
  if (tq == 0) {
    const int r = r0 + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + g + h * 8;
      if (r >= H || c >= W) continue;
      int best = 0;
      float bv = part[h][0] + f_bh[0];
      for (int k = 1; k < n_classes; ++k) {
        const float v = part[h][k] + f_bh[k];
        if (v > bv) {  // strict: ties go to the lower class
          bv = v;
          best = k;
        }
      }
      out[(b * H + r) * W + c] = static_cast<uint8_t>(best);
    }
  }
}

template <int C>
int launch(const void* x, const void* skip, const void* up_w, const void* up_b,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* wh, const void* bh, void* out, int B, int H, int W,
           int n_classes, cudaStream_t s) {
  const int bytes = Smem<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      dec1_fused_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  using bf = __nv_bfloat16;
  dec1_fused_kernel<C><<<grid, THREADS, bytes, s>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(skip),
      static_cast<const bf*>(up_w), static_cast<const bf*>(up_b),
      static_cast<const bf*>(w1), static_cast<const bf*>(b1),
      static_cast<const bf*>(w2), static_cast<const bf*>(b2),
      static_cast<const bf*>(wh), static_cast<const bf*>(bh),
      static_cast<uint8_t*>(out), H, W, n_classes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B, H/2, W/2, 2C);
// skip: (B, H, W, C); up_w: (2C, 4C) laid out (c, a, b, o); up_b: (C,);
// w1: (3, 3, 2C, C); b1: (C,); w2: (3, 3, C, C); b2: (C,); wh: (C, K);
// bh: (K,); out: (B, H, W) uint8.  All bf16 but out, contiguous, 16-byte
// aligned; C in {16, 32, ..., 96}, H and W even, 1 <= K <= 8 (checked by
// the Python wrapper).  Launches on `stream`; returns a CUDA error code.
extern "C" int utdec1_fused_bf16(const void* x, const void* skip,
                                 const void* up_w, const void* up_b,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* wh, const void* bh, void* out,
                                 int B, int H, int W, int C, int n_classes,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
#define UT_DEC1_CASE(CC)                                                     \
  case CC:                                                                   \
    return launch<CC>(x, skip, up_w, up_b, w1, b1, w2, b2, wh, bh, out, B, H, \
                      W, n_classes, s);
    UT_DEC1_CASE(16)
    UT_DEC1_CASE(32)
    UT_DEC1_CASE(48)
    UT_DEC1_CASE(64)
    UT_DEC1_CASE(80)
    UT_DEC1_CASE(96)
#undef UT_DEC1_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
