// 3x3 stride-1 SAME convolution + bias (+ ReLU) on NHWC bf16, for Hopper.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * unetseg_tpu/ops/pallas_conv.py::conv3x3_bias_act  (kernel _kernel,
//     pallas_call at :189) for C >= 128, and
//   * unetseg_tpu/ops/pallas_conv.py::_conv3x3_small_c  (kernel
//     _kernel_small_c, pallas_call at :123) for C < 128.
// Both become one implicit-GEMM kernel, instantiated with a K tile of 64
// (C >= 128) or 32 (C < 128).
//
// Numerics follow the Pallas kernel (pallas_conv.py:72-77): products in
// bf16, sums in f32 over all 9 taps x C, then bias in f32, optional ReLU and
// one rounding to bf16.
//
// GEMM view: M = B*H*W output pixels, N = D output channels, K = 9*C with
// k = (dy*3 + dx)*C + c, so the HWIO weight tensor, contiguous, is the
// (K, N) row-major B operand as it is.  A is never materialised: each
// 16-byte chunk of an A tile is 8 consecutive channels of one input pixel,
// loaded with cp.async and zero-filled where the tap falls outside the image
// (the SAME padding) or past K, so there is no separate pad pass.
//
// What bounds it: slim4 at batch 128 does 1.585 TFLOP in its ten convs,
// about 1.6 ms at the H100's 989 TFLOP/s bf16 peak; a layer such as
// (128,128,128,128) -> 64 is 0.31 ms of tensor-core work against 0.24 ms of
// HBM traffic at 3.35 TB/s, so the layers sit near the ridge and the kernel
// is bound by how well it feeds the tensor cores.  This first version keeps
// it simple: 64x64 output tiles per block of 4 warps, each warp a 32x32
// quarter in WMMA bf16 16x16x16 fragments (mma.sync underneath), and a
// two-stage cp.async ring so the next K tile loads while this one
// multiplies.  wgmma, TMA and deeper pipelines are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int THREADS = 128;  // 4 warps, 2 x 2 over the 64x64 tile
constexpr int PAD = 8;        // bf16 row padding of the shared tiles
constexpr int CPAD = 4;       // f32 row padding of the epilogue tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: write 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BK>
struct Tiles {
  __nv_bfloat16 a[2][BM][BK + PAD];
  __nv_bfloat16 b[2][BK][BN + PAD];
};

template <int BK>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const __nv_bfloat16* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
               int D, int relu) {
  constexpr int TILE_BYTES = sizeof(Tiles<BK>);
  constexpr int EPI_BYTES = BM * (BN + CPAD) * sizeof(float);
  constexpr int SMEM_BYTES = TILE_BYTES > EPI_BYTES ? TILE_BYTES : EPI_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  Tiles<BK>& t = *reinterpret_cast<Tiles<BK>*>(smem);
  float* ctile = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;

  // A loader: each thread owns one 8-channel column chunk of A_PASSES rows.
  constexpr int A_CPR = BK / 8;
  constexpr int A_RPP = THREADS / A_CPR;
  constexpr int A_PASSES = BM / A_RPP;
  const int a_col = (tid % A_CPR) * 8;
  const int a_row = tid / A_CPR;
  int a_b[A_PASSES], a_h[A_PASSES], a_w[A_PASSES];
  bool a_ok[A_PASSES];
#pragma unroll
  for (int p = 0; p < A_PASSES; ++p) {
    const long long m = m0 + a_row + p * A_RPP;
    a_ok[p] = m < M;
    const long long mm = a_ok[p] ? m : 0;
    a_w[p] = static_cast<int>(mm % W);
    const long long bh = mm / W;
    a_h[p] = static_cast<int>(bh % H);
    a_b[p] = static_cast<int>(bh / H);
  }

  // B loader: 8 chunks of 8 channels per K row, 16 rows per pass.
  constexpr int B_CPR = BN / 8;
  constexpr int B_RPP = THREADS / B_CPR;
  constexpr int B_PASSES = BK / B_RPP;
  const int b_col = (tid % B_CPR) * 8;
  const int b_row = tid / B_CPR;
  const bool b_col_ok = n0 + b_col < D;

  auto load_tile = [&](int stage, int k0) {
    const int k = k0 + a_col;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / C : 0;
    const int c = k - tap * C;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int p = 0; p < A_PASSES; ++p) {
      const int hs = a_h[p] + dy;
      const int ws = a_w[p] + dx;
      const bool ok = a_ok[p] && k_ok && hs >= 0 && hs < H && ws >= 0 && ws < W;
      const __nv_bfloat16* src =
          ok ? x + (((static_cast<long long>(a_b[p]) * H + hs) * W + ws) * C + c)
             : x;
      cp_async16(&t.a[stage][a_row + p * A_RPP][a_col], src, ok);
    }
#pragma unroll
    for (int p = 0; p < B_PASSES; ++p) {
      const int kr = k0 + b_row + p * B_RPP;
      const bool ok = kr < K && b_col_ok;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<long long>(kr) * D + n0 + b_col) : w;
      cp_async16(&t.b[stage][b_row + p * B_RPP][b_col], src, ok);
    }
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_tiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt & 1;
    // Stage s^1 was last read in iteration kt-1, which ended in a barrier.
    if (kt + 1 < n_tiles) load_tile(s ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile kt have landed
    __syncthreads();     // ... and every other thread's
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &t.a[s][wm + 16 * i][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &t.b[s][kk][wn + 16 * j], BN + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // tile kt is consumed; its stage may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: accumulators -> shared f32 tile -> bias, ReLU, one bf16
  // rounding, 16-byte stores of 8 channels.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ctile + (wm + 16 * i) * (BN + CPAD) + wn + 16 * j,
                              acc[i][j], BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  for (int q = tid; q < BM * BN / 8; q += THREADS) {
    const int r = q / (BN / 8);
    const int cc = (q % (BN / 8)) * 8;
    const long long m = m0 + r;
    const int n = n0 + cc;
    if (m >= M || n >= D) continue;
    alignas(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float f = ctile[r * (BN + CPAD) + cc + e] + __bfloat162float(bias[n + e]);
      if (relu) f = f > 0.0f ? f : 0.0f;
      v[e] = __float2bfloat16(f);
    }
    *reinterpret_cast<uint4*>(out + m * D + n) =
        *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B,H,W,C), w: (3,3,C,D),
// bias: (D,), out: (B,H,W,D), all bf16, contiguous, 16-byte aligned, with C
// and D multiples of 16 (checked by the Python wrapper).  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int utconv3x3_bf16(const void* x, const void* w, const void* bias,
                              void* out, int B, int H, int W, int C, int D,
                              int relu, int small_c, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((D + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const __nv_bfloat16*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (small_c)
    conv3x3_kernel<32><<<grid, THREADS, 0, s>>>(xp, wp, bp, op, B, H, W, C, D,
                                                relu);
  else
    conv3x3_kernel<64><<<grid, THREADS, 0, s>>>(xp, wp, bp, op, B, H, W, C, D,
                                                relu);
  return static_cast<int>(cudaGetLastError());
}
